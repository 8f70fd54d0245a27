"""K2's train form (dropout bits, real BatchNorm affine) and K3 (the
backward) through the port's autograd Function, which runs their plain
versions on CPU tensors, against the JAX fused stem epilogue in interpret
mode: the same numpy-seeded h, inv, c, w, b and the same uint8 bits on
both sides. Gates are those of tests/test_stem_epilogue.py: forward 1e-5,
the five gradients 2e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsed_tpu.ops.stem_epilogue import make_fused_epilogue as j_make

from bsed_tpu_torch.ops import stem_epilogue as se
from bsed_tpu_torch.ops.folded_stem import _freq_pool_matrix

B, T, G, L, L2 = 2, 21, 16, 128, 64


def _inputs(seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, T, G, L)).astype(np.float32)
    inv = rng.uniform(0.5, 1.5, L).astype(np.float32)
    c = (rng.standard_normal(L) * 0.3).astype(np.float32)
    w = (rng.standard_normal((L, L)) / np.sqrt(L)).astype(np.float32)
    b = (rng.standard_normal(L) * 0.1).astype(np.float32)
    bits = rng.integers(0, 256, (B, T * G, L), dtype=np.uint8)
    return h, inv, c, w, b, bits


def _port(act, pt, rate, pool_w, h, inv, c, w, b, bits, cot):
    """Port forward and (with ``cot``) the five gradients on CPU."""
    ep = se.make_fused_epilogue(act, pt, torch.from_numpy(pool_w),
                                rate=rate)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (h, inv, c, w, b)]
    tb = torch.from_numpy(bits) if rate > 0 else None
    before = (se.stem_epilogue_fwd.launches, se.stem_epilogue_bwd.launches)
    out = ep(*leaves, tb)
    grads = (torch.autograd.grad(out, leaves, torch.from_numpy(cot))
             if cot is not None else ())
    # CPU tensors run the plain versions: no kernel launch
    assert (se.stem_epilogue_fwd.launches,
            se.stem_epilogue_bwd.launches) == before
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax(act, pt, rate, pool_w, h, inv, c, w, b, bits, cot):
    ep = j_make(act, pt, rate, pool_w, tile_target=8)
    jb = jnp.asarray(bits) if rate > 0 else None
    out = np.asarray(ep(h, inv, c, w, b, jb))
    if cot is None:
        return out, []
    grads = jax.grad(lambda *a: jnp.sum(ep(*a, jb) * cot),
                     argnums=(0, 1, 2, 3, 4))(h, inv, c, w, b)
    return out, [np.asarray(g) for g in grads]


@pytest.mark.parametrize("act", ["glu", "cg"])
@pytest.mark.parametrize("pt", [1, 2])
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_fwd_and_grads_match_jax_kernel(act, pt, rate):
    h, inv, c, w, b, bits = _inputs(0)
    pool_w = _freq_pool_matrix(8, 2, 16)          # block 0's fold layout
    cot = np.random.default_rng(9).standard_normal(
        (B, T // pt, G, L2)).astype(np.float32)
    got, g_got = _port(act, pt, rate, pool_w, h, inv, c, w, b, bits, cot)
    want, g_want = _jax(act, pt, rate, pool_w, h, inv, c, w, b, bits, cot)
    assert got.shape == want.shape == (B, T // pt, G, L2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for name, a, e in zip("h inv c w b".split(), g_got, g_want):
        np.testing.assert_allclose(
            a, e, rtol=2e-4, atol=2e-4,
            err_msg=f"grad {name} (act={act}, pt={pt}, rate={rate})")


def test_dropout_mask_and_scale():
    """keep = bits < 128 with ×2 on the kept values: all-kept bits equal
    twice the no-dropout output, all-dropped bits give zeros, forward and
    backward; mixed bits match JAX (above)."""
    h, inv, c, w, b, _ = _inputs(2)
    pool_w = _freq_pool_matrix(2, 2, 64)
    cot = np.ones((B, T // 2, G, L2), np.float32)
    keep = np.full((B, T * G, L), 127, np.uint8)
    drop = np.full((B, T * G, L), 128, np.uint8)
    plain, g_plain = _port("glu", 2, 0.0, pool_w, h, inv, c, w, b, keep,
                           cot)
    kept, g_kept = _port("glu", 2, 0.5, pool_w, h, inv, c, w, b, keep, cot)
    dropped, g_drop = _port("glu", 2, 0.5, pool_w, h, inv, c, w, b, drop,
                            cot)
    np.testing.assert_allclose(kept, 2 * plain, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g_kept[0], 2 * g_plain[0], rtol=1e-5,
                               atol=1e-6)
    assert not dropped.any() and not g_drop[0].any()
    with pytest.raises(ValueError, match="bits are required"):
        se.make_fused_epilogue("glu", 2, torch.from_numpy(pool_w),
                               rate=0.5)(*map(torch.from_numpy,
                                              (h, inv, c, w, b)))
    with pytest.raises(ValueError, match="k/256"):
        se.make_fused_epilogue("glu", 2, torch.from_numpy(pool_w), rate=0.3)


@pytest.mark.parametrize("t_in", [21, 23])
def test_odd_time_rows_get_zero_gradient(t_in):
    """With pt=2 the odd last row is dropped by the pool: its dh is exactly
    0 and every gradient is finite, as in JAX with a half-padded last tile
    (tile_target=8)."""
    rng = np.random.default_rng(4)
    h = rng.standard_normal((B, t_in, G, L)).astype(np.float32)
    _, inv, c, w, b, _ = _inputs(4)
    bits = rng.integers(0, 256, (B, t_in * G, L), dtype=np.uint8)
    pool_w = _freq_pool_matrix(4, 2, 32)
    cot = np.ones((B, t_in // 2, G, L2), np.float32)
    _, g_got = _port("glu", 2, 0.5, pool_w, h, inv, c, w, b, bits, cot)
    _, g_want = _jax("glu", 2, 0.5, pool_w, h, inv, c, w, b, bits, cot)
    assert np.abs(g_got[0][:, -1]).max() == 0.0
    assert all(np.isfinite(g).all() for g in g_got)
    for name, a, e in zip("h inv c w b".split(), g_got, g_want):
        np.testing.assert_allclose(a, e, rtol=2e-4, atol=2e-4,
                                   err_msg=f"grad {name}")


def test_bwd_plain_is_the_chain_gradient():
    """K3's plain version equals autograd of the plain chain with dW in
    float32, and the Function's CPU backward returns it."""
    h, inv, c, w, b, bits = _inputs(5)
    pool_w = torch.from_numpy(_freq_pool_matrix(2, 2, 64))
    t = [torch.from_numpy(a) for a in (h, inv, c, w, b)]
    tb = torch.from_numpy(bits)
    gz = torch.randn((B, T // 2, G, L2),
                     generator=torch.Generator().manual_seed(1))
    got = se.stem_epilogue_bwd(gz, *t, "cg", 2, pool_w, 64, tb, 128)
    leaves = [x.clone().requires_grad_(True) for x in t]
    want = torch.autograd.grad(se.stem_epilogue_plain(
        *leaves, "cg", 2, pool_w, tb, 128), leaves, gz)
    assert got[3].dtype == torch.float32
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=0, atol=0)


@pytest.mark.parametrize("rows", [64, 10_000])
@pytest.mark.parametrize("offset", [0.0, 3.0])
def test_split_product_holds_float32_grade_operands(rows, offset):
    """K3's dW on the tensor cores, inv·(hᵀ·dlin) + c·dbᵀ with h exact in
    bf16 and dlin split into bf16 hi and lo parts (two passes, float32
    sums), against the float64 yᵀ·dlin for y = h·inv + c at a panel-sized
    and a 10⁴-row input, with and without a common offset in c. Every
    element is within the budget the source states, 2⁻¹⁵·(|h·inv|ᵀ·|dlin|
    + |c|·Σ|dlin|), and the split is at least 100 times closer than one
    pass on bf16-rounded y and dlin."""
    rng = np.random.default_rng(rows)
    h = torch.from_numpy(rng.standard_normal((rows, L)).astype(
        np.float32)).bfloat16()
    inv = torch.from_numpy(rng.uniform(0.5, 1.5, L).astype(np.float32))
    c = torch.from_numpy((rng.standard_normal(L) * 0.3 + offset).astype(
        np.float32))
    dlin = torch.from_numpy(rng.standard_normal((rows, L)).astype(np.float32))
    y = h.double() * inv.double() + c.double()
    exact = y.T @ dlin.double()
    budget = se.SPLIT_PRODUCT_RTOL * (
        (h.double() * inv.double()).abs().T @ dlin.double().abs()
        + c.double().abs()[:, None] * dlin.double().abs().sum(0)[None, :])
    got = se.split_product(h, inv, c, dlin)
    assert got.dtype == torch.float32 and got.shape == (L, L)
    err = (got.double() - exact).abs()
    assert bool((err <= budget).all()), float((err / budget).max())
    one_pass = (y.float().bfloat16().float().T
                @ dlin.bfloat16().float()).double()
    assert float(err.max()) * 100 < float((one_pass - exact).abs().max())
    with pytest.raises(ValueError, match="bfloat16"):
        se.split_product(h.float(), inv, c, dlin)


def test_split_parts_rebuild_the_operand():
    """hi + lo is within 2⁻¹⁶·|x| of x (two roundings to 8 significant
    bits), and both parts are bf16 values."""
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        4096).astype(np.float32) * 37.0)
    hi = x.bfloat16().float()
    lo = (x - hi).bfloat16().float()
    assert bool(((x - hi).abs() <= 2.0 ** -8 * x.abs()).all())
    assert bool(((x - hi - lo).abs() <= 2.0 ** -16 * x.abs()).all())
    assert torch.equal(hi.bfloat16().float(), hi)
    assert torch.equal(lo.bfloat16().float(), lo)
