"""The stem epilogue's group-pool form (K2-pg forward, K3-pg backward):
the port's make_fused_epilogue(pool_w=None, pg=...) through its autograd
Function, which runs the plain versions on CPU tensors, against the JAX
fused epilogue in the same form in interpret mode. The same numpy-seeded
h, inv, c, w, b and uint8 bits go to both sides, at G = 16 and G = 2 (the
first and last of blocks 3-6). Gates are tests/test_stem_epilogue.py's:
forward 1e-5, the five gradients 2e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsed_tpu.ops.stem_epilogue import make_fused_epilogue as j_make

from bsed_tpu_torch.ops import stem_epilogue as se

B, T, L = 2, 21, 128


def _inputs(g, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, T, g, L)).astype(np.float32)
    inv = rng.uniform(0.5, 1.5, L).astype(np.float32)
    c = (rng.standard_normal(L) * 0.3).astype(np.float32)
    w = (rng.standard_normal((L, L)) / np.sqrt(L)).astype(np.float32)
    b = (rng.standard_normal(L) * 0.1).astype(np.float32)
    bits = rng.integers(0, 256, (B, T * g, L), dtype=np.uint8)
    return h, inv, c, w, b, bits


@pytest.mark.parametrize("g", [16, 2])
@pytest.mark.parametrize("pt,pg,rate", [(1, 2, 0.0), (2, 2, 0.0),
                                        (1, 1, 0.0), (1, 2, 0.5)])
def test_group_pool_matches_jax(g, pt, pg, rate):
    h, inv, c, w, b, bits = _inputs(g, 10 * g + pt + pg)
    cot = np.random.default_rng(3).standard_normal(
        (B, T // pt, g // pg, L)).astype(np.float32)

    ep = se.make_fused_epilogue("glu", pt, None, rate=rate, pg=pg)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (h, inv, c, w, b)]
    tb = torch.from_numpy(bits) if rate > 0 else None
    before = (se.stem_epilogue_fwd.launches, se.stem_epilogue_bwd.launches)
    out = ep(*leaves, tb)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    assert (se.stem_epilogue_fwd.launches,
            se.stem_epilogue_bwd.launches) == before   # CPU: plain versions

    jep = j_make("glu", pt, rate, None, pg=pg, tile_target=8)
    jb = jnp.asarray(bits) if rate > 0 else None
    want = np.asarray(jep(h, inv, c, w, b, jb))
    jgrads = jax.grad(lambda *a: jnp.sum(jep(*a, jb) * cot),
                      argnums=(0, 1, 2, 3, 4))(h, inv, c, w, b)

    assert out.shape == want.shape == (B, T // pt, g // pg, L)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    for name, a, e in zip("h inv c w b".split(), grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=2e-4,
                                   atol=2e-4, err_msg=f"grad {name}")
    if pt == 2:                                  # the dropped odd row
        assert float(grads[0][:, -1].abs().max()) == 0.0


def test_group_pool_form_is_checked():
    pool_w = torch.full((L, L // 2), 0.5)
    with pytest.raises(ValueError, match="mutually exclusive"):
        se.make_fused_epilogue("glu", 1, pool_w, pg=2)
    with pytest.raises(ValueError, match="group pool"):
        se.make_fused_epilogue("glu", 1, None, pg=4)
    se.check_group_form(2, 2, 2)
    with pytest.raises(ValueError, match="G | 64"):
        se.check_group_form(3, 1, 1)
    with pytest.raises(ValueError, match="G | 64"):
        se.check_group_form(64, 2, 1)


# ---- the bf16 group-pool body's index algebra (epilogue_pg_mma_kernel) ----

GROUP_FORMS = [(g, pt, pg) for g in (1, 2, 4, 8, 16, 32, 64)
               for pt in (1, 2) for pg in (1, 2)
               if se.PANEL_ROWS % g == 0 and (se.PANEL_ROWS // g) % pt == 0
               and g % pg == 0]


def _pool_group(p, g, pt, pg):
    """The output row of the panel (t', g') that panel row p pools into."""
    tl, gi = divmod(p, g)
    return (tl // pt) * (g // pg) + gi // pg


@pytest.mark.parametrize("g,pt,pg", GROUP_FORMS)
def test_group_fragment_rows_are_pool_groups(g, pt, pg):
    """For every (G, pt, pg) check_group_form admits: the fragment-row map
    is a bijection onto the 64-row panel with its inverse, a thread's two
    rows (i, i + 8 of an m16 tile) lie in one pool group, and when pt = pg
    = 2 the thread 4 lanes away (rows i ^ 1, i ^ 1 + 8) holds the rest of
    that group; each pooled row is written once, by a thread that holds
    its whole group."""
    se.check_group_form(g, pt, pg)
    rows = [se.fragment_panel_row(f, pt, g, pg) for f in range(64)]
    assert sorted(rows) == list(range(64))
    for f, p in enumerate(rows):
        assert se.panel_fragment_row(p, pt, g, pg) == f
    written = {}
    ru = pt * pg
    for mb in range(4):
        for i in range(8):
            f = 16 * mb + i
            mine = [rows[f], rows[f + 8]]
            if ru == 4:
                mine += [rows[f ^ 1], rows[(f ^ 1) + 8]]
            groups = {_pool_group(p, g, pt, pg) for p in mine}
            if ru > 1:
                assert len(groups) == 1 and len(set(mine)) == ru
            for r, f_r in enumerate((f, f + 8)):
                out = se.pool_output_row(f_r, pt, pg)
                if out is None:
                    continue
                want = (_pool_group(rows[f_r], g, pt, pg) if ru == 1
                        else groups.pop() if len(groups) == 1 else None)
                assert out == want and out not in written
                written[out] = f_r
    assert sorted(written) == list(range(64 // ru))


def test_group_pool_map_keeps_the_lane_and_time_forms():
    """pg = 1 leaves K2's and K3's earlier map as it was: the identity for
    pt = 1 and the time pairs for pt = 2."""
    for f in range(64):
        assert se.fragment_panel_row(f, 1, 16) == f
        assert se.fragment_panel_row(f, 1, 16, 1) == f
        for g in (1, 2, 16):
            assert (se.fragment_panel_row(f, 2, g, 2)
                    == se.fragment_panel_row(f, 2, g, 1))


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, 104_960),
                                        (torch.float32, 98_304)])
def test_group_pool_body_shared_memory(dtype, want):
    """K2-pg's bf16 body holds w, inv/c/b, two stages of (h, bits) and a
    pooled panel of 128-lane rows at the 272-byte stride; two blocks fit
    an SM with the 1 KB each reserves. The f32 FMA body keeps w and
    round(y) in float32. Its body is mma in bf16, fma in f32."""
    got = se.kernel_shared_memory("fwd", dtype, lane_form=False)
    assert got == {"bytes": want, "blocks_per_sm": 2}
    assert 2 * (got["bytes"] + 1024) <= 228 * 1024
    body = "mma" if dtype == torch.bfloat16 else "fma"
    assert se.kernel_body(dtype, lane_form=False)["fwd"] == body
