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
