"""K2's plain version (bsed_tpu_torch/ops/stem_epilogue.py, what the
wrapper runs on CPU tensors) against the JAX fused stem epilogue in
interpret mode, on identical numpy inputs: odd T=21, general inv/c, the
folded stem's pair-averaging pool_w. Gate 1e-5 in float32, as
tests/test_stem_epilogue.py holds the Pallas kernel."""
import numpy as np
import pytest
import torch

from bsed_tpu.ops.folded_stem import _freq_pool_matrix as j_freq_pool_matrix
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
    return h, inv, c, w, b


@pytest.mark.parametrize("act", ["glu", "cg"])
@pytest.mark.parametrize("pt", [1, 2])
def test_plain_matches_jax_kernel(act, pt):
    h, inv, c, w, b = _inputs(0)
    pool_w = _freq_pool_matrix(2, 2, 64)
    want = np.asarray(j_make(act, pt, 0.0, pool_w, tile_target=8)(
        h, inv, c, w, b, None))
    ep = se.make_fused_epilogue(act, pt, torch.from_numpy(pool_w))
    before = se.stem_epilogue_fwd.launches
    got = ep(*map(torch.from_numpy, (h, inv, c, w, b)))
    assert se.stem_epilogue_fwd.launches == before   # no launch on CPU
    assert got.shape == (B, T // pt, G, L2) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("f,c", [(8, 16), (4, 32), (2, 64)])
def test_pair_pool_channels_recovers_fold(f, c):
    """The three serving blocks' pool matrices (the JAX package's own) are
    recognised with the channels per fold copy the kernel needs."""
    assert se.pair_pool_channels(j_freq_pool_matrix(f, 2, c)) == c


def test_rejects_what_the_kernel_does_not_compute():
    pool_w = _freq_pool_matrix(2, 2, 64)
    with pytest.raises(ValueError, match="pair-averaging"):
        se.make_fused_epilogue("glu", 2,
                               torch.from_numpy(pool_w[:, ::-1].copy()))
    with pytest.raises(ValueError, match="pair-averaging"):
        se.make_fused_epilogue("glu", 2, torch.ones(128, 64) / 128)
    with pytest.raises(ValueError, match="glu/cg"):
        se.make_fused_epilogue("relu", 2, torch.from_numpy(pool_w))
    with pytest.raises(ValueError, match="time pool"):
        se.make_fused_epilogue("glu", 4, torch.from_numpy(pool_w))


def test_bf16_plain_close_to_jax_kernel():
    """bf16: the plain chain rounds at every op, the kernel keeps f32
    registers; the repo's bf16 gate (test_stem_epilogue.py:111-113)."""
    h, inv, c, w, b = _inputs(3)
    pool_w = _freq_pool_matrix(2, 2, 64)
    import jax.numpy as jnp
    want = j_make("glu", 2, 0.0, pool_w, tile_target=8)(
        jnp.asarray(h, jnp.bfloat16), inv, c, jnp.asarray(w, jnp.bfloat16),
        b, None)
    got = se.make_fused_epilogue("glu", 2, torch.from_numpy(pool_w))(
        torch.from_numpy(h).bfloat16(), torch.from_numpy(inv),
        torch.from_numpy(c), torch.from_numpy(w).bfloat16(),
        torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=0.06, atol=0.06)


# ---- what the tensor-core bodies of K2 and K3 rest on ----------------------

PANEL_FORMS = [(pt, g) for pt in (1, 2) for g in (1, 2, 4, 8, 16, 32, 64)
               if (se.PANEL_ROWS // g) % pt == 0]


@pytest.mark.parametrize("pt,g", PANEL_FORMS)
def test_fragment_rows_cover_the_panel(pt, g):
    """The fragment-row map is a bijection onto the panel's 64 rows for
    every (pt, G) the kernels take (check_group_form: G | 64 and 64/G a
    multiple of pt; the lane form is G = 16)."""
    se.check_group_form(g, pt, 1)
    rows = [se.fragment_panel_row(f, pt, g) for f in range(se.PANEL_ROWS)]
    assert sorted(rows) == list(range(se.PANEL_ROWS))
    if pt == 1:
        assert rows == list(range(se.PANEL_ROWS))
    # and the map K3 stages h by is its inverse
    for f, p in enumerate(rows):
        assert se.panel_fragment_row(p, pt, g) == f


@pytest.mark.parametrize("g", [g for pt, g in PANEL_FORMS if pt == 2])
def test_fragment_row_pairs_are_time_pairs(g):
    """pt = 2: the two rows of a thread (rows i and i + 8 of an m16 tile)
    are (t, g) and (t + 1, g) with t even, so the time pool is one add in
    the thread and both rows read the same cotangent."""
    for mb in range(4):
        for i in range(8):
            first = se.fragment_panel_row(16 * mb + i, 2, g)
            second = se.fragment_panel_row(16 * mb + i + 8, 2, g)
            assert second == first + g
            assert first % g == second % g and (first // g) % 2 == 0


def test_fragment_row_map_rejects_rows_outside_the_panel():
    with pytest.raises(ValueError, match="outside"):
        se.fragment_panel_row(64, 1, 16)
    with pytest.raises(ValueError, match="outside"):
        se.panel_fragment_row(-1, 2, 16)


@pytest.mark.parametrize("pc", [8, 16, 32, 64])
def test_lane_pool_partners_are_whole_fragment_blocks(pc):
    """K2's tensor-core body takes, for each block of 8 output lanes, the
    8-lane input block ``lane_pool_source`` and its partner ``pc`` lanes
    further as two accumulator blocks of one thread: together they are all
    16 input blocks, and pool_w averages exactly those lane pairs."""
    pool_w = _freq_pool_matrix(128 // pc, 2, pc)
    blocks = []
    for o0 in range(0, 64, 8):
        src = se.lane_pool_source(o0, pc)
        assert src % 8 == 0
        blocks += [src // 8, (src + pc) // 8]
        for i in range(8):
            assert se.lane_pool_source(o0 + i, pc) == src + i
            col = pool_w[:, o0 + i]
            assert col[src + i] == col[src + pc + i] == 0.5
            assert np.count_nonzero(col) == 2
    assert sorted(blocks) == list(range(16))


def test_core_matrix_layout_is_a_blocked_bijection():
    """The 64 x 128 tile in the core-matrix layout: every element has its
    own 2 bytes of the 16 KB, and an 8 x 8 block is 128 contiguous bytes
    with its rows 16 bytes apart."""
    offs = np.array([[se.core_matrix_offset(r, c) for c in range(128)]
                     for r in range(64)])
    assert sorted(offs.ravel()) == list(range(0, 64 * 128 * 2, 2))
    block = offs[8:16, 24:32]
    assert block.min() == se.core_matrix_offset(8, 24) == 2048 + 3 * 128
    np.testing.assert_array_equal(
        block - block.min(),
        16 * np.arange(8)[:, None] + 2 * np.arange(8)[None, :])


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_shared_memory_fits_the_sm(kernel, dtype):
    """Each body's shared memory is within a block's 227 KB, and the
    blocks per SM its source claims fit the SM's 228 KB with the 1 KB a
    block reserves: K2 two blocks, K3 one."""
    got = se.kernel_shared_memory(kernel, dtype)
    assert got["bytes"] <= se.SMEM_LIMIT == 232_448
    assert got["blocks_per_sm"] == (2 if kernel == "fwd" else 1)
    assert got["blocks_per_sm"] * (got["bytes"] + 1024) <= 228 * 1024
    if got["blocks_per_sm"] == 1:        # and a second block does not fit
        assert 2 * (got["bytes"] + 1024) > 228 * 1024
    want = {("fwd", torch.bfloat16): 96_768, ("bwd", torch.bfloat16): 153_088,
            ("fwd", torch.float32): 98_304, ("bwd", torch.float32): 131_584}
    assert got["bytes"] == want[kernel, dtype]


@pytest.mark.parametrize("dtype,lane_form,pc,want", [
    (torch.bfloat16, True, 16, {"fwd": "mma", "bwd": "mma"}),
    (torch.bfloat16, True, 64, {"fwd": "mma", "bwd": "mma"}),
    (torch.bfloat16, True, 4, {"fwd": "fma", "bwd": "mma"}),
    (torch.bfloat16, False, 0, {"fwd": "mma", "bwd": "mma"}),
    (torch.float32, True, 16, {"fwd": "fma", "bwd": "fma"}),
    (torch.float32, False, 0, {"fwd": "fma", "bwd": "fma"})])
def test_kernel_body_by_dtype_and_form(dtype, lane_form, pc, want):
    """The choice between the tensor-core and the FMA body is by dtype and
    form, in the open."""
    assert se.kernel_body(dtype, lane_form, pc) == want


def test_ablation_variants_apply_to_the_sources():
    """kernels/ablation.py times copies of the K2 and K3 sources with one
    phase edited away: every edit still finds its text, a variant differs
    from the source exactly when it takes a phase out, and an edit whose
    text is gone raises."""
    from bsed_tpu_torch import kernels
    from bsed_tpu_torch.kernels import ablation
    built = ablation.variants()
    assert set(built) == set(ablation.VARIANTS)
    for name, (kernel, files) in built.items():
        assert kernel == ablation.VARIANTS[name][0]
        same = all(text == (kernels.SRC_DIR / fname).read_text()
                   for fname, text in files.items())
        assert same == (not ablation.VARIANTS[name][1]), name
    ablation.PHASES["gone"] = [(ablation.BWD, "no such text", "")]
    ablation.VARIANTS["k3_gone"] = (ablation.BWD, ("gone",))
    try:
        with pytest.raises(ValueError, match="no longer has"):
            ablation.variants()
    finally:
        del ablation.PHASES["gone"], ablation.VARIANTS["k3_gone"]
