"""BEATs' position convolution entry (``ops/pos_conv.py``) on the CPU: the
bfloat16 kernel's index algebra, mirrored in numpy from
``csrc/pos_conv.cu`` (the re-laid weights, the chunk-major slab and the
wgmma descriptors that read both), against ``F.conv1d``; and the plain
entry against the benchmark's reference (``portbench/reference/beats``).
No card: the kernel itself is held to the plain entry in
``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bsed_tpu_torch.ops import pos_conv as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (B, L, d, groups, taps): BEATs' group width and taps at a short L; a
# group of 64 (16-wide chunks) over two token tiles; odd taps, whose last
# stage is padded
CASES = [(1, 40, 96, 2, 128), (1, 530, 128, 2, 16), (2, 37, 64, 2, 31)]


def _inputs(b, n, d, groups, taps, seed=0):
    """x, weight and bias rounded to bfloat16, and the SamePad
    convolution of their values in float64."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, n, d, generator=gen).bfloat16()
    w = (torch.randn(d, d // groups, taps, generator=gen) * 0.1).bfloat16()
    bias = torch.randn(d, generator=gen).bfloat16()
    conv = F.conv1d(x.double().transpose(1, 2), w.double(), bias.double(),
                    padding=taps // 2, groups=groups)[..., :n]
    return x, w, bias, conv.transpose(1, 2)


def _desc_tile(flat, start, lead, stride, rows):
    """The (rows, 16) operand a K-major, unswizzled wgmma descriptor reads
    from ``flat`` (elements, 8 to a 16-byte unit): core matrix (r // 8, e
    // 8) at unit start + (e // 8)·lead + (r // 8)·stride, its rows one
    unit apart."""
    r = np.arange(rows)[:, None]
    e = np.arange(16)[None, :]
    unit = start + (e // 8) * lead + (r // 8) * stride + r % 8
    return flat[unit * 8 + e % 8]


def _mma_body(x, packed, groups, taps):
    """The bfloat16 body's sums (B, L, d), float64, block by block as
    ``pos_conv_mma_kernel`` forms them: the slab as its TMA boxes lay it
    (zeros outside the clip), the weight stages as the bulk copies bring
    them, every k16 slice's A and B read through the kernel's descriptors
    (A: leading one chunk's rows, stride 8 rows; B: leading ``width``
    rows, stride 8), slices past K on the last real slice's rows."""
    b, n, d = x.shape
    cg, nc = d // groups, P.chunk_width(d // groups)
    rows, pad = P.slab_rows(taps), taps // 2
    last = taps * cg // 16 - 1
    xs = x.double().numpy()
    out = np.zeros((b, n, d))
    for bi in range(b):
        for g in range(groups):
            for j in range(cg // nc):
                wflat = packed[g, j].double().numpy().reshape(-1)
                for t0 in range(0, n, P.TOKENS):
                    slab = np.zeros((cg // 8, rows, 8))
                    tok = t0 - pad + np.arange(rows)
                    ok = (tok >= 0) & (tok < n)
                    part = xs[bi, tok[ok], g * cg:(g + 1) * cg]
                    slab[:, ok] = part.reshape(-1, cg // 8, 8).transpose(
                        1, 0, 2)
                    slab = slab.reshape(-1)
                    acc = np.zeros((P.TOKENS, nc))
                    for sl in range(P.stages(taps, cg) * P.STAGE_K // 16):
                        kk = min(sl, last) * 16
                        k, c8 = kk // cg, (kk % cg) // 8
                        a = _desc_tile(slab, c8 * rows + k, rows, 8,
                                       P.TOKENS)
                        bt = _desc_tile(wflat, sl * nc * 2, nc, 8, nc)
                        acc += a @ bt.T
                    m = min(P.TOKENS, n - t0)
                    out[bi, t0:t0 + m, g * cg + j * nc:g * cg + (j + 1) * nc] \
                        = acc[:m]
    return torch.from_numpy(out)


@pytest.mark.parametrize("b,n,d,groups,taps", CASES)
def test_relaid_weights_read_as_the_kernel_reads_them(b, n, d, groups, taps):
    """``pack_weight``'s layout and the overlapping-row view of x: row t
    of A = ``as_strided(slab, (L, K·d/g), (d/g, 1))`` (the slab x's
    group's rows from −K/2, zero-padded), times the re-laid weights read
    back as (d/g, K·d/g), is the SamePad convolution; so are the kernel's
    descriptor reads of its chunk-major slab and weight stages, block by
    block (float64 on bfloat16 values: exact but for the order of sums)."""
    x, w, bias, conv = _inputs(b, n, d, groups, taps)
    packed = P.pack_weight(w, groups)
    assert packed.shape == P.packed_shape(w, groups)
    cg, nc = d // groups, P.chunk_width(d // groups)
    kp = packed.shape[2] * 8
    assert kp % P.STAGE_K == 0 and kp >= taps * cg
    dense = packed.transpose(2, 3).reshape(groups, cg, kp).double()
    assert not dense[..., taps * cg:].any()           # the stages' padding
    pad = taps // 2
    for g in range(groups):
        slab = F.pad(x[..., g * cg:(g + 1) * cg].double(),
                     (0, 0, pad, taps - 1 - pad))
        for bi in range(b):
            a = torch.as_strided(slab[bi], (n, taps * cg), (cg, 1))
            got = a @ dense[g, :, :taps * cg].T + bias[g * cg:(g + 1) * cg]
            torch.testing.assert_close(
                got, conv[bi, :, g * cg:(g + 1) * cg], rtol=0, atol=1e-9)
    got = _mma_body(x, packed, groups, taps) + bias.double()
    torch.testing.assert_close(got, conv, rtol=0, atol=1e-9)
    assert packed.shape[1] == cg // nc


def test_kernel_constants_mirror_the_source():
    """The numbers ``ops/pos_conv.py`` lays the weights and sizes shared
    memory by are ``csrc/pos_conv.cu``'s; BEATs' widths fit one block an
    SM with room."""
    src = open(os.path.join(ROOT, "bsed_tpu_torch", "csrc",
                            "pos_conv.cu")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([^;]+);",
                             src).group(1).split()[-1])
    assert const("TOK") == P.TOKENS
    assert 16 * const("SPS") == P.STAGE_K
    assert const("RING") == P.RING
    assert const("SLAB_BOX") == P.SLAB_BOX
    assert const("SMEM_MAX") == P.SMEM_MAX
    assert P.chunk_width(48) == 48 and P.chunk_width(64) == 16
    assert P.slab_rows(128) == 640 and P.stages(128, 48) == 48
    assert P.shared_bytes(48, 128) < P.SMEM_MAX


def test_plain_entry_matches_the_reference_embedding():
    """The plain entry (the CPU's path, no launch counted) on the tokens
    of a tiny BEATs, then the encoder's LayerNorm, against
    ``reference/beats.embed`` (float32, 1e-5); in bfloat16 its one
    rounding of x + GELU(conv + bias)."""
    from portbench.harness import beats as B
    from portbench.harness import weights as Wt
    from portbench.reference import beats as RB
    from bsed_tpu_torch.models.beats import BEATs
    from bsed_tpu_torch.utils.weights import load_beats
    from tests.test_torch_beats import _bc, _config

    config = _config()
    params = B.make_params(config, 11, 12, "cpu")
    enc = BEATs(_bc(config))
    load_beats(enc, Wt.to_numpy(params["beats"]))
    enc.eval()
    fb = torch.randn(2, 98, 128, generator=torch.Generator().manual_seed(2))
    p, e = 16, enc.bc.embed_dim
    with torch.no_grad():
        patches = (fb[:, :96].reshape(2, 6, p, 8, p).transpose(2, 3)
                   .reshape(2, 48, p * p))
        x = enc.post_extract_proj(enc.layer_norm(
            patches @ enc.patch_embedding.weight.reshape(e, -1).t()))
        conv = enc.encoder.pos_conv[0]
        before = P.pos_conv_residual.launches
        y = P.pos_conv_residual(x, conv.weight, conv.bias, conv.groups)
        assert P.pos_conv_residual.launches == before
        got = enc.encoder.layer_norm(y)
        want = RB.embed(fb, params["beats"], config["beats"])
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        xb, wb, bb = x.bfloat16(), conv.weight.bfloat16(), conv.bias.bfloat16()
        yb = P.pos_conv_residual(xb, wb, bb, conv.groups)
        ref = P.pos_conv_residual_plain(xb.float(), wb.float(), bb.float(),
                                        conv.groups)
    assert yb.dtype == torch.bfloat16
    torch.testing.assert_close(yb, ref.bfloat16(), rtol=0, atol=0)
