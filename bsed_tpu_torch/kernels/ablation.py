"""Where the time of a kernel goes: time copies of its source with one
phase taken out.

    python -m bsed_tpu_torch.kernels.ablation [--block 0|1|2]
    python -m bsed_tpu_torch.kernels.ablation --kernel stem
    python -m bsed_tpu_torch.kernels.ablation --kernel attention

The card has no kernel profiler that attributes time inside a kernel, so
each variant is the source with a few lines edited away (the products, the
dW chain, the gate, the dh stores, ...), built beside the real library and
timed through the same C entry points: K2's and K3's tensor-core bodies at
one folded block's student shape (B=72, bfloat16, GLU, dropout bits; the
default), or K5, the fused block-0 stem, at the fused-stem path's shape
(``--kernel stem``: B=64, T=1255, float32), or BEATs' attention body at
the serving shape (``--kernel attention``: B=64, 12 heads of 64, 496
tokens, bfloat16). A variant computes wrong numbers by
design; only its time is read. What a phase costs is the base time minus
the time without it; if the phases overlapped, the differences would sum to
less than the base.

Every edit names text that must be present in the source: ``variants()``
raises if a source has moved on, and ``tests/test_torch_stem_epilogue.py``
holds that on the CPU. One JSON line per variant, then the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from typing import Dict, List, Tuple

from bsed_tpu_torch import kernels

Edit = Tuple[str, str]

FWD, BWD, COMMON = "stem_epilogue", "stem_epilogue_bwd", "stem_common"
STEM = "stem_kernel"
ATTN = "rel_attention"

# the edits, by phase: (source, text in it, replacement)
PHASES: Dict[str, List[Tuple[str, str, str]]] = {
    # K3
    "bwd_no_dw": [(BWD, "      wgmma_n128_mn_mn(dw, ha,",
                   "      if (tid < 0) wgmma_n128_mn_mn(dw, ha,")],
    "bwd_no_products": [
        (BWD, "      wgmma_n64_reg_mn(acc,",
         "      if (tid < 0) wgmma_n64_reg_mn(acc,"),
        (BWD, "      wgmma_n64_k_k(acc,",
         "      if (tid < 0) wgmma_n64_k_k(acc,")],
    "bwd_no_gate": [
        (BWD, "    for (int nb = 0; nb < 8; ++nb) {\n"
              "      const int col = nh * 64 + nb * 8 + 2 * t;\n"
              "      const int cp = col / 2;\n"
              "      const float2 iv = inv2[cp], cv = c2[cp], bv = b2[cp];",
         "    for (int nb = 0; nb < 0; ++nb) {\n"
         "      const int col = nh * 64 + nb * 8 + 2 * t;\n"
         "      const int cp = col / 2;\n"
         "      const float2 iv = inv2[cp], cv = c2[cp], bv = b2[cp];")],
    "bwd_no_split": [(BWD, "        split_bf16(dl[0], dl[1], hi, lo);",
                      "        hi = pack_bf16(dl[0], dl[1]); lo = 0;")],
    "bwd_no_dh_store": [
        (BWD, "        if (inside[r])\n"
              "          reinterpret_cast<uint32_t*>(dhrow[r])[cp] =",
         "        if (inside[r] && tid < 0)\n"
         "          reinterpret_cast<uint32_t*>(dhrow[r])[cp] =")],
    "bwd_no_fragments": [
        (BWD, "          const float2 hv = hpair(r, cp);\n"
              "          a[kb][half * 2 + r] = pack_bf16("
              "fmaf(hv.x, iv.x, cv.x),\n"
              "                                          "
              "fmaf(hv.y, iv.y, cv.y));",
         "          a[kb][half * 2 + r] = kb + r + tid;")],
    # K2
    "fwd_no_product": [(FWD, "    wgmma_n64_reg_mn(acc, a[kb],",
                        "    if (t < 0) wgmma_n64_reg_mn(acc, a[kb],")],
    # both
    "cheap_sigmoid": [(COMMON, "  return __fdividef(1.f, 1.f + __expf(-v));",
                       "  return 0.5f + 0.01f * v;")],
    # K5
    "stem_no_sigmoid": [(STEM, "            acc += l * sigmoid_ex2(g);",
                         "            acc += l * (0.5f + 0.01f * g);")],
    "stem_no_convs": [(STEM, "            for (int kt = 0; kt < 3; ++kt)",
                       "            for (int kt = 0; kt < 0; ++kt)")],
    "stem_no_staging": [(STEM, "      cp_async16(st + r * RS + 4 * q,",
                         "      if (i < 0) cp_async16(st + r * RS + 4 * q,")],
    "stem_no_stores": [(STEM, "      store_out(dst + (size_t)r * FO * C, res);",
                        "      if (res[0] == 1.2345f) "
                        "store_out(dst + (size_t)r * FO * C, res);")],
    # BEATs' attention, bf16 body
    "attn_no_bias": [
        (ATTN, "sc[n][2 * r] = fmaf(g8[r], pv.x, sc[n][2 * r]);",
         "sc[n][2 * r] += 0.f;"),
        (ATTN, "sc[n][2 * r + 1] = fmaf(g8[r], pv.y, sc[n][2 * r + 1]);",
         "sc[n][2 * r + 1] += 0.f;")],
    "attn_no_exp": [
        (ATTN, "sc[n][e] = ex2(fmaf(sc[n][e], c1, -mc[e >> 1]));",
         "sc[n][e] = fmaf(sc[n][e], c1, -mc[e >> 1]);")],
    "attn_no_rescale": [
        (ATTN, "for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];",
         "for (int e = 0; e < 4; ++e) o[n][e] += 0.f;")],
    "attn_no_pv": [(ATTN, "wgmma_n64_reg_mn(o, a[kb],",
                    "if (t < 0) wgmma_n64_reg_mn(o, a[kb],")],
    "attn_no_scores": [(ATTN, "wgmma_scores(sc, desc_sw_k(",
                        "if (t < 0) wgmma_scores(sc, desc_sw_k(")],
    "attn_no_stores": [(ATTN, "if (row[r] >= len) continue;",
                        "if (row[r] >= 0) continue;")],
    "attn_no_pack": [(ATTN, "pack_bf16(sc[n][2 * r], sc[n][2 * r + 1]);",
                      "__float_as_uint(sc[n][2 * r]);")],
    "attn_loads_only": [
        (ATTN, "  for (int pass = 0; wg + WGS * pass < nkt; ++pass) {",
         "  mbar_wait(q_bar, 0);\n  mbar_wait(p_bar, 0);\n"
         "  if (nkt > WGS) mbar_wait(q_bar + 1, 0);\n"
         "  for (int j = 0; j < nst; ++j) mbar_wait(kv_bar + j, 0);\n"
         "  return;\n"
         "  for (int pass = 0; wg + WGS * pass < nkt; ++pass) {")],
}

# variant -> (the kernel it times, the phases taken out)
VARIANTS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "k3_base": (BWD, ()),
    "k3_no_dw": (BWD, ("bwd_no_dw",)),
    "k3_no_products": (BWD, ("bwd_no_products",)),
    "k3_no_tensor": (BWD, ("bwd_no_dw", "bwd_no_products")),
    "k3_cheap_sigmoid": (BWD, ("cheap_sigmoid",)),
    "k3_no_split": (BWD, ("bwd_no_split",)),
    "k3_no_dh_store": (BWD, ("bwd_no_dh_store",)),
    "k3_no_fragments": (BWD, ("bwd_no_fragments",)),
    "k3_no_gate": (BWD, ("bwd_no_gate",)),
    "k3_loads_fragments_dh_only": (
        BWD, ("bwd_no_dw", "bwd_no_products", "bwd_no_gate")),
    "k3_loads_only": (BWD, ("bwd_no_dw", "bwd_no_products", "bwd_no_gate",
                            "bwd_no_fragments", "bwd_no_dh_store")),
    "k2_base": (FWD, ()),
    "k2_no_product": (FWD, ("fwd_no_product",)),
    "k2_cheap_sigmoid": (FWD, ("cheap_sigmoid",)),
    "k5_base": (STEM, ()),
    "k5_no_sigmoid": (STEM, ("stem_no_sigmoid",)),
    "k5_no_convs": (STEM, ("stem_no_convs",)),
    "k5_loads_stores_only": (STEM, ("stem_no_sigmoid", "stem_no_convs")),
    "k5_no_staging": (STEM, ("stem_no_staging",)),
    "k5_no_stores": (STEM, ("stem_no_stores",)),
    "k5_compute_only": (STEM, ("stem_no_staging", "stem_no_stores")),
    "attn_base": (ATTN, ()),
    "attn_no_bias": (ATTN, ("attn_no_bias",)),
    "attn_no_exp": (ATTN, ("attn_no_exp",)),
    "attn_no_rescale": (ATTN, ("attn_no_rescale",)),
    "attn_no_pv": (ATTN, ("attn_no_pv",)),
    "attn_no_scores": (ATTN, ("attn_no_scores",)),
    "attn_no_tensor": (ATTN, ("attn_no_pv", "attn_no_scores")),
    "attn_no_stores": (ATTN, ("attn_no_stores",)),
    "attn_no_pack": (ATTN, ("attn_no_pack",)),
    "attn_softmax_only": (ATTN, ("attn_no_pv", "attn_no_scores",
                                 "attn_no_bias")),
    "attn_memory_only": (ATTN, ("attn_no_pv", "attn_no_scores",
                                "attn_no_bias", "attn_no_exp",
                                "attn_no_pack")),
    "attn_loads_only": (ATTN, ("attn_loads_only",)),
}


def variants() -> Dict[str, Tuple[str, Dict[str, str]]]:
    """``{variant: (kernel source name, {file name: edited text})}`` for
    every variant; raises ValueError if an edit's text is not in its
    source."""
    texts = {name: (kernels.SRC_DIR / f"{name}.cu").read_text()
             for name in (FWD, BWD, STEM, ATTN)}
    headers = {h.name: h.read_text()
               for h in sorted(kernels.SRC_DIR.glob("*.cuh"))}
    out = {}
    for name, (kernel, phases) in VARIANTS.items():
        files = {f"{kernel}.cu": texts[kernel], **headers}
        for phase in phases:
            for src, old, new in PHASES[phase]:
                fname = f"{src}.cuh" if src == COMMON else f"{src}.cu"
                if src not in (kernel, COMMON):
                    raise ValueError(f"{name}: {phase} edits {src}, not "
                                     f"{kernel}")
                if old not in files[fname]:
                    raise ValueError(f"{name}: {phase} names text that "
                                     f"csrc/{fname} no longer has")
                files[fname] = files[fname].replace(old, new)
        out[name] = (kernel, files)
    return out


def build_variants(sources) -> Dict[str, Tuple[str, ctypes.CDLL]]:
    """Compile every variant of the kernels in ``sources`` (all nvcc
    processes started together) under the kernels' build directory;
    ``{variant: (kernel, library)}``."""
    root = kernels.BUILD_DIR / "ablation"
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    jobs = {}
    for name, (kernel, files) in variants().items():
        if kernel not in sources:
            continue
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in files.items():
            (d / fname).write_text(text)
        so = d / "lib.so"
        jobs[name] = (kernel, so, subprocess.Popen(
            [kernels._nvcc(), *flags, "-o", str(so), str(d / f"{kernel}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    try:
        for name, (kernel, so, proc) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
            libs[name] = (kernel, ctypes.CDLL(str(so)))
    finally:
        for _, _, proc in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return libs


def time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median per-call device time (CUDA events, ms) of ``fn()``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


# the folded blocks 0-2 at the student batch: (T, pt, channels per fold copy)
BLOCKS = ((1255, 2, 16), (627, 2, 32), (313, 1, 64))
BATCH = 72


def epilogue_calls(torch, dev, block: int, libs):
    """{variant: call} for K2's and K3's variants at folded block
    ``block``'s student shape."""
    from bsed_tpu_torch.ops import stem_epilogue as se
    t_in, pt, pc = BLOCKS[block]
    gen = torch.Generator(device=dev).manual_seed(5)
    h = torch.randn((BATCH, t_in, 16, 128), generator=gen,
                    device=dev).bfloat16()
    w = (torch.randn((128, 128), generator=gen, device=dev)
         / 128 ** 0.5).bfloat16()
    inv = 1.0 + 0.2 * torch.randn(128, generator=gen, device=dev)
    c = 0.3 * torch.randn(128, generator=gen, device=dev)
    b = 0.1 * torch.randn(128, generator=gen, device=dev)
    bits = torch.randint(0, 256, (BATCH, t_in * 16, 128), generator=gen,
                         device=dev, dtype=torch.uint8)
    gz = torch.randn((BATCH, t_in // pt, 16, 64), generator=gen,
                     device=dev).bfloat16()
    out = torch.empty_like(gz)
    dh = torch.empty_like(h)
    f32 = dict(device=dev, dtype=torch.float32)
    dw = torch.empty((128, 128), **f32)
    dinv, dc, db = (torch.empty(128, **f32) for _ in range(3))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ws = torch.empty((sms, 128 * 128 + 3 * 128), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    calls = {}
    for name, (kernel, lib) in libs.items():
        if kernel == FWD:
            fn = se._bind_fwd(lib)

            def call(fn=fn):
                return fn(h.data_ptr(), inv.data_ptr(), c.data_ptr(),
                          w.data_ptr(), b.data_ptr(), bits.data_ptr(), 128,
                          out.data_ptr(), 1, 0, pt, BATCH, t_in, t_in // pt,
                          16, pc, 1, stream)
        else:
            fn = se._bind_bwd(lib)

            def call(fn=fn):
                return fn(gz.data_ptr(), h.data_ptr(), inv.data_ptr(),
                          c.data_ptr(), w.data_ptr(), b.data_ptr(),
                          bits.data_ptr(), 128, dh.data_ptr(), dw.data_ptr(),
                          dinv.data_ptr(), dc.data_ptr(), db.data_ptr(),
                          ws.data_ptr(), sms, 1, 0, pt, BATCH, t_in,
                          t_in // pt, 16, pc, 1, stream)
        calls[name] = call
    return calls, {"block": block, "batch": BATCH, "dtype": "bfloat16"}


STEM_BATCH, STEM_T = 64, 1255


def stem_calls(torch, dev, libs):
    """{variant: call} for K5's variants at the fused-stem path's shape
    (B=64, T=1255, float32), random folded parameters."""
    from bsed_tpu_torch.ops import stem_kernel as sk
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((STEM_BATCH, STEM_T, 128), generator=gen, device=dev)
    prm = 0.3 * torch.randn(sk.N_PACKED, generator=gen, device=dev)
    out = torch.empty((STEM_BATCH, STEM_T // 2, 64, 16), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    calls = {}
    for name, (_, lib) in libs.items():
        fn = sk._bind(lib)

        def call(fn=fn):
            return fn(x.data_ptr(), prm.data_ptr(), out.data_ptr(),
                      STEM_BATCH, STEM_T, STEM_T // 2, stream)
        calls[name] = call
    return calls, {"batch": STEM_BATCH, "frames": STEM_T,
                   "dtype": "float32"}


ATTN_SHAPE = (64, 12, 496, 64)


def attention_calls(torch, dev, libs):
    """{variant: call} for the attention body's variants at the serving
    shape, q, k, v as the model's views, through the wrapper's
    ``launch_plan``."""
    from bsed_tpu_torch.ops import rel_attention as RA
    b, h, n, d = ATTN_SHAPE
    gen = torch.Generator(device=dev).manual_seed(21)
    q, k, v = (torch.randn((b, n, h * d), generator=gen, device=dev)
               .bfloat16().view(b, n, h, d).transpose(1, 2)
               for _ in range(3))
    gate = (1 + torch.rand((b, h, n, 1), generator=gen,
                           device=dev)).bfloat16()
    bias = torch.randn((h, n, n), generator=gen, device=dev).bfloat16()
    (q, k, v, gate, bias), strides = RA.launch_plan(q, k, v, gate, bias)
    stride_arg = (ctypes.c_longlong * len(strides))(*strides)
    out = torch.empty((b, n, h, d), device=dev, dtype=q.dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    calls = {}
    for name, (_, lib) in libs.items():
        fn = RA._bind(lib)

        def call(fn=fn):
            return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      gate.data_ptr(), bias.data_ptr(), out.data_ptr(), 1,
                      b, h, n, d, stride_arg, stream)
        calls[name] = call
    return calls, {"shape": list(ATTN_SHAPE), "dtype": "bfloat16"}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernel", default="epilogue",
                        choices=("epilogue", "stem", "attention"))
    parser.add_argument("--block", type=int, default=0, choices=(0, 1, 2))
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ablation: no CUDA device")
    dev = torch.device("cuda")
    if args.kernel == "stem":
        calls, shape = stem_calls(torch, dev, build_variants((STEM,)))
    elif args.kernel == "attention":
        calls, shape = attention_calls(torch, dev, build_variants((ATTN,)))
    else:
        calls, shape = epilogue_calls(torch, dev, args.block,
                                      build_variants((FWD, BWD)))
    for name, call in calls.items():
        kernels.check(call(), f"ablation variant {name}")
        torch.cuda.synchronize()
        print(json.dumps({"variant": name, **shape,
                          "without": list(VARIANTS[name][1]),
                          "ms": time_ms(torch, call)}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
