// BEATs' attention with its gated relative-position bias in one kernel
// (sm_90a): out = softmax(q·kᵀ/√D + g ⊙ P)·v, flash-style.
//
// Replaces no TPU kernel: bsed_tpu has no BEATs (the crnn_beats
// configuration exists only in the port), and its attention was the
// library's flash attention fed g ⊙ P as a materialised (B, H, L, L) mask.
// Wrapper and plain version: bsed_tpu_torch/ops/rel_attention.py.
//
// Inputs as the model passes them, read through their strides (the last
// dimension contiguous): q, k, v (B, H, L, D), the views of (B, L, H·D)
// that models/beats.py makes (heads inside rows inside the batch; the
// wrapper copies any other layout into it); gate (B, H, L, 1); bias P
// (H, L, L), shared by the batch. Output in (B, L, H, D) storage, so the
// caller's transpose(1, 2) to (B, L, H·D) is a view. D = 64.
//
// Bound on the H100: device memory, just. At B=64, H=12, L=496 a call
// reads q, k, v and writes the output once (196 MB, 0.058 ms at 3.35 TB/s)
// for 48.4 GFLOP (0.049 ms at 989 TFLOP/s bf16): the intensity L/2 = 248
// FLOP a byte sits under the bf16 ridge (295). So the kernel reads q, k
// and v once and keeps the scores, g ⊙ P and the weights out of device
// memory: no (B, H, L, L) tensor is ever written. P (5.9 MB in bf16) is
// read as given, tile by tile; every batch element reads the same P, so
// its tiles come from the 50 MB L2.
//
// bfloat16 body (rel_attention_mma_kernel), one block of 2 warpgroups a
// (b, h), L <= 512, up to 255 registers a thread:
//   * Every operand tile arrives by TMA (cp.async.bulk.tensor) into shared
//     memory in the 128-byte swizzle that wgmma reads, rows past L filled
//     with zeros, each signalling an mbarrier: k and v of the head whole
//     (2 x 64 KB, issued at the start, one barrier a 128-key step), each
//     warpgroup's query tiles (two buffers) and its P tiles (two buffers
//     of 64 rows x 128 keys, a step ahead). (cp.async moved 160 KB a block
//     at ~16 GB/s an SM, which left the first pass waiting on its loads.)
//   * Warpgroup w takes the 64-row query tiles w, w + 2, .... For each
//     128-key step, s = q·kᵀ is four wgmma.m64n128k16 from shared memory
//     (q and k K-major). A step issues its scores and then the last
//     step's o += p·v (eight wgmma.m64n64k16, the weights in registers as
//     the A operand, v MN-major), waits for the scores and runs their
//     softmax while p·v runs: FlashAttention-3's order, every wgmma wait
//     unconditional (a wait under a branch made ptxas serialize them).
//   * The softmax is float32 in registers: the scores get 8 g·P (1/√D =
//     1/8 is folded into one scale, c1 = log2 e / 8), keys past L go to
//     −∞, the online max and sum per row (a quad of lanes shares a row),
//     the weights exp2(s·c1 − m·c1), rounded to bf16 for p·v.
//   * Rows past L are computed on zeros and not stored.
// float32 body (rel_attention_fma_kernel), any L: FMA, no TF32. A thread
// owns one query row (q and its output row in registers); 128 rows a
// block; keys pass through shared memory in tiles of 32 with the same
// online softmax.
#include "tma_common.cuh"

namespace {

constexpr int HD = 64;                     // head width D
constexpr int TK = 64;                     // rows of a staged tile; query
                                           // rows a warpgroup tile
constexpr int SK = 2 * TK;                 // keys a step: two staged tiles
constexpr int WGS = 2;                     // warpgroups a block
constexpr int NTH = 128 * WGS;
constexpr int MAX_KEYS = 512;              // keys held in shared memory
constexpr int NKT = MAX_KEYS / TK;         // key tiles (8)
constexpr int NST = MAX_KEYS / SK;         // steps (4)
constexpr int TILE_B = TK * HD * 2;        // a 64 x 64 bf16 tile, 8,192 B
constexpr int SWROW = 128;                 // bytes a swizzled tile row
constexpr int SM_K = 0;
constexpr int SM_V = NKT * TILE_B;
constexpr int SM_Q = 2 * NKT * TILE_B;                 // [wg][2 buffers]
constexpr int SM_P = SM_Q + WGS * 2 * TILE_B;          // [wg][2][2 tiles]
constexpr int SM_BAR = SM_P + WGS * 2 * 2 * TILE_B;    // 229,376
constexpr int NBAR = NST + 2 * WGS + 2 * WGS;          // k/v, q, P
constexpr int ATT_SMEM = SM_BAR + NBAR * 8 + 1024;     // + alignment
constexpr float LOG2E = 1.4426950408889634f;

constexpr int F_ROWS = 128;                // float32 body: rows a block
constexpr int F_KEYS = 32;                 // keys a shared-memory tile

// Element strides: q, k, v and the gate by (batch, head, row), the bias by
// (head, row); the last dimension of each is contiguous.
struct Strides {
  long long qb, qh, ql, kb, kh, kl, vb, vh, vl, gb, gh, gl, ph, pi;
};

// the 128 threads of warpgroup wg (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- TMA ---------------------------------------------------------------
// a 64-row box of a 4-d map (d, head, row, batch)
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map,
                                         int c1, int c2, int c3,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_addr(bar))
      : "memory");
}
// a 64-key x 64-row box of P's map (key, row, head)
__device__ __forceinline__ void tma_bias(void* dst, const CUtensorMap* map,
                                         int key, int row, int head,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(key), "r"(row), "r"(head),
      "r"(smem_addr(bar))
      : "memory");
}

// wgmma descriptors of 128-byte-swizzled tiles (8-row atoms of 1,024 B):
// K-major (q, k: a k16 slice is 32 bytes on) and MN-major (v: a k16 slice
// is two atoms on)
__device__ __forceinline__ uint64_t desc_sw_k(uint32_t addr) {
  return smem_desc(addr, 16, 1024) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_sw_mn(uint32_t addr) {
  return smem_desc(addr, TILE_B, 1024) | (1ull << 62);
}

// s (64 x 128) = [s +] q (64 x 16) · kᵀ (128 keys x 16 of two consecutive
// k tiles), both K-major; accumulate = 0 overwrites s
__device__ __forceinline__ void wgmma_scores(float (&d)[16][4], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Keeps the compiler from moving an accumulator's registers while a
// wgmma that reads or writes them may be in flight.
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}

// Maps: q, k, v 4-d (d, heads, rows, batch); P 3-d (key, row, head).
__global__ void __launch_bounds__(NTH, 1)
rel_attention_mma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tp,
                         const __nv_bfloat16* __restrict__ gate,
                         __nv_bfloat16* __restrict__ out, long long gb,
                         long long gh_stride, long long gl, int H,
                         int len) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const __nv_bfloat16* gh = gate + b * gb + h * gh_stride;
  const int nkt = (len + TK - 1) / TK;
  const int nst = (len + SK - 1) / SK;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + SM_BAR);
  uint64_t* kv_bar = bars;                       // [step]
  uint64_t* q_bar = bars + NST + 2 * wg;         // [buffer]
  uint64_t* p_bar = bars + NST + 2 * WGS + 2 * wg;
  unsigned char* q_s = smem + SM_Q + wg * 2 * TILE_B;
  unsigned char* p_s = smem + SM_P + wg * 4 * TILE_B;
  const uint32_t k_a = smem_addr(smem + SM_K), v_a = smem_addr(smem + SM_V);
  // the warpgroup's query tile of pass p into buffer p & 1
  auto load_q = [&](int pass) {
    const int qt = wg + WGS * pass;
    if (qt < nkt) {
      mbar_expect(q_bar + (pass & 1), TILE_B);
      tma_rows(q_s + (pass & 1) * TILE_B, &tq, h, qt * TK, b,
               q_bar + (pass & 1));
    }
  };
  // P for the warpgroup's step c (pass c / nst, key step c % nst) into
  // buffer c & 1: two 64-key boxes
  auto load_p = [&](int c) {
    const int qt = wg + WGS * (c / nst), k0 = (c % nst) * SK;
    if (qt < nkt) {
      unsigned char* dst = p_s + (c & 1) * 2 * TILE_B;
      mbar_expect(p_bar + (c & 1), 2 * TILE_B);
      tma_bias(dst, &tp, k0, qt * TK, h, p_bar + (c & 1));
      tma_bias(dst + TILE_B, &tp, k0 + TK, qt * TK, h, p_bar + (c & 1));
    }
  };

  if (tid == 0) {
    for (int i = 0; i < NBAR; ++i) mbar_init(bars + i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {                // k and v of the head, step by step
    for (int j = 0; j < nst; ++j) {
      mbar_expect(kv_bar + j, 4 * TILE_B);
      for (int i = 2 * j; i < 2 * j + 2; ++i) {
        tma_rows(smem + SM_K + i * TILE_B, &tk, h, i * TK, b, kv_bar + j);
        tma_rows(smem + SM_V + i * TILE_B, &tv, h, i * TK, b, kv_bar + j);
      }
    }
  }
  if (wg >= nkt) return;         // no query tile
  if (wtid == 0) {
    load_q(0);
    load_q(1);
    load_p(0);
  }

  // the scores in log2 units are (s + 8 g·P)·c1: 1/√D = 1/8 exactly
  const float c1 = LOG2E / sqrtf((float)HD);
  const float gscale = sqrtf((float)HD);
  // the gate of the thread's rows g and g + 8 of its warp's 16 in query
  // tile qt; a pass reads the next pass's
  auto gate_of = [&](int qt, __nv_bfloat16 (&graw)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      graw[r] = gh[min(qt * TK + warp * 16 + g + 8 * r, len - 1) * gl];
  };
  __nv_bfloat16 graw[2], gnext[2];
  gate_of(wg, gnext);
  int c = 0;                     // the warpgroup's step, over its passes

  for (int pass = 0; wg + WGS * pass < nkt; ++pass) {
    const int qt = wg + WGS * pass;
#pragma unroll
    for (int r = 0; r < 2; ++r) graw[r] = gnext[r];
    if (qt + WGS < nkt) gate_of(qt + WGS, gnext);
    int row[2];
    float g8[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row[r] = qt * TK + warp * 16 + g + 8 * r;
      g8[r] = row[r] < len ? __bfloat162float(graw[r]) * gscale : 0.f;
    }
    const uint32_t q_a = smem_addr(q_s + (pass & 1) * TILE_B);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    float o[8][4], sc[16][4];
    uint32_t a[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

    // the step's k and v have landed; every thread has read P's other
    // buffer, which now takes the next step's P
    auto begin_step = [&](int j) {
      mbar_wait(kv_bar + j, 0);
      wg_sync(wg);
      if (wtid == 0) load_p(c + 1);
    };
    // s = q·kᵀ of step j (keys 128 j ..): four wgmma, committed
    auto scores = [&](int j) {
      fence_operand(sc);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
        wgmma_scores(sc, desc_sw_k(q_a + kb * 32),
                     desc_sw_k(k_a + 2 * j * TILE_B + kb * 32), kb);
      wgmma_commit();
    };
    auto rescale_and_pv = [&](int j) {
      fence_operand(o);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
      fence_operand(o);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < 8; ++kb)
        wgmma_n64_reg_mn(o, a[kb],
                         desc_sw_mn(v_a + 2 * j * TILE_B + kb * 2048));
      wgmma_commit();
    };
    // step j's softmax in place: sc becomes the weights p (float32), m,
    // l and alpha move on. P comes from the swizzled buffer: row r's
    // 16-byte chunk u sits at chunk u ^ (r & 7), and r & 7 = g.
    auto softmax = [&](int j) {
      mbar_wait(p_bar + (c & 1), (c >> 1) & 1);
      const unsigned char* pb = p_s + (c & 1) * 2 * TILE_B;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const unsigned char* prow = pb + (warp * 16 + g + 8 * r) * SWROW;
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          const float2 pv = unpack_bf16(*reinterpret_cast<const uint32_t*>(
              prow + (n >> 3) * TILE_B + (((n & 7) ^ g) << 4) + 4 * t));
          sc[n][2 * r] = fmaf(g8[r], pv.x, sc[n][2 * r]);
          sc[n][2 * r + 1] = fmaf(g8[r], pv.y, sc[n][2 * r + 1]);
        }
      }
      if ((j + 1) * SK > len) {  // the ragged last step
#pragma unroll
        for (int n = 0; n < 16; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j * SK + 8 * n + 2 * t + (e & 1) >= len)
              sc[n][e] = -INFINITY;
      }
      float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[n & 1][e >> 1] = fmaxf(mx[n & 1][e >> 1], sc[n][e]);
      float mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = fmaxf(mx[0][r], mx[1][r]);
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float mn = fmaxf(m[r], x);
        alpha[r] = ex2((m[r] - mn) * c1);        // 0 on the first step
        m[r] = mn;
        mc[r] = mn * c1;
      }
      float ls[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] = ex2(fmaf(sc[n][e], c1, -mc[e >> 1]));
          ls[n & 1][e >> 1] += sc[n][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[0][r] + ls[1][r];
      ++c;
    };
    // the weights as the A fragments of o += p·v: k-block kb holds
    // n-blocks 2 kb and 2 kb + 1
    auto to_operand = [&]() {
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          a[n >> 1][(n & 1) * 2 + r] =
              pack_bf16(sc[n][2 * r], sc[n][2 * r + 1]);
    };

    // FlashAttention-3's order: issue s_j, rescale o, issue o += p_{j-1}
    // ·v_{j-1}, wait for s_j and run its softmax while p·v runs, then
    // wait for p·v and make p_j the next A operand
    mbar_wait(q_bar + (pass & 1), (pass >> 1) & 1);
    begin_step(0);
    scores(0);
    wgmma_wait<0>();
    fence_operand(sc);
    softmax(0);
    to_operand();
    for (int j = 1; j < nst; ++j) {
      begin_step(j);
      scores(j);
      rescale_and_pv(j - 1);
      wgmma_wait<1>();           // s_j
      fence_operand(sc);
      softmax(j);
      wgmma_wait<0>();           // p_{j-1}·v_{j-1}: a is free
      fence_operand(o);
      to_operand();
    }
    rescale_and_pv(nst - 1);
    wgmma_wait<0>();
    fence_operand(o);
    // this pass's query buffer is read: it takes the pass after next
    wg_sync(wg);
    if (wtid == 0) load_q(pass + 2);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (row[r] >= len) continue;
      const float inv = 1.f / l[r];
      __nv_bfloat16* orow =
          out + (((long long)b * len + row[r]) * H + h) * HD + 2 * t;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) =
            pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
  }
}

__global__ void __launch_bounds__(F_ROWS)
rel_attention_fma_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ gate,
                         const float* __restrict__ bias,
                         float* __restrict__ out, Strides s, int H, int len) {
  __shared__ __align__(16) float ks[F_KEYS][HD];
  __shared__ __align__(16) float vs[F_KEYS][HD];
  const int tiles = (len + F_ROWS - 1) / F_ROWS;
  const int bh = blockIdx.x / tiles, b = bh / H, h = bh % H;
  const int row = (blockIdx.x % tiles) * F_ROWS + threadIdx.x;
  const int rc = min(row, len - 1);
  const float* kh = k + b * s.kb + h * s.kh;
  const float* vh = v + b * s.vb + h * s.vh;
  const float* qrow = q + b * s.qb + h * s.qh + rc * s.ql;
  const float* prow = bias + h * s.ph + rc * s.pi;
  const float gv = gate[b * s.gb + h * s.gh + rc * s.gl];
  const float scale = 1.f / sqrtf((float)HD);
  float qv[HD], o[HD];
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(qrow + d);
    qv[d] = x.x; qv[d + 1] = x.y; qv[d + 2] = x.z; qv[d + 3] = x.w;
  }
#pragma unroll
  for (int d = 0; d < HD; ++d) o[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < len; k0 += F_KEYS) {
    __syncthreads();             // the last tile is read
    for (int i = threadIdx.x; i < F_KEYS * HD / 4; i += F_ROWS) {
      const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
      const bool in = k0 + r < len;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(&ks[r][c]) =
          in ? *reinterpret_cast<const float4*>(kh + (k0 + r) * s.kl + c)
             : zero;
      *reinterpret_cast<float4*>(&vs[r][c]) =
          in ? *reinterpret_cast<const float4*>(vh + (k0 + r) * s.vl + c)
             : zero;
    }
    __syncthreads();
    const int nk = min(F_KEYS, len - k0);
    float sc[F_KEYS];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < F_KEYS; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc = fmaf(qv[d], ks[j][d], acc);
      sc[j] = j < nk ? fmaf(acc, scale, gv * prow[k0 + j]) : -INFINITY;
      mx = fmaxf(mx, sc[j]);
    }
    const float mn = fmaxf(m, mx), alpha = expf(m - mn);
    m = mn;
    l *= alpha;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] *= alpha;
#pragma unroll
    for (int j = 0; j < F_KEYS; ++j) {
      const float p = expf(sc[j] - mn);
      l += p;
#pragma unroll
      for (int d = 0; d < HD; ++d) o[d] = fmaf(p, vs[j][d], o[d]);
    }
  }
  if (row >= len) return;
  const float inv = 1.f / l;
  float* orow = out + (((long long)b * len + row) * H + h) * HD;
#pragma unroll
  for (int d = 0; d < HD; d += 4)
    *reinterpret_cast<float4*>(orow + d) =
        make_float4(o[d] * inv, o[d + 1] * inv, o[d + 2] * inv,
                    o[d + 3] * inv);
}

// a bf16 map with 128-byte swizzle, zeros past its ends
bool encode(CUtensorMap* map, int rank, const void* base,
            const cuuint64_t* dims, const cuuint64_t* strides_bytes,
            const cuuint32_t* box) {
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  EncodeTiled fn = encoder();
  return fn && fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                  const_cast<void*>(base), dims, strides_bytes, box, ones,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// q, k or v (B, H, L, 64) in the model's layout, through its strides:
// dims (d, heads, rows, batch), boxes of one head's 64 rows
bool encode_rows(CUtensorMap* map, const void* base, int B, int H, int len,
                 long long sb, long long sh, long long sl) {
  const cuuint64_t dims[4] = {HD, cuuint64_t(H), cuuint64_t(len),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(2 * sh), cuuint64_t(2 * sl),
                                 cuuint64_t(2 * sb)};
  const cuuint32_t box[4] = {HD, 1, TK, 1};
  return encode(map, 4, base, dims, strides, box);
}

int launch_mma(const void* q, const void* k, const void* v, const void* gate,
               const void* bias, void* out, const Strides& s, int B, int H,
               int len, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(rel_attention_mma_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         ATT_SMEM);
    configured = true;
  }
  CUtensorMap tq, tk, tv, tp;
  const cuuint64_t pdims[3] = {cuuint64_t(len), cuuint64_t(len),
                               cuuint64_t(H)};
  const cuuint64_t pstrides[2] = {cuuint64_t(2 * s.pi),
                                  cuuint64_t(2 * s.ph)};
  const cuuint32_t pbox[3] = {TK, TK, 1};
  if (!encode_rows(&tq, q, B, H, len, s.qb, s.qh, s.ql) ||
      !encode_rows(&tk, k, B, H, len, s.kb, s.kh, s.kl) ||
      !encode_rows(&tv, v, B, H, len, s.vb, s.vh, s.vl) ||
      !encode(&tp, 3, bias, pdims, pstrides, pbox))
    return (int)cudaErrorInvalidValue;
  rel_attention_mma_kernel<<<B * H, NTH, ATT_SMEM, stream>>>(
      tq, tk, tv, tp, static_cast<const __nv_bfloat16*>(gate),
      static_cast<__nv_bfloat16*>(out), s.gb, s.gh, s.gl, H, len);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0: float32 (FMA body), 1: bfloat16 (wgmma body, len <= 512; the
// wrapper's launch_plan lays the inputs out for its maps: rows on 16
// bytes, q, k and v in the model's layout).
// strides: the 14 element strides of Strides, in its order. Returns a
// cudaError_t.
extern "C" int bsed_rel_attention(const void* q, const void* k, const void* v,
                                  const void* gate, const void* bias,
                                  void* out, int dtype, int B, int H, int len,
                                  int D, const long long* strides,
                                  void* stream) {
  if (D != HD || B < 0 || H <= 0 || len < 0 || dtype < 0 || dtype > 1 ||
      (dtype == 1 && len > MAX_KEYS))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || len == 0) return (int)cudaGetLastError();
  const Strides s = {strides[0], strides[1], strides[2],  strides[3],
                     strides[4], strides[5], strides[6],  strides[7],
                     strides[8], strides[9], strides[10], strides[11],
                     strides[12], strides[13]};
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_mma(q, k, v, gate, bias, out, s, B, H, len, st);
  const int tiles = (len + F_ROWS - 1) / F_ROWS;
  rel_attention_fma_kernel<<<B * H * tiles, F_ROWS, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(gate),
      static_cast<const float*>(bias), static_cast<float*>(out), s, H, len);
  return (int)cudaGetLastError();
}
