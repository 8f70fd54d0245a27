// BEATs' position convolution with its residual in one kernel (sm_90a):
// y = x + GELU(conv(x) + bias), conv the grouped Conv1d(d, d, K taps,
// groups) over the tokens, zero-padded K/2 (rounded down) on each side:
// output t = sum_k w[k] x[t + k - K/2] for t < L (BEATs' SamePad drops the
// convolution's last output at even K).
//
// Replaces no TPU kernel: bsed_tpu has no BEATs (the crnn_beats
// configuration exists only in the port). The port ran cuDNN's TF32
// grouped convolution on a float32 transposed copy of x, then GELU, a cast
// and the add, each a pass over device memory. Wrapper and plain version:
// bsed_tpu_torch/ops/pos_conv.py.
//
// Bound on the H100: operations. At B=64, L=496, d=768 in 16 groups of 48,
// 128 taps, a call is 2·B·L·d·(d/g)·K = 0.300 TFLOP (0.303 ms at 989
// TFLOP/s bf16) over ~107 MB (x in, y out, 9.4 MB of bf16 weights: 0.03
// ms at 3.35 TB/s). So the kernel is built around the tensor cores.
//
// bfloat16 body (pos_conv_mma_kernel): an implicit GEMM for each (clip,
// group, chunk of NC output channels, tile of TOK tokens), M = tokens, N =
// NC (48, or 16 where 48 does not divide d/g), K = taps × d/g, in the
// order k·(d/g) + c. No im2col buffer:
//   * The block loads its group's slab of x once, by TMA: rows t0 − K/2 ..
//     t0 + TOK + K/2 (zeros past either end of the clip, the TMA's
//     out-of-bounds fill), chunk-major: 8 channels (16 bytes) a row, the
//     rows of one chunk contiguous. Row t of A is the slab read on from
//     row t, A[t, k·(d/g) + c] = slab[t + k][c], so the 8 rows of any
//     wgmma core matrix of A (8 rows × 16 bytes) are 128 contiguous bytes
//     whatever t and k: wgmma reads A from shared memory by descriptor, no
//     swizzle (leading offset: one chunk's rows; stride offset: 128
//     bytes), with no registers, ldmatrix or copy in between.
//   * The weights, re-laid once by the wrapper into the same core-matrix
//     layout stage by stage (ops/pos_conv.pack_weight), stream from L2 by
//     1-D bulk copies into a ring of RING stages of 128 K-elements, filled
//     by one producer warp (full / empty mbarriers).
//   * Two consumer warpgroups own 4 m-tiles of 64 tokens each: a stage is
//     8 k16 slices × 4 wgmma.m64nNCk16 a warpgroup, committed as one
//     group; each warp frees a stage once its wait shows the group that
//     read it done. Sums are float32 in registers (96 a thread at NC =
//     48). Slices past K (the last stage's padding, zero weights) read the
//     last real slice's rows.
//   * Epilogue in registers: sum + bias, erf GELU (F.gelu's), + x taken
//     from the slab (no global read), rounded once to bf16 and stored.
// float32 body (pos_conv_fma_kernel): FMA, no TF32, any channel count a
// group, any K that shared memory holds: a block takes 32 tokens × 16
// output channels of a (clip, group); x passes through shared memory in
// chunks of channels; the weights are read as given, (d, d/g, K).
#include "tma_common.cuh"

namespace {

constexpr int TOK = 512;                   // tokens a block (bf16 body)
constexpr int MT = 4;                      // m-tiles of 64 a warpgroup
constexpr int WGS = 2;                     // consumer warpgroups
constexpr int NTH = 128 * WGS + 32;        // + the producer warp
constexpr int SPS = 8;                     // k16 slices a stage
constexpr int STAGE_K = 16 * SPS;          // K-elements a stage
constexpr int RING = 6;                    // stages in the ring
constexpr int SLAB_BOX = 128;              // slab rows a TMA box
constexpr int SMEM_MAX = 232448;           // dynamic shared memory a block

constexpr int F_TT = 32;                   // float32 body: tokens a block
constexpr int F_COW = 4;                   // output channels a warp
constexpr int F_CO = 4 * F_COW;            // output channels a block
constexpr int F_SMEM = 48 * 1024;          // its x tile, at most

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// rows of one 8-channel chunk of x into the slab: a box of a 4-d map
// (8 elements, chunk, row, clip)
__device__ __forceinline__ void tma_slab(void* dst, const CUtensorMap* map,
                                         int chunk, int row, int clip,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(chunk), "r"(row),
      "r"(clip), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// d (64 x NC) += a (64 x 16) · b (16 x NC), both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[6][4], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3])
      : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[2][4], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "l"(a), "l"(b), "r"(1));
}

// Keeps the compiler from moving the accumulators' registers while a
// wgmma that writes them may be in flight.
template <int NB>
__device__ __forceinline__ void fence_acc(float (&d)[MT][NB][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        asm volatile("" : "+f"(d[m][n][e])::"memory");
}

// One block a (clip, group, chunk, token tile), blockIdx.x in that order
// from the slowest. rows: slab rows, a multiple of SLAB_BOX, at least TOK +
// taps − 1; stages: the weight stages of a chunk (taps·cg / STAGE_K,
// rounded up).
template <int NC>
__global__ void __launch_bounds__(NTH, 1)
pos_conv_mma_kernel(const __grid_constant__ CUtensorMap tx,
                    const __nv_bfloat16* __restrict__ wp,
                    const __nv_bfloat16* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, int len, int d, int cg,
                    int taps, int tiles, int rows, int stages) {
  constexpr int NB = NC / 8;               // n-blocks of 8 channels
  constexpr int STAGE_B = STAGE_K * NC * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int slab_b = cg * rows * 2;
  unsigned char* ring = smem + slab_b;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + RING * STAGE_B);
  uint64_t* empty = full + RING;
  uint64_t* slab_bar = empty + RING;
  const int tid = threadIdx.x;
  const int chunks = cg / NC, groups = d / cg, pad = taps / 2;
  int bid = blockIdx.x;
  const int tile = bid % tiles;
  bid /= tiles;
  const int nc = bid % chunks;
  bid /= chunks;
  const int g = bid % groups, b = bid / groups;
  const int t0 = tile * TOK;

  if (tid == 0) {
    for (int i = 0; i < RING; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4 * WGS);     // every consumer warp
    }
    mbar_init(slab_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128 * WGS) {        // the producer warp: one thread issues
    if (tid == 128 * WGS) {
      mbar_expect(slab_bar, slab_b);
      for (int c = 0; c < cg / 8; ++c)
        for (int r = 0; r < rows; r += SLAB_BOX)
          tma_slab(smem + (c * rows + r) * 16, &tx, g * (cg / 8) + c,
                   t0 - pad + r, b, slab_bar);
      const unsigned char* src = reinterpret_cast<const unsigned char*>(wp) +
                                 (size_t)(g * chunks + nc) * stages * STAGE_B;
      for (int st = 0; st < stages; ++st) {
        const int slot = st % RING;
        if (st >= RING) mbar_wait(empty + slot, (st / RING - 1) & 1);
        mbar_expect(full + slot, STAGE_B);
        bulk_copy(ring + slot * STAGE_B, src + (size_t)st * STAGE_B, STAGE_B,
                  full + slot);
      }
    }
    return;
  }

  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  float acc[MT][NB][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  // K-major, no swizzle: A's core matrices one chunk's rows apart along K
  // and 8 rows (128 bytes) apart along M; B's NC rows of 16 bytes apart
  // along K and 128 bytes apart along N. A descriptor moves by adding
  // its start in 16-byte units.
  const uint64_t da = smem_desc(smem_addr(smem), rows * 16, 128);
  const uint64_t db = smem_desc(smem_addr(ring), NC * 16, 128);
  const int last = taps * cg / 16 - 1;     // the last real k16 slice
  const int m0 = 64 * MT * wg;             // the warpgroup's first token

  mbar_wait(slab_bar, 0);
  for (int st = 0; st < stages; ++st) {
    const int slot = st % RING;
    mbar_wait(full + slot, (st / RING) & 1);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < SPS; ++s) {
      const int kk = min(st * SPS + s, last) * 16;
      const int k = kk / cg, c8 = (kk - k * cg) >> 3;
      const uint64_t a = da + (uint64_t)(c8 * rows + m0 + k);
      const uint64_t bd = db + (uint64_t)((slot * STAGE_B + s * NC * 32) >> 4);
#pragma unroll
      for (int m = 0; m < MT; ++m) wgmma_ss(acc[m], a + 64 * m, bd);
    }
    wgmma_commit();
    wgmma_wait<1>();             // the stage before is read: free its slot
    fence_acc(acc);
    if (st > 0 && lane == 0) mbar_arrive(empty + (st - 1) % RING);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // thread (warp, g8, t4) holds rows 16 warp + g8 (+ 8) of each m-tile at
  // columns 8 n + 2 t4 (+ 1) of the chunk
  const int co0 = g * cg + nc * NC;
  float2 bv[NB];
#pragma unroll
  for (int n = 0; n < NB; ++n)
    bv[n] = unpack_bf16(
        *reinterpret_cast<const uint32_t*>(bias + co0 + 8 * n + 2 * t4));
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 64 * m + 16 * warp + g8 + 8 * r;
      if (t0 + row >= len) continue;
      const unsigned char* xr = smem + (row + pad) * 16 + 4 * t4;
      __nv_bfloat16* orow = out + ((size_t)b * len + t0 + row) * d + co0 +
                            2 * t4;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(
            xr + (nc * NB + n) * rows * 16));
        *reinterpret_cast<uint32_t*>(orow + 8 * n) =
            pack_bf16(xv.x + gelu(acc[m][n][2 * r] + bv[n].x),
                      xv.y + gelu(acc[m][n][2 * r + 1] + bv[n].y));
      }
    }
}

// float32: a block of 4 warps takes tokens t0 .. t0 + 31 (a lane each) and
// output channels co0 .. co0 + 15 (4 a warp) of one (clip, group); x passes
// through shared memory `cic` channels at a time, rows t0 − K/2 ..
// t0 + 31 + K/2, each channel's rows contiguous.
__global__ void __launch_bounds__(128)
pos_conv_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int len, int d, int cg, int taps, int cic) {
  extern __shared__ float xs[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = d / cg;
  const int b = blockIdx.z / groups, g = blockIdx.z % groups;
  const int t0 = blockIdx.x * F_TT, co0 = blockIdx.y * F_CO + warp * F_COW;
  const int span = F_TT + taps - 1, pad = taps / 2;
  const float* xb = x + (size_t)b * len * d + g * cg;
  float acc[F_COW];
#pragma unroll
  for (int j = 0; j < F_COW; ++j) acc[j] = 0.f;
  for (int c0 = 0; c0 < cg; c0 += cic) {
    const int n = min(cic, cg - c0);
    __syncthreads();             // the last chunk is read
    for (int i = threadIdx.x; i < n * span; i += blockDim.x) {
      const int ci = i % n, r = i / n, tok = t0 - pad + r;
      xs[ci * span + r] =
          tok >= 0 && tok < len ? xb[(size_t)tok * d + c0 + ci] : 0.f;
    }
    __syncthreads();
    for (int ci = 0; ci < n; ++ci) {
      const float* xr = xs + ci * span + lane;
#pragma unroll
      for (int j = 0; j < F_COW; ++j) {
        if (co0 + j >= cg) continue;
        const float* wr = w + ((size_t)(g * cg + co0 + j) * cg + c0 + ci) *
                                  taps;
        float a = acc[j];
        for (int k = 0; k < taps; ++k) a = fmaf(__ldg(wr + k), xr[k], a);
        acc[j] = a;
      }
    }
  }
  const int t = t0 + lane;
  if (t >= len) return;
#pragma unroll
  for (int j = 0; j < F_COW; ++j) {
    if (co0 + j >= cg) continue;
    const int c = g * cg + co0 + j;
    const size_t i = ((size_t)b * len + t) * d + c;
    out[i] = x[i] + gelu(acc[j] + bias[c]);
  }
}

// x (B, L, d) bf16, contiguous: dims (8 channels, d/8 chunks, L, B), boxes
// of SLAB_BOX rows of one chunk, zeros outside the clip
bool encode_slab(CUtensorMap* map, const void* x, int B, int len, int d) {
  const cuuint64_t dims[4] = {8, cuuint64_t(d / 8), cuuint64_t(len),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {16, cuuint64_t(2 * d),
                                 cuuint64_t(2) * d * len};
  const cuuint32_t box[4] = {8, 1, SLAB_BOX, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  EncodeTiled fn = encoder();
  return fn && fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(x), dims, strides, box, ones,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NC>
int launch_mma(const void* x, const void* w, const void* bias, void* out,
               int B, int len, int d, int cg, int taps,
               cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(pos_conv_mma_kernel<NC>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_MAX);
    configured = true;
  }
  const int rows = (TOK + taps - 1 + SLAB_BOX - 1) / SLAB_BOX * SLAB_BOX;
  const int stages = (taps * cg + STAGE_K - 1) / STAGE_K;
  const int tiles = (len + TOK - 1) / TOK;
  const int smem = cg * rows * 2 + RING * STAGE_K * NC * 2 +
                   (2 * RING + 1) * 8 + 1024;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap tx;
  if (!encode_slab(&tx, x, B, len, d)) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)B * (d / cg) * (cg / NC) * tiles;
  pos_conv_mma_kernel<NC><<<(unsigned)blocks, NTH, smem, stream>>>(
      tx, static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), len, d, cg, taps, tiles, rows,
      stages);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0: float32 (FMA body; w the weight as given, (d, d/groups, taps)),
// 1: bfloat16 (wgmma body; w re-laid by ops/pos_conv.pack_weight for
// `width` output channels a block, 48 or 16, d/groups a multiple of 16).
// x, bias and out contiguous in x's dtype, x and out (B, L, d). Returns a
// cudaError_t.
extern "C" int bsed_pos_conv(const void* x, const void* w, const void* bias,
                             void* out, int dtype, int B, int len, int d,
                             int groups, int taps, int width, void* stream) {
  if (B < 0 || len < 0 || d <= 0 || groups <= 0 || d % groups || taps <= 0 ||
      dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int cg = d / groups;
  if (dtype == 1 && (cg % 16 || (width != 48 && width != 16) || cg % width))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || len == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return width == 48
               ? launch_mma<48>(x, w, bias, out, B, len, d, cg, taps, st)
               : launch_mma<16>(x, w, bias, out, B, len, d, cg, taps, st);
  const int span = F_TT + taps - 1;
  int cic = F_SMEM / 4 / span;             // channels a pass of the x tile
  if (cic > 32) cic = 32;
  if (cic > cg) cic = cg;
  if (cic < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((len + F_TT - 1) / F_TT, (cg + F_CO - 1) / F_CO,
                  B * groups);
  pos_conv_fma_kernel<<<grid, 128, cic * span * 4, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), len, d, cg,
      taps, cic);
  return (int)cudaGetLastError();
}
