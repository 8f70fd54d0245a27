// Kernel K5: the fused eval stem, block 0 (sm_90a, float32 FMA).
//
// Replaces the TPU kernel bsed_tpu/ops/stem_kernel.py:fused_stem_block
// (body _stem_kernel). Wrapper and plain version:
// bsed_tpu_torch/ops/stem_kernel.py.
//
// For log-mel x (B, T, 128) and the folded parameters (fold_block0_params:
// BatchNorm and the GLU dense folded into two 3x3 single-channel convs):
//   gate[t,f,o] = sum_{dt,df} xpad[t+dt, f+df] * w_gate[dt,df,o] + b_gate[o]
//   lin[t,f,o]  = sum_{dt,df} xpad[t+dt, f+df] * w_lin[dt,df,o]  + b_lin[o]
//   act = lin * sigmoid(gate)
//   out[t',f',o] = 0.25 * (act[2t',2f'] + act[2t',2f'+1]
//                          + act[2t'+1,2f'] + act[2t'+1,2f'+1])
// with xpad zero at t = -1, t = T, f = -1 and f = 128 (the conv's padding)
// and T' = T // 2 (floor: with odd T the last input row enters only as the
// conv halo of row T - 2, never as a pooled input).
//
// Bound on the H100: operations, 672 FLOP per conv pixel (18 FMAs and a
// sigmoid a channel) against 20 bytes of traffic; at B=64, T=1255 the FMA
// pipe needs ~0.09 ms and the sigmoids' two MUFU operations each ~0.08 ms
// of theirs, the bytes ~0.06 ms. Design, so that the instruction slots go to
// the FMAs:
//   * persistent blocks of 512 threads, one an SM, walk over work items
//     (clip, RT = 16 pooled rows); the item's (2 RT + 2) x 130 halo tile
//     of x arrives by cp.async into a 2-deep ring in shared memory while
//     the previous item computes (rows outside the clip zero-filled by the
//     copy itself, columns f = -1 and 128 zeroed once);
//   * a thread owns CG = 2 channels of one pooled column f' (thread =
//     8 f' + c / 2, so a warp's outputs are 256 contiguous bytes): their
//     2 x 9 x 2 taps and 4 biases sit in registers for the whole run, and
//     the thread walks down the item's rows carrying its 4 x 4 input
//     window, two new rows a pooled row;
//   * the sigmoid is ex2.approx and rcp.approx (two MUFU operations, a few
//     ulp): the gate's taps and bias carry the factor -log2(e), so the
//     gate's accumulator is already the exponent; the lin taps carry the
//     pool's 0.25, which is exact.
// Measured (kernels/ablation.py --kernel stem): compute-bound, the convs'
// FMA chains take most of it; 2 channels a thread at 128 registers beat 4
// channels at two blocks an SM (128 registers, the cap) by ~6%.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int F = 128;              // mel bins
constexpr int C = 16;               // channels
constexpr int FO = F / 2;           // pooled bins
constexpr int CG = 2;               // channels a thread
constexpr int NTH = FO * (C / CG);  // threads a block (512)
constexpr int BLOCKS_PER_SM = 1;
constexpr int RT = 16;              // pooled rows a work item
constexpr int HR = 2 * RT + 2;      // staged input rows a work item
constexpr int RS = 136;             // floats a staged row: f at 4 + f
constexpr int STAGE = HR * RS;      // floats a stage of the ring
constexpr int SMEM = 2 * STAGE * 4; // bytes of the ring
constexpr int WG = 0, WL = 9 * C, BG = 18 * C, BL = 19 * C;
constexpr float NEG_LOG2E = -1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared; zero-filled when !valid (src is not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// sigmoid(g) from e = -g * log2(e): 1 / (1 + 2^e) on the MUFU unit
__device__ __forceinline__ float sigmoid_ex2(float e) {
  float p, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(p) : "f"(e));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + p));
  return r;
}

// columns f = 2 f' - 1 .. 2 f' + 2 of a staged row (row points at f = -1)
__device__ __forceinline__ void load_row(float (&w)[4], const float* row) {
  const float2 mid = *reinterpret_cast<const float2*>(row + 1);
  w[0] = row[0];
  w[1] = mid.x;
  w[2] = mid.y;
  w[3] = row[3];
}

// a thread's CG channels of one pooled position, one store
static_assert(CG == 2, "store_out writes a float2");
__device__ __forceinline__ void store_out(float* p, const float (&v)[CG]) {
  __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
}

__global__ void __launch_bounds__(NTH, BLOCKS_PER_SM)
stem_kernel(const float* __restrict__ x, const float* __restrict__ prm,
            float* __restrict__ out, int B, int T, int To) {
  extern __shared__ __align__(16) float ring[];
  const int tid = threadIdx.x;
  const int fo = tid / (C / CG), c0 = (tid % (C / CG)) * CG;

  float wg[9][CG], wl[9][CG], bg[CG], bl[CG];
#pragma unroll
  for (int c = 0; c < CG; ++c) {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      wg[k][c] = prm[WG + k * C + c0 + c] * NEG_LOG2E;
      wl[k][c] = prm[WL + k * C + c0 + c] * 0.25f;
    }
    bg[c] = prm[BG + c0 + c] * NEG_LOG2E;
    bl[c] = prm[BL + c0 + c] * 0.25f;
  }
  for (int i = tid; i < 2 * HR; i += NTH) {   // the padding columns
    ring[i * RS + 3] = 0.f;
    ring[i * RS + 4 + F] = 0.f;
  }

  const int tiles = (To + RT - 1) / RT;
  const int items = B * tiles;
  auto stage = [&](int item, int s) {
    const int bi = item / tiles;
    const int r0 = 2 * ((item % tiles) * RT) - 1;   // first halo row
    const float* xb = x + (size_t)bi * T * F;
    float* st = ring + s * STAGE + 4;
    for (int i = tid; i < HR * (F / 4); i += NTH) {
      const int r = i / (F / 4), q = i % (F / 4), t = r0 + r;
      const bool inside = t >= 0 && t < T;
      cp_async16(st + r * RS + 4 * q, inside ? xb + (size_t)t * F + 4 * q : x,
                 inside);
    }
    cp_async_commit();
  };

  int s = 0;
  if (blockIdx.x < items) stage(blockIdx.x, 0);
  for (int item = blockIdx.x; item < items; item += gridDim.x, s ^= 1) {
    cp_async_wait_all();
    __syncthreads();          // this item landed; the other stage is free
    if (item + gridDim.x < items) stage(item + gridDim.x, s ^ 1);

    const int bi = item / tiles, t0 = (item % tiles) * RT;
    const int rows = min(RT, To - t0);
    const float* st = ring + s * STAGE + 3 + 2 * fo;   // f = 2 f' - 1
    float* dst = out + (((size_t)bi * To + t0) * FO + fo) * C + c0;
    float win[4][4];
    load_row(win[0], st);
    load_row(win[1], st + RS);
#pragma unroll 2
    for (int r = 0; r < rows; ++r) {
      load_row(win[2], st + (2 * r + 2) * RS);
      load_row(win[3], st + (2 * r + 3) * RS);
      float res[CG];
#pragma unroll
      for (int c = 0; c < CG; ++c) {
        float acc = 0.f;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            float g = bg[c], l = bl[c];
#pragma unroll
            for (int kt = 0; kt < 3; ++kt)
#pragma unroll
              for (int kf = 0; kf < 3; ++kf) {
                const float v = win[dy + kt][dx + kf];
                g = fmaf(v, wg[kt * 3 + kf][c], g);
                l = fmaf(v, wl[kt * 3 + kf][c], l);
              }
            acc += l * sigmoid_ex2(g);
          }
        res[c] = acc;
      }
      store_out(dst + (size_t)r * FO * C, res);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        win[0][b] = win[2][b];
        win[1][b] = win[3][b];
      }
    }
  }
}

}  // namespace

// Dynamic shared memory of one block (the 2-deep ring of halo tiles).
extern "C" int bsed_stem_smem_bytes() { return SMEM; }

// x: (B, T, 128) float32 log-mel; prm: the 320 folded parameters, float32,
// in the order w_gate (3, 3, 16), w_lin (3, 3, 16), b_gate (16), b_lin (16);
// out: (B, To, 64, 16) float32 with To = T // 2; all 16-byte aligned.
// Returns cudaGetLastError().
extern "C" int bsed_stem_block(const float* x, const float* prm, float* out,
                               int B, int T, int To, void* stream) {
  if (B < 0 || T < 0 || To != T / 2 ||
      (long)B * ((To + RT - 1) / RT) > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || To == 0) return (int)cudaGetLastError();
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(stem_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    configured = true;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long items = (long)B * ((To + RT - 1) / RT);
  const long slots = (long)BLOCKS_PER_SM * sms;
  const int grid = (int)(items < slots ? items : slots);
  stem_kernel<<<grid, NTH, SMEM, (cudaStream_t)stream>>>(x, prm, out, B, T,
                                                         To);
  return (int)cudaGetLastError();
}
