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
// Bound on the H100: operations (576 FLOP per conv pixel against 20 bytes
// of traffic). Design: one block of 256 threads owns RT = 4 pooled rows of
// one clip. It stages the (2*RT + 2) x 130 halo tile of x and the 320
// folded parameters in shared memory; each thread owns one pooled (t', f')
// for all 16 channels: its 4x4 input window sits in registers, the 2x9x16
// taps are read from shared memory as broadcasts, and its 16 outputs go out
// as one contiguous 64-byte store (adjacent threads, adjacent chunks).
#include <cuda_runtime.h>

namespace {

constexpr int F = 128;              // mel bins
constexpr int C = 16;               // channels
constexpr int FO = F / 2;           // pooled bins
constexpr int RT = 4;               // pooled rows per block
constexpr int NTH = FO * RT;        // threads per block (256)
constexpr int HR = 2 * RT + 2;      // halo tile rows
constexpr int HC = F + 2;           // halo tile columns
constexpr int NP = 2 * 9 * C + 2 * C;  // packed parameters
constexpr int WG = 0, WL = 9 * C, BG = 18 * C, BL = 19 * C;

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

__global__ void __launch_bounds__(NTH)
stem_kernel(const float* __restrict__ x, const float* __restrict__ prm,
            float* __restrict__ out, int T, int To) {
  __shared__ float tile[HR][HC];
  __shared__ float p[NP];
  const int tid = threadIdx.x;
  const int bi = blockIdx.y;
  const int to0 = blockIdx.x * RT;
  const float* xb = x + (size_t)bi * T * F;

  for (int i = tid; i < NP; i += NTH) p[i] = prm[i];
  for (int i = tid; i < HR * HC; i += NTH) {
    const int r = i / HC, c = i % HC;
    const int t = 2 * to0 - 1 + r, f = c - 1;
    tile[r][c] = (t >= 0 && t < T && f >= 0 && f < F)
                     ? xb[(size_t)t * F + f] : 0.f;
  }
  __syncthreads();

  const int tr = tid / FO, fo = tid % FO;
  const int to = to0 + tr;
  if (to >= To) return;

  float win[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) win[a][b] = tile[2 * tr + a][2 * fo + b];

  float res[C];
#pragma unroll
  for (int o = 0; o < C; ++o) {
    float act[2][2];
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        float g = 0.f, l = 0.f;
#pragma unroll
        for (int kt = 0; kt < 3; ++kt)
#pragma unroll
          for (int kf = 0; kf < 3; ++kf) {
            const float v = win[dy + kt][dx + kf];
            g = fmaf(v, p[WG + (kt * 3 + kf) * C + o], g);
            l = fmaf(v, p[WL + (kt * 3 + kf) * C + o], l);
          }
        act[dy][dx] = (l + p[BL + o]) * sigmoidf(g + p[BG + o]);
      }
    res[o] = 0.25f * (act[0][0] + act[0][1] + act[1][0] + act[1][1]);
  }
  float4* dst = reinterpret_cast<float4*>(
      out + (((size_t)bi * To + to) * FO + fo) * C);
#pragma unroll
  for (int q = 0; q < C / 4; ++q)
    dst[q] = make_float4(res[4 * q], res[4 * q + 1], res[4 * q + 2],
                         res[4 * q + 3]);
}

}  // namespace

// x: (B, T, 128) float32 log-mel; prm: the 320 folded parameters, float32,
// in the order w_gate (3, 3, 16), w_lin (3, 3, 16), b_gate (16), b_lin (16);
// out: (B, To, 64, 16) float32 with To = T // 2. Returns cudaGetLastError().
extern "C" int bsed_stem_block(const float* x, const float* prm, float* out,
                               int B, int T, int To, void* stream) {
  if (B < 0 || T < 0 || To != T / 2 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || To == 0) return (int)cudaGetLastError();
  const dim3 grid((To + RT - 1) / RT, B);
  stem_kernel<<<grid, NTH, 0, (cudaStream_t)stream>>>(x, prm, out, T, To);
  return (int)cudaGetLastError();
}
