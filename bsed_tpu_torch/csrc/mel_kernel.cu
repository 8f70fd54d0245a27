// Kernel K1: raw audio -> linear mel, one pass (sm_90a, float32 FMA).
//
// Replaces the TPU kernel bsed_tpu/ops/mel_kernel.py:fused_block_mel
// (body _mel_kernel). Wrapper and plain version:
// bsed_tpu_torch/ops/mel_kernel.py.
//
// Math (bsed_tpu_torch/ops/mel.py block_dft_bases): with hop blocks
// x_m[r] = sig[m*H + r],
//   Y[m, pl, k] = sum_r x_m[r] * e[r, pl, k]              (pl = 2p + c)
//   Re X[t, k]  = tail_re + sum_{j<8} sum_pl d_re[j, pl, k] * Y[t+j, pl, k]
//   Im X[t, k]  = tail_im + sum_{j<8} sum_pl d_im[j, pl, k] * Y[t+j, pl, k]
//   tail[t, c, k] = sum_{r<rem} x_{t+8}[r] * e_tail[r, c, k]
//   mel[t, m]   = sum_k |X[t, k]| * fb[k, m]
//
// Bound on the H100: operations (~4.5 GFLOP per 10 s clip against ~2 MB
// of device-memory traffic). Design: one thread block owns TT frames of
// one clip and loops over KC-bin chunks of the live spectrum. Per chunk:
//   1. stage-1 product for the MW = TT + 8 hop blocks the frames touch:
//      a (MW x 256) @ (256 x 6*KC) product through shared-memory tiles of
//      RC basis rows, each thread holding a 4-row x 6-plane x 2-bin tile;
//   2. the 8-tap recombination and the tail term, read from shared memory;
//   3. |X| into shared memory, then the mel projection of the chunk,
//      accumulated for all TT x 128 outputs in registers.
// Only the mel is written back; the stage-1 tensor never leaves the SM.
#include <cuda_runtime.h>

namespace {

constexpr int TT = 56;        // output frames per block (TILE_T in Python)
constexpr int J = 8;          // full-block taps (N // H)
constexpr int MW = TT + J;    // hop blocks a block transforms (64)
constexpr int KC = 32;        // bins per chunk (BIN_CHUNK in Python)
constexpr int RC = 16;        // basis rows per stage-1 step
constexpr int ROWS = 256;     // basis rows (a hop block padded to 256)
constexpr int NPL = 6;        // planes: 3 rank terms x (re, im)
constexpr int MAXM = 128;     // mels
constexpr int NT = 256;       // threads per block
constexpr int FPT = TT / 8;   // frames per thread in the mel tile (7)

struct Smem {
  float a[RC][MW + 4];        // hop-block samples, transposed (padded rows)
  float e[RC][NPL][KC];       // stage-1 basis rows of this step
  float y[MW][NPL][KC];       // stage-1 result of this chunk
  float d[2][J][NPL][KC];     // recombination coefficients (re, im)
  float mag[TT][KC];          // |X| of this chunk
  float fb[KC][MAXM];         // filterbank rows of this chunk
};

__global__ void __launch_bounds__(NT, 2)
mel_kernel(const float* __restrict__ sig, const float* __restrict__ e,
           const float* __restrict__ d_re, const float* __restrict__ d_im,
           const float* __restrict__ e_tail, const float* __restrict__ fb,
           float* __restrict__ out, int sig_len, int T, int bins,
           int n_mels, int hop, int rem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  // hop block t0 of clip b; every read below stays inside sig_len
  const float* x = sig + (size_t)b * sig_len + (size_t)t0 * hop;

  const int rg = tid / 16, cg = tid % 16;   // stage-1: rows rg*4.., bins cg*2..
  const int tg = tid / 32, mc = tid % 32;   // mel: frames tg*FPT.., mels mc*4..
  const int kr = tid % KC;                  // recombination: bin kr
  float acc_mel[FPT][4] = {};

  for (int k0 = 0; k0 < bins; k0 += KC) {
    float acc[4][NPL][2] = {};
    for (int r0 = 0; r0 < ROWS; r0 += RC) {
      for (int i = tid; i < RC * MW; i += NT) {
        const int rr = i % RC, m = i / RC;
        s.a[rr][m] = x[(size_t)m * hop + r0 + rr];
      }
      for (int i = tid; i < RC * NPL * (KC / 4); i += NT) {
        const int k4 = i % (KC / 4);
        const int pl = (i / (KC / 4)) % NPL;
        const int rr = i / ((KC / 4) * NPL);
        const float4 v = *reinterpret_cast<const float4*>(
            e + ((size_t)(r0 + rr) * NPL + pl) * bins + k0 + k4 * 4);
        *reinterpret_cast<float4*>(&s.e[rr][pl][k4 * 4]) = v;
      }
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < RC; ++rr) {
        const float4 av = *reinterpret_cast<const float4*>(&s.a[rr][rg * 4]);
        const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int pl = 0; pl < NPL; ++pl) {
          const float2 ev =
              *reinterpret_cast<const float2*>(&s.e[rr][pl][cg * 2]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][pl][0] = fmaf(a4[i], ev.x, acc[i][pl][0]);
            acc[i][pl][1] = fmaf(a4[i], ev.y, acc[i][pl][1]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int pl = 0; pl < NPL; ++pl)
        *reinterpret_cast<float2*>(&s.y[rg * 4 + i][pl][cg * 2]) =
            make_float2(acc[i][pl][0], acc[i][pl][1]);
    for (int i = tid; i < 2 * J * NPL * (KC / 4); i += NT) {
      const int k4 = i % (KC / 4);
      const int jp = (i / (KC / 4)) % (J * NPL);
      const int part = i / ((KC / 4) * J * NPL);
      const float* src = part == 0 ? d_re : d_im;
      *reinterpret_cast<float4*>(&s.d[part][jp / NPL][jp % NPL][k4 * 4]) =
          *reinterpret_cast<const float4*>(src + (size_t)jp * bins + k0 +
                                           k4 * 4);
    }
    for (int i = tid; i < KC * (MAXM / 4); i += NT) {
      const int m4 = i % (MAXM / 4), kk = i / (MAXM / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m4 * 4 < n_mels)
        v = *reinterpret_cast<const float4*>(fb + (size_t)(k0 + kk) * n_mels +
                                             m4 * 4);
      *reinterpret_cast<float4*>(&s.fb[kk][m4 * 4]) = v;
    }
    __syncthreads();

    // recombination + tail + magnitude: bin kr, frames tid/KC + 8*i
    for (int i = 0; i < TT / 8; ++i) {
      const int t = tid / KC + 8 * i;
      float xr = 0.f, xi = 0.f;
      const float* xt = x + (size_t)(t + J) * hop;
      for (int r = 0; r < rem; ++r) {
        const float sv = xt[r];
        xr = fmaf(sv, e_tail[(size_t)(r * 2) * bins + k0 + kr], xr);
        xi = fmaf(sv, e_tail[(size_t)(r * 2 + 1) * bins + k0 + kr], xi);
      }
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int pl = 0; pl < NPL; ++pl) {
          const float yv = s.y[t + j][pl][kr];
          xr = fmaf(s.d[0][j][pl][kr], yv, xr);
          xi = fmaf(s.d[1][j][pl][kr], yv, xi);
        }
      s.mag[t][kr] = sqrtf(xr * xr + xi * xi);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      const float4 f = *reinterpret_cast<const float4*>(&s.fb[kk][mc * 4]);
#pragma unroll
      for (int i = 0; i < FPT; ++i) {
        const float mg = s.mag[tg * FPT + i][kk];
        acc_mel[i][0] = fmaf(mg, f.x, acc_mel[i][0]);
        acc_mel[i][1] = fmaf(mg, f.y, acc_mel[i][1]);
        acc_mel[i][2] = fmaf(mg, f.z, acc_mel[i][2]);
        acc_mel[i][3] = fmaf(mg, f.w, acc_mel[i][3]);
      }
    }
    __syncthreads();
  }

  if (mc * 4 < n_mels) {
#pragma unroll
    for (int i = 0; i < FPT; ++i) {
      const int t = t0 + tg * FPT + i;
      if (t < T)
        *reinterpret_cast<float4*>(out + ((size_t)b * T + t) * n_mels +
                                   mc * 4) =
            make_float4(acc_mel[i][0], acc_mel[i][1], acc_mel[i][2],
                        acc_mel[i][3]);
    }
  }
}

}  // namespace

// sig: (B, sig_len) padded signal, sig_len >= (n_tiles*TT + 9)*hop + 256;
// e: (256, 6, bins); d_re, d_im: (8, 6, bins); e_tail: (rem, 2, bins);
// fb: (bins, n_mels); out: (B, T, n_mels). All float32, contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int bsed_mel_forward(const float* sig, const float* e,
                                const float* d_re, const float* d_im,
                                const float* e_tail, const float* fb,
                                float* out, int B, int sig_len, int T,
                                int n_tiles, int bins, int n_mels, int hop,
                                int rem, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(mel_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)sizeof(Smem));
    configured = true;
  }
  if (bins % KC != 0 || n_mels > MAXM || n_mels % 4 != 0 || hop >= ROWS ||
      n_tiles * TT < T)
    return (int)cudaErrorInvalidValue;
  dim3 grid(n_tiles, B);
  mel_kernel<<<grid, NT, sizeof(Smem), (cudaStream_t)stream>>>(
      sig, e, d_re, d_im, e_tail, fb, out, sig_len, T, bins, n_mels, hop,
      rem);
  return (int)cudaGetLastError();
}
