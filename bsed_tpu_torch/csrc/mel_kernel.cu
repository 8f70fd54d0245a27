// Kernel K1: raw audio -> mel, one pass (sm_90a, float32), in two forms
// chosen at compile time (the template parameter DB of mel_fft_kernel).
//
// Replaces the TPU kernel bsed_tpu/ops/mel_kernel.py:fused_block_mel
// (body _mel_kernel) in its magnitude form. Wrapper and plain version:
// bsed_tpu_torch/ops/mel_kernel.py.
//
// Math (librosa semantics): frame t of the centre reflect-padded signal p is
// x_t[n] = p[t*H + n] * w[n], n < N (w the window table). Its real N-point
// DFT is one complex M-point FFT (M = N/2) of the even/odd packed frame
// z[n] = x[2n] + i x[2n+1], then the split step
//   X[k] = (Z[k] + conj Z[M-k]) / 2 - i/2 * W_N^k * (Z[k] - conj Z[M-k]),
//   X[M] = Re Z[0] - Im Z[0],
// then a banded sum over the filterbank: mel m reads bins start_m ..
// start_m + len_m - 1 with its own weights. The two forms:
//   * magnitude (the CRNN's; the JAX kernel's envelope N // H == 8,
//     N % H != 0, H < 256): symmetric Hamming, |X|, the Slaney bands with
//     norm=None (2016 nonzeros of the 1025 x 128 parity filterbank, 3-58
//     bins a band); the linear mel out, its per-clip dB clamp outside;
//   * power-dB (torchlibrosa's, HTS-AT's; any hop up to MAX_HOP_DB):
//     periodic Hann, |X|^2, the Slaney area-normalised bands (866
//     nonzeros of 513 x 64 at N = 1024, 3-47 bins a band), and
//     10 log10(max(mel, 1e-10)) written out: the dB is elementwise, with
//     no per-clip clamp, so it lives in the epilogue.
// Window and bands are the wrapper's tables; the code differs only in the
// power, the dB and two layouts that use idle lanes (below).
//
// Bound on the H100: ~5.1 GFLOP and ~123 MB of device memory per B=64
// batch of 10 s clips in the magnitude form at N = 2048, H = 255 (0.076 ms
// at the H100 SXM data sheet's 67 TFLOP/s f32, 700 W); ~1.6 GFLOP, 82 MB
// in and 16.4 MB out in the power-dB form at N = 1024, H = 320 (~0.03 ms
// either way). In practice the kernel is bound by shared-memory traffic
// and the latency of its in-register butterflies. Tensor cores are not
// needed. Design:
//   * a persistent block walks tiles of F = 8 consecutive frames of one
//     clip; it stages the tile's (F-1)*H + N samples once in shared memory,
//     reflect-padding in the index (frames overlap N/H times, so each
//     sample crosses device memory about once per tile);
//   * one warp owns one frame. The M-point FFT is a four-step FFT,
//     M = P x Q (1024 = 32 x 32): each lane runs a P-point FFT in registers
//     over its stride-Q column, multiplies by W_M^{j k1}, and the warp
//     transposes through a padded (Q x P+1) shared tile; each lane then
//     runs a Q-point FFT in registers. Where Q = 16 (N = 512, 1024) the
//     magnitude form runs each column's FFT twice, on lanes j and j + 16;
//     the power-dB form splits it between them instead (decimation in
//     frequency: lane half h runs the P/2-point FFT of
//     (x[a] + (-1)^h x[a + P/2]) W_P^{a h}, giving Y[2k' + h]);
//   * the split step pairs Z[k] with Z[M-k] by warp shuffles, and |X| (or
//     |X|^2) goes to shared memory in f32;
//   * 256 threads compute the F x n_mels banded sums (weights read through
//     L1) and store them coalesced into (B, T, n_mels): MS mels a pass and
//     F / (256 / MS) frames a thread, MS = 128, or 64 in the power-dB form
//     where n_mels <= 64 so that no thread idles.
// Twiddles and the window are tables built in float64 on the host and
// stored as float32: W_N^q for q < M, then W_M^{j k1} at M + k1*Q + j.
#include <cuda_runtime.h>

namespace {

constexpr int F = 8;            // frames per tile, one warp each
constexpr int NT = 32 * F;      // threads per block
constexpr int MAXM = 128;       // mels
constexpr int MAX_HOP = 255;    // magnitude form: the JAX kernel's envelope
constexpr int MAX_HOP_DB = 512;  // power-dB form: at N = 2048 the tile's
                                 // 104 KB keep two blocks an SM
constexpr float AMIN = 1e-10f;  // power_to_db's floor
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int ilog2(int v) {
  return v <= 1 ? 0 : 1 + ilog2(v / 2);
}
__host__ __device__ constexpr int bitrev(int i, int bits) {
  return bits == 0 ? 0 : ((i & 1) << (bits - 1)) | bitrev(i >> 1, bits - 1);
}

__device__ __forceinline__ void cmul(float& xr, float& xi, float wr,
                                     float wi) {
  const float r = xr * wr - xi * wi;
  xi = fmaf(xr, wi, xi * wr);
  xr = r;
}

// In-place radix-2 FFT of S points held in registers, natural order in and
// out; W_S^m = tw[m * stride] (tw[q] = e^{-2 pi i q / N}).
template <int S>
__device__ __forceinline__ void fft_reg(float (&re)[S], float (&im)[S],
                                        const float2* tw, int stride) {
  constexpr int LOG = ilog2(S);
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int j = bitrev(i, LOG);
    if (i < j) {
      const float tr = re[i], ti = im[i];
      re[i] = re[j];
      im[i] = im[j];
      re[j] = tr;
      im[j] = ti;
    }
  }
#pragma unroll
  for (int s = 0; s < LOG; ++s) {
    const int half = 1 << s;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      float2 w = make_float2(1.f, 0.f);
      if (k > 0) w = tw[k * (S / (2 * half)) * stride];
#pragma unroll
      for (int i = 0; i < S; i += 2 * half) {
        float br = re[i + k + half], bi = im[i + k + half];
        if (k > 0) cmul(br, bi, w.x, w.y);
        re[i + k + half] = re[i + k] - br;
        im[i + k + half] = im[i + k] - bi;
        re[i + k] += br;
        im[i + k] += bi;
      }
    }
  }
}

template <int P, int Q>
__host__ __device__ constexpr int work_floats() { return 2 * Q * (P + 1); }   // >= M + 1

template <int P, int Q>
constexpr size_t smem_bytes(int hop) {
  return (size_t)(2 * 2 * P * Q + F * work_floats<P, Q>() +
                  (F - 1) * hop + 2 * P * Q) * sizeof(float);
}

// DB: the power-dB form (else the magnitude form); MS: mels a pass of the
// banded sum (128, or 64 where the power-dB form has n_mels <= 64).
template <int P, int Q, bool DB, int MS>
__global__ void __launch_bounds__(NT, 2)
mel_fft_kernel(const float* __restrict__ audio,
               const float* __restrict__ window,
               const float2* __restrict__ twiddle,
               const int* __restrict__ bands,
               const float* __restrict__ weights, float* __restrict__ out,
               int n, int T, int tiles_per_clip, int total_tiles, int hop,
               int n_mels) {
  constexpr int M = P * Q, N = 2 * M, LD = P + 1;
  constexpr int WORK = work_floats<P, Q>();
  constexpr int FPT = F / (NT / MS);    // frames per thread in the mel sums
  // step 1 split between lanes j and j + 16 (decimation in frequency)
  constexpr bool SPLIT = DB && 2 * Q == 32;
  extern __shared__ __align__(16) float smem[];
  float2* tw = reinterpret_cast<float2*>(smem);          // [2M]
  float* work = smem + 4 * M;                             // [F][WORK]
  float* sig = work + F * WORK;                           // the tile's span
  const int span = (F - 1) * hop + N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < 2 * M; i += NT) tw[i] = twiddle[i];
  float* are = work + warp * WORK;         // transpose tile, then |X|
  float* aim = are + Q * LD;
  const int j = lane % Q;                  // step-1 column
  const int k1 = lane % P;                 // step-2 column
  const int mel = tid % MS, fg = tid / MS;
  int b_start = 0, b_len = 0, b_off = 0;
  if (mel < n_mels) {
    b_start = bands[3 * mel];
    b_len = bands[3 * mel + 1];
    b_off = bands[3 * mel + 2];
  }

  for (int tile = blockIdx.x; tile < total_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_clip;
    const int t0 = (tile - b * tiles_per_clip) * F;
    const float* x = audio + (size_t)b * n;
    __syncthreads();           // the last tile's sums have read |X|
    const int q0 = t0 * hop - N / 2;
    for (int i = tid; i < span; i += NT) {
      int s = q0 + i;                           // centre reflect pad
      s = s < 0 ? -s : s;
      s = s >= n ? 2 * (n - 1) - s : s;
      sig[i] = (s >= 0 && s < n) ? x[s] : 0.f;  // past the end: frames >= T
    }
    __syncthreads();

    // step 1: lane j, P-point FFT over z[j + Q*n1], then W_M^{j k1}
    const float* fs = sig + warp * hop;
    if constexpr (SPLIT) {
      // lane half h: u[a] = (z[a] + (-1)^h z[a + P/2]) W_P^{a h}, its
      // P/2-point FFT is Y_j[2k' + h]
      constexpr int PH = P / 2;
      const int h = lane / Q;
      const float sgn = h ? -1.f : 1.f;
      float re[PH], im[PH];
#pragma unroll
      for (int a = 0; a < PH; ++a) {
        const int n0 = j + Q * a, n1 = n0 + Q * PH;
        const float2 w0 = __ldg(reinterpret_cast<const float2*>(window) + n0);
        const float2 w1 = __ldg(reinterpret_cast<const float2*>(window) + n1);
        re[a] = fmaf(sgn, fs[2 * n1] * w1.x, fs[2 * n0] * w0.x);
        im[a] = fmaf(sgn, fs[2 * n1 + 1] * w1.y, fs[2 * n0 + 1] * w0.y);
        if (a > 0) {
          const float2 w = tw[a * h * (N / P)];
          cmul(re[a], im[a], w.x, w.y);
        }
      }
      fft_reg<PH>(re, im, tw, N / PH);
#pragma unroll
      for (int kk = 0; kk < PH; ++kk) {
        const int kc = 2 * kk + h;
        const float2 w = tw[M + kc * Q + j];
        cmul(re[kk], im[kk], w.x, w.y);
        are[j * LD + kc] = re[kk];
        aim[j * LD + kc] = im[kk];
      }
    } else {
      float re[P], im[P];
#pragma unroll
      for (int n1 = 0; n1 < P; ++n1) {
        const int nn = j + Q * n1;
        const float2 w = __ldg(reinterpret_cast<const float2*>(window) + nn);
        re[n1] = fs[2 * nn] * w.x;
        im[n1] = fs[2 * nn + 1] * w.y;
      }
      fft_reg<P>(re, im, tw, N / P);
#pragma unroll
      for (int kk = 1; kk < P; ++kk) {
        const float2 w = tw[M + kk * Q + j];
        cmul(re[kk], im[kk], w.x, w.y);
      }
      if (lane < Q) {
#pragma unroll
        for (int kk = 0; kk < P; ++kk) {
          are[j * LD + kk] = re[kk];
          aim[j * LD + kk] = im[kk];
        }
      }
    }
    __syncwarp();

    // step 2: lane k1, Q-point FFT over the column -> Z[k1 + P*k2]
    float zr[Q], zi[Q];
#pragma unroll
    for (int jj = 0; jj < Q; ++jj) {
      zr[jj] = are[jj * LD + k1];
      zi[jj] = aim[jj * LD + k1];
    }
    fft_reg<Q>(zr, zi, tw, N / Q);
    __syncwarp();              // the tile is read; |X| overwrites it

    // split step: Z[M-k] sits in lane (P - k1) % P, register Q-1-k2 (or,
    // for k1 = 0, in this lane's register (Q - k2) % Q)
    const int partner = (P - k1) & (P - 1);
#pragma unroll
    for (int k2 = 0; k2 < Q; ++k2) {
      const float sr = __shfl_sync(FULL, zr[Q - 1 - k2], partner);
      const float si = __shfl_sync(FULL, zi[Q - 1 - k2], partner);
      const float cr = k1 == 0 ? zr[(Q - k2) & (Q - 1)] : sr;
      const float ci = k1 == 0 ? zi[(Q - k2) & (Q - 1)] : si;
      const int k = k1 + P * k2;
      const float2 w = tw[k];
      const float er = 0.5f * (zr[k2] + cr), ei = 0.5f * (zi[k2] - ci);
      const float orr = 0.5f * (zi[k2] + ci), oi = 0.5f * (cr - zr[k2]);
      const float xr = er + w.x * orr - w.y * oi;
      const float xi = ei + w.x * oi + w.y * orr;
      const float p = xr * xr + xi * xi;
      if (lane < P) are[k] = DB ? p : sqrtf(p);
    }
    if (lane == 0) {
      const float ny = zr[0] - zi[0];
      are[M] = DB ? ny * ny : fabsf(ny);
    }
    __syncthreads();

    // banded mel: thread (mel, fg) sums frames fg*FPT .. fg*FPT + FPT - 1
    if (mel < n_mels) {
      float acc[FPT] = {};
      const float* mg = work + fg * FPT * WORK + b_start;
      for (int i = 0; i < b_len; ++i) {
        const float w = __ldg(weights + b_off + i);
#pragma unroll
        for (int ff = 0; ff < FPT; ++ff)
          acc[ff] = fmaf(w, mg[ff * WORK + i], acc[ff]);
      }
#pragma unroll
      for (int ff = 0; ff < FPT; ++ff) {
        const int t = t0 + fg * FPT + ff;
        if (t < T)
          out[((size_t)b * T + t) * n_mels + mel] =
              DB ? 10.f * log10f(fmaxf(acc[ff], AMIN)) : acc[ff];
      }
    }
  }
}

template <int P, int Q, bool DB, int MS>
int launch(const float* audio, const float* window, const float* twiddle,
           const int* bands, const float* weights, float* out, int B, int n,
           int T, int hop, int n_mels, int grid_max, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(mel_fft_kernel<P, Q, DB, MS>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_bytes<P, Q>(DB ? MAX_HOP_DB : MAX_HOP));
    configured = true;
  }
  const int tiles = (T + F - 1) / F;
  const int total = tiles * B;
  const int grid = total < grid_max ? total : grid_max;
  mel_fft_kernel<P, Q, DB, MS><<<grid, NT, smem_bytes<P, Q>(hop), stream>>>(
      audio, window, reinterpret_cast<const float2*>(twiddle), bands,
      weights, out, n, T, tiles, total, hop, n_mels);
  return (int)cudaGetLastError();
}

template <int P, int Q>
int launch_form(const float* audio, const float* window,
                const float* twiddle, const int* bands, const float* weights,
                float* out, int B, int n, int T, int hop, int n_mels,
                int power_db, int grid_max, cudaStream_t st) {
  if (!power_db)
    return launch<P, Q, false, MAXM>(audio, window, twiddle, bands, weights,
                                     out, B, n, T, hop, n_mels, grid_max, st);
  if (n_mels <= MAXM / 2)
    return launch<P, Q, true, MAXM / 2>(audio, window, twiddle, bands,
                                        weights, out, B, n, T, hop, n_mels,
                                        grid_max, st);
  return launch<P, Q, true, MAXM>(audio, window, twiddle, bands, weights,
                                  out, B, n, T, hop, n_mels, grid_max, st);
}

}  // namespace

// audio: (B, n) raw samples; window: (N,) the window; twiddle: (N, 2) =
// W_N^q for q < N/2, then W_M^{j k1} at N/2 + k1*Q + j; bands: (n_mels, 3)
// int32 (start bin, length, offset into weights); weights: the bands'
// filterbank values; out: (B, T, n_mels), the linear magnitude mel, or
// with power_db the dB of the power mel. All float32 but bands,
// contiguous. N = 2 * P * Q with (P, Q) as in ops/mel_kernel.fft_split;
// grid_max caps the persistent grid (2 blocks per SM). Returns
// cudaGetLastError() after the launch.
extern "C" int bsed_mel_forward(const float* audio, const float* window,
                                const float* twiddle, const int* bands,
                                const float* weights, float* out, int B,
                                int n, int T, int n_window, int hop,
                                int n_mels, int power_db, int grid_max,
                                void* stream) {
  if (B < 1 || T < 1 || n_mels < 1 || n_mels > MAXM || hop < 1 ||
      hop > (power_db ? MAX_HOP_DB : MAX_HOP) || n <= n_window / 2 ||
      grid_max < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (n_window) {
    case 128:
      return launch_form<8, 8>(audio, window, twiddle, bands, weights, out,
                               B, n, T, hop, n_mels, power_db, grid_max, st);
    case 256:
      return launch_form<16, 8>(audio, window, twiddle, bands, weights, out,
                                B, n, T, hop, n_mels, power_db, grid_max, st);
    case 512:
      return launch_form<16, 16>(audio, window, twiddle, bands, weights, out,
                                 B, n, T, hop, n_mels, power_db, grid_max,
                                 st);
    case 1024:
      return launch_form<32, 16>(audio, window, twiddle, bands, weights, out,
                                 B, n, T, hop, n_mels, power_db, grid_max,
                                 st);
    case 2048:
      return launch_form<32, 32>(audio, window, twiddle, bands, weights, out,
                                 B, n, T, hop, n_mels, power_db, grid_max,
                                 st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
