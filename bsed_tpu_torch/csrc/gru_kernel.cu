// Kernel K4: one BiGRU layer's recurrence, both directions (sm_90a,
// float32 FMA).
//
// Replaces the TPU kernel bsed_tpu/ops/gru_kernel.py:gru_bidir_recurrence
// (body _gru_kernel). Wrapper and plain version:
// bsed_tpu_torch/ops/gru_kernel.py.
//
// xp (2, B, T, 3H): input projections + b_ih, direction 1 flipped in time;
// wt (2, H, 3H): W_hh^T in the input dtype; bhh (2, 3H) float32. Per step,
// torch's gate order (r, z, n) with the recurrent bias inside the reset gate:
//   hp = round_dt(h) @ wt + bhh            (f32 accumulation)
//   r = sigmoid(xr + hr); z = sigmoid(xz + hz); n = tanh(xn + r * hn)
//   h = (1 - z) * n + z * h                (f32 state)
//   y[t] = round_dt(h)
//
// Bound on the H100: the products are 2*B*T*H*3H*2 FLOP per layer, but the
// floor is the chain of T dependent steps. Design: (direction, batch row)
// pairs are independent, so a block owns one direction and RB batch rows for
// all T steps and needs only __syncthreads between steps. W_hh^T of its
// direction lives in shared memory (96 KB bf16, 192 KB f32), as do the f32
// state h, its rounded copy (the product's operand) and hp. Each of the 384
// threads computes one column of hp for the RB rows (W column reads are
// conflict-free, the h reads broadcasts); then RB * 128 gate work items
// apply the gates, write y and load the next step's inputs ahead, so the
// global-load latency overlaps the next step's product.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int HD = 128;          // hidden size
constexpr int G3 = 3 * HD;       // gates
constexpr int NTH = G3;          // threads: one per column of hp

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

template <typename T, int RB>
constexpr size_t smem_bytes() {
  return (size_t)(2 * RB * HD + RB * G3) * sizeof(float)
         + (size_t)HD * G3 * sizeof(T);
}

template <typename T, int RB>
__global__ void __launch_bounds__(NTH, 1)
gru_kernel(const T* __restrict__ xp, const T* __restrict__ wt,
           const float* __restrict__ bhh, T* __restrict__ y, int B, int Tn) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* hs = reinterpret_cast<float*>(smem_raw);   // [RB][HD] state
  float* hc = hs + RB * HD;                         // [RB][HD] round_dt(h)
  float* hp = hc + RB * HD;                         // [RB][G3]
  T* w = reinterpret_cast<T*>(hp + RB * G3);        // [HD][G3]
  const int tid = threadIdx.x;
  const int d = blockIdx.y;
  const int b0 = blockIdx.x * RB;

  const T* wd = wt + (size_t)d * HD * G3;
  for (int i = tid; i < HD * G3; i += NTH) w[i] = wd[i];
  for (int i = tid; i < RB * HD; i += NTH) {
    hs[i] = 0.f;
    hc[i] = 0.f;
  }
  const float bias = bhh[d * G3 + tid];

  // gate work items q = tid + m * NTH < RB * HD: row q / HD, unit q % HD
  constexpr int NQ = (RB * HD + NTH - 1) / NTH;
  float xv[NQ][3];
#pragma unroll
  for (int m = 0; m < NQ; ++m) {
    const int q = tid + m * NTH, b = b0 + q / HD;
    if (q < RB * HD && b < B) {
      const T* p = xp + ((size_t)d * B + b) * Tn * G3 + q % HD;
#pragma unroll
      for (int g = 0; g < 3; ++g) xv[m][g] = to_f(p[g * HD]);
    }
  }
  __syncthreads();

  for (int t = 0; t < Tn; ++t) {
    float acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int k = 0; k < HD; k += 4) {
      float wv[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wv[kk] = to_f(w[(k + kk) * G3 + tid]);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(hc + r * HD + k);
        acc[r] = fmaf(hv.x, wv[0], acc[r]);
        acc[r] = fmaf(hv.y, wv[1], acc[r]);
        acc[r] = fmaf(hv.z, wv[2], acc[r]);
        acc[r] = fmaf(hv.w, wv[3], acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) hp[r * G3 + tid] = acc[r] + bias;
    __syncthreads();

#pragma unroll
    for (int m = 0; m < NQ; ++m) {
      const int q = tid + m * NTH;
      const int r = q / HD, j = q % HD, b = b0 + r;
      if (q < RB * HD && b < B) {
        const float* hpr = hp + r * G3;
        const float rg = sigmoidf(xv[m][0] + hpr[j]);
        const float zg = sigmoidf(xv[m][1] + hpr[HD + j]);
        const float ng = tanhf(xv[m][2] + rg * hpr[2 * HD + j]);
        const float hn = (1.f - zg) * ng + zg * hs[r * HD + j];
        const T hr = from_f<T>(hn);
        hs[r * HD + j] = hn;
        hc[r * HD + j] = to_f(hr);
        const size_t row = ((size_t)d * B + b) * Tn + t;
        y[row * HD + j] = hr;
        if (t + 1 < Tn) {
          const T* p = xp + (row + 1) * G3 + j;
#pragma unroll
          for (int g = 0; g < 3; ++g) xv[m][g] = to_f(p[g * HD]);
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, int RB>
int launch(const void* xp, const void* wt, const float* bhh, void* y, int B,
           int Tn, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(gru_kernel<T, RB>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_bytes<T, RB>());
    configured = true;
  }
  const dim3 grid((B + RB - 1) / RB, 2);
  gru_kernel<T, RB><<<grid, NTH, smem_bytes<T, RB>(), stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(wt), bhh,
      static_cast<T*>(y), B, Tn);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(const void* xp, const void* wt, const float* bhh, void* y,
                int B, int Tn, int rows, cudaStream_t stream) {
  switch (rows) {
    case 1: return launch<T, 1>(xp, wt, bhh, y, B, Tn, stream);
    case 2: return launch<T, 2>(xp, wt, bhh, y, B, Tn, stream);
    default: return launch<T, 4>(xp, wt, bhh, y, B, Tn, stream);
  }
}

}  // namespace

// xp: (2, B, T, 3H) and y: (2, B, T, H) in the input dtype (0 = float32,
// 1 = bfloat16), as is wt (2, H, 3H) = W_hh^T; bhh: (2, 3H) float32.
// rows: batch rows per block (1, 2 or 4); H must be 128. Returns
// cudaGetLastError().
extern "C" int bsed_gru_bidir(const void* xp, const void* wt,
                              const float* bhh, void* y, int dtype, int B,
                              int Tn, int rows, int H, void* stream) {
  if (H != HD || B < 0 || Tn < 0 || dtype < 0 || dtype > 1 ||
      (rows != 1 && rows != 2 && rows != 4))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Tn == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_rows<float>(xp, wt, bhh, y, B, Tn, rows, st);
  return launch_rows<__nv_bfloat16>(xp, wt, bhh, y, B, Tn, rows, st);
}
