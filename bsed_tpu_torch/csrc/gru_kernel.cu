// Kernel K4: one BiGRU layer's recurrence, both directions (sm_90a,
// float32 FMA, thread-block clusters).
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
// floor is the chain of T dependent steps, so what counts is the latency of
// one step. Design: a cluster of C = 2 blocks serves one (direction, group
// of RB batch rows) for all T steps. Block c of the cluster owns hidden units
// [64c, 64c + 64) and their three gate columns (r, z, n): 192 columns of
// W_hh^T, held in registers for the whole run (768 threads x 32 weights;
// in bfloat16 the rounded weights are held as float32 too), so no
// step re-reads a weight. A warp owns one gate, one k-slice s (rows
// 32s .. 32s + 31 of W_hh^T) and 32 units, one a lane: every lane of a warp
// reads the same h values (broadcast float4 loads from shared memory). Per
// step t:
//   1. warps whose k-slice is the block's own units start the product for
//      the RB rows at once (their h is local); the other warps wait on the
//      block's mbarrier for the peer's half of h(t), then compute theirs;
//   2. the partials through shared memory, one __syncthreads;
//   3. 64 * RB threads add the four slices' partials and apply the gates to
//      the block's units (h carried in a register); each writes round_dt(h)
//      into its own block and, through distributed shared memory, into the
//      peer block, then arrives on the peer's mbarrier (release, cluster
//      scope); y is stored; a __syncthreads makes the block's own half
//      visible for step 1.
// No cluster-wide barrier runs inside the loop: a block waits only for the
// 64 * RB arrivals of the peer's half (acquire, cluster scope). The inputs
// are loaded D = 4 steps ahead into registers. h is double-buffered, and
// that is enough: the peer writes h(t+2) into the buffer of h(t) only after
// it has received h(t+1) from this block, which this block sends after it
// has read h(t).
// One block per SM (768 threads x <= 80 registers); clusters of 2 place on
// the card's GPCs with little waste (66 run at once on an NVIDIA H100 80GB
// HBM3, 700 W, as chip_smoke.py reports), clusters of 4 with much more.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int HD = 128;              // hidden size
constexpr int G3 = 3 * HD;           // gates
constexpr int C = 2;                 // blocks per cluster
constexpr int UNITS = HD / C;        // hidden units per block (64)
constexpr int UG = UNITS / 32;       // 32-unit groups per gate (2)
constexpr int COLS = 3 * UNITS;      // W_hh^T columns per block (192)
constexpr int KS = 4;                // k-slices per column
constexpr int KPS = HD / KS;         // rows of W_hh^T per slice (32)
constexpr int SPC = KS / C;          // slices of a block's own units (2)
constexpr int NTH = COLS * KS;       // threads per block (768)
constexpr int D = 4;                 // steps of inputs loaded ahead

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
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}
// arrive on the peer block's mbarrier at cluster address bar, releasing
// this thread's earlier stores to the cluster
__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

template <int RB>
__device__ __forceinline__ void product(const float (&hc)[RB][HD],
                                        const float (&w)[KPS], int k0,
                                        float (&acc)[RB]) {
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    acc[r] = 0.f;
#pragma unroll
    for (int k = 0; k < KPS; k += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(&hc[r][k0 + k]);
      acc[r] = fmaf(hv.x, w[k], acc[r]);
      acc[r] = fmaf(hv.y, w[k + 1], acc[r]);
      acc[r] = fmaf(hv.z, w[k + 2], acc[r]);
      acc[r] = fmaf(hv.w, w[k + 3], acc[r]);
    }
  }
}

template <typename T, int RB>
__global__ void __launch_bounds__(NTH, 1)
gru_cluster_kernel(const T* __restrict__ xp, const T* __restrict__ wt,
                   const float* __restrict__ bhh, T* __restrict__ y, int B,
                   int Tn) {
  __shared__ __align__(16) float hc[2][RB][HD];   // round_dt(h), all units
  __shared__ float part[KS][RB][COLS];             // k-slice partials
  __shared__ __align__(8) unsigned long long bar[2];   // peer's half landed
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int d = blockIdx.y;
  const int b0 = (blockIdx.x / C) * RB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // product role: warp -> (gate g, k-slice ks, unit group ug), lane -> unit
  const int ug = warp % UG, g = (warp / UG) % 3, ks = warp / (3 * UG);
  const bool own = ks / SPC == c;              // h of this slice is local
  const int lc = g * UNITS + ug * 32 + lane;   // local column
  float w[KPS];
  {
    const T* wd = wt + (size_t)d * HD * G3 + (size_t)ks * KPS * G3 +
                  g * HD + c * UNITS + ug * 32 + lane;
#pragma unroll
    for (int k = 0; k < KPS; ++k) w[k] = to_f(wd[(size_t)k * G3]);
  }
  for (int i = tid; i < 2 * RB * HD; i += NTH) (&hc[0][0][0])[i] = 0.f;

  // gate role: thread tid < UNITS * RB owns row gr, unit UNITS*c + gu; a
  // row past B stays at h = 0 (its inputs are 0) but still arrives on the
  // peer's mbarrier
  const int gr = tid / UNITS, gu = tid % UNITS;
  const int unit = c * UNITS + gu;
  const bool gate = tid < RB * UNITS;
  const bool live = gate && b0 + gr < B;
  float bias[3] = {}, xq[D][3] = {}, h = 0.f;
  const T* xrow = xp;
  T* yrow = y;
  if (live) {
    const size_t row = (size_t)d * B + b0 + gr;
    xrow = xp + row * Tn * G3 + unit;
    yrow = y + row * Tn * HD + unit;
#pragma unroll
    for (int gg = 0; gg < 3; ++gg) bias[gg] = bhh[d * G3 + gg * HD + unit];
#pragma unroll
    for (int s = 0; s < D; ++s)
      if (s < Tn)
#pragma unroll
        for (int gg = 0; gg < 3; ++gg)
          xq[s][gg] = to_f(xrow[(size_t)s * G3 + gg * HD]);
  }
  // the peer's half of h(t) lands in hc[t & 1] and completes a phase of
  // bar[t & 1] with the arrivals of the peer's 64 * RB gate threads
  const int peer = c ^ 1;
  float* hc_peer = cluster.map_shared_rank(&hc[0][0][0], peer);
  const uint32_t bar_l[2] = {smem_addr(&bar[0]), smem_addr(&bar[1])};
  const uint32_t bar_p[2] = {peer_addr(bar_l[0], peer),
                             peer_addr(bar_l[1], peer)};
  if (tid == 0) {
    mbar_init(bar_l[0], RB * UNITS);
    mbar_init(bar_l[1], RB * UNITS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();              // both blocks run, h zeroed, barriers set

  for (int t0 = 0; t0 < Tn; t0 += D) {
#pragma unroll
    for (int s = 0; s < D; ++s) {
      const int t = t0 + s;
      if (t >= Tn) break;
      const int cur = t & 1;
      float acc[RB];
      if (own) {
        product<RB>(hc[cur], w, ks * KPS, acc);
      } else {
        if (t > 0) mbar_wait(bar_l[cur], ((t - 1) >> 1) & 1);
        product<RB>(hc[cur], w, ks * KPS, acc);
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) part[ks][r][lc] = acc[r];
      __syncthreads();

      if (gate) {
        float hp[3];
#pragma unroll
        for (int gg = 0; gg < 3; ++gg) {
          hp[gg] = bias[gg];
#pragma unroll
          for (int k = 0; k < KS; ++k) hp[gg] += part[k][gr][gg * UNITS + gu];
        }
        const float rg = sigmoidf(xq[s][0] + hp[0]);
        const float zg = sigmoidf(xq[s][1] + hp[1]);
        const float ng = tanhf(xq[s][2] + rg * hp[2]);
        h = (1.f - zg) * ng + zg * h;
        const T hy = from_f<T>(h);
        const float hq = to_f(hy);
        const int at = ((cur ^ 1) * RB + gr) * HD + unit;
        hc[cur ^ 1][gr][unit] = hq;
        if (t + 1 < Tn) {
          hc_peer[at] = hq;
          mbar_arrive_peer(bar_p[cur ^ 1]);
        }
        if (live) yrow[(size_t)t * HD] = hy;
      }
      __syncthreads();         // this block's half of h(t+1) is visible
      if (live && t + D < Tn) {
#pragma unroll
        for (int gg = 0; gg < 3; ++gg)
          xq[s][gg] = to_f(xrow[(size_t)(t + D) * G3 + gg * HD]);
      }
    }
  }
  cluster.sync();              // no block leaves while the peer writes to it
}

template <typename T, int RB>
cudaLaunchConfig_t config(int B, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((B + RB - 1) / RB), 2, 1);
  cfg.blockDim = dim3(NTH, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int RB>
int launch(const void* xp, const void* wt, const float* bhh, void* y, int B,
           int Tn, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<T, RB>(B, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, gru_cluster_kernel<T, RB>, static_cast<const T*>(xp),
      static_cast<const T*>(wt), bhh, static_cast<T*>(y), B, Tn);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(const void* xp, const void* wt, const float* bhh, void* y,
                int B, int Tn, int rows, cudaStream_t stream) {
  switch (rows) {
    case 1: return launch<T, 1>(xp, wt, bhh, y, B, Tn, stream);
    case 2: return launch<T, 2>(xp, wt, bhh, y, B, Tn, stream);
    case 4: return launch<T, 4>(xp, wt, bhh, y, B, Tn, stream);
    default: return launch<T, 8>(xp, wt, bhh, y, B, Tn, stream);
  }
}

// (registers per thread, clusters that fit on the card at once) of the
// instantiation for (T, rows); a negative cudaError_t on failure.
template <typename T, int RB>
int attribute(int which) {
  if (which == 0) {
    cudaFuncAttributes a = {};
    const cudaError_t err = cudaFuncGetAttributes(&a, gru_cluster_kernel<T, RB>);
    return err == cudaSuccess ? a.numRegs : -(int)err;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<T, RB>(1, 0, &attr);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &n, gru_cluster_kernel<T, RB>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

template <typename T>
int attribute_rows(int rows, int which) {
  switch (rows) {
    case 1: return attribute<T, 1>(which);
    case 2: return attribute<T, 2>(which);
    case 4: return attribute<T, 4>(which);
    default: return attribute<T, 8>(which);
  }
}

bool valid(int dtype, int rows) {
  return dtype >= 0 && dtype <= 1 &&
         (rows == 1 || rows == 2 || rows == 4 || rows == 8);
}

}  // namespace

// xp: (2, B, T, 3H) and y: (2, B, T, H) in the input dtype (0 = float32,
// 1 = bfloat16), as is wt (2, H, 3H) = W_hh^T; bhh: (2, 3H) float32.
// rows: batch rows per cluster (1, 2, 4 or 8); cluster: blocks per cluster
// (2); H must be 128. Returns cudaGetLastError().
extern "C" int bsed_gru_bidir(const void* xp, const void* wt,
                              const float* bhh, void* y, int dtype, int B,
                              int Tn, int rows, int cluster, int H,
                              void* stream) {
  if (H != HD || B < 0 || Tn < 0 || cluster != C || !valid(dtype, rows))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Tn == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_rows<float>(xp, wt, bhh, y, B, Tn, rows, st);
  return launch_rows<__nv_bfloat16>(xp, wt, bhh, y, B, Tn, rows, st);
}

// which = 0: registers per thread of the kernel for (dtype, rows), from
// cudaFuncGetAttributes; which = 1: how many of its clusters the card runs
// at once, from cudaOccupancyMaxActiveClusters. A negative cudaError_t on
// failure.
extern "C" int bsed_gru_attribute(int dtype, int rows, int which) {
  if (!valid(dtype, rows) || which < 0 || which > 1)
    return -(int)cudaErrorInvalidValue;
  return dtype == 0 ? attribute_rows<float>(rows, which)
                    : attribute_rows<__nv_bfloat16>(rows, which);
}
