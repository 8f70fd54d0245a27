// Kernel K2: folded-stem epilogue, forward (sm_90a, float32 FMA).
//
// Replaces the TPU kernel bsed_tpu/ops/stem_epilogue.py:make_fused_epilogue
// (_run_fwd, body _fwd_kernel) with the pool_w frequency pool, in its
// serving form (no dropout) and its train form (uint8 dropout bits).
// Wrapper and plain version: bsed_tpu_torch/ops/stem_epilogue.py; the
// backward is kernel K3, csrc/stem_epilogue_bwd.cu.
//
// Per row (t, g) of h (B, T, 16, 128) and lane l:
//   y   = h * inv[l] + c[l]                          (f32)
//   lin = round_dt(y) @ w + b                        (f32 accumulation)
//   z   = lin * sigmoid(y)   (glu)   |   y * sigmoid(lin)   (cg)
//   z   = bits < k ? z * 256/k : 0                   (train form only)
//   z   = (z[2t] + z[2t+1]) / 2                      (pt = 2; odd last row dropped)
//   out = round_dt(z) @ pool_w                       (pool_w averages lane
//         pairs l = 2q*pc + ch and (2q+1)*pc + ch into q*pc + ch)
// Elementwise math in f32; matmul operands rounded to the input dtype, as
// the TPU kernel feeds its MXU; output in the input dtype.
//
// Bound on the H100: device memory for the work itself (h read once, the
// pooled output written once: ~0.74 GB per batch-64 forward in bf16), but
// this first kernel does its 128x128 product in f32 FMA, which costs more
// than the bytes. Design: persistent blocks (two per SM) load w once into
// shared memory, then walk over panels of 4 time rows x 16 groups x 128
// lanes; the panel is one contiguous stretch of h, loaded coalesced. Each
// thread owns 4 time rows of one group and the 8 lanes that pool into 4
// output lanes, so both pools happen in registers and the output is written
// once. Panel rows past the valid time range are zero-filled and never
// stored. The train form reads the dropout bits of a thread's 8 lanes as
// two 4-byte words (bits has h's layout, one byte per element).
#include "stem_common.cuh"

namespace {

struct Smem {
  float w[L][L];              // w with columns permuted per thread (see wcol)
  float ya[ROWS][L];          // round_dt(y) of the panel
};

// Lane of w held in shared-memory column ``slot``: slot cg*4 + j (< 64)
// is lane colA + j and slot 64 + cg*4 + j is lane colB + j, where output
// lanes cg*4.. = q*pc + ch0.. pool lanes colA = 2q*pc + ch0 and
// colB = colA + pc. A thread's 8 lanes are then two float4 at consecutive
// addresses across the warp (no bank conflicts).
__device__ __forceinline__ int wcol(int slot, int pc) {
  const int cg = (slot % 64) / 4, j = slot % 4;
  const int ol = cg * 4, q = ol / pc, ch0 = ol % pc;
  return 2 * q * pc + ch0 + j + (slot >= 64 ? pc : 0);
}

template <typename T, bool GLU, int PT, bool DROP>
__global__ void __launch_bounds__(NT, 2)
epilogue_kernel(const T* __restrict__ h, const float* __restrict__ inv,
                const float* __restrict__ cvec, const T* __restrict__ w,
                const float* __restrict__ bvec,
                const unsigned char* __restrict__ bits, int keep_k,
                T* __restrict__ out, int B, int Tin, int Tout, int pc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int g = tid / 16, cg = tid % 16;
  const int colA = wcol(cg * 4, pc), colB = wcol(64 + cg * 4, pc);

  for (int i = tid; i < L * L; i += NT) {
    const int k = i / L, slot = i % L;
    s.w[k][slot] = to_f(w[k * L + wcol(slot, pc)]);
  }

  constexpr int TRO = TRI / PT;                  // output rows per panel
  const int tiles_t = (Tout + TRO - 1) / TRO;
  const int tv = Tout * PT;                      // input rows that count
  const float keep_scale = DROP ? 256.f / (float)keep_k : 1.f;
  for (int tile = blockIdx.x; tile < B * tiles_t; tile += gridDim.x) {
    const int bi = tile / tiles_t;
    const int to0 = (tile % tiles_t) * TRO;
    const int ti0 = to0 * PT;
    const T* hp = h + ((size_t)bi * Tin + ti0) * G * L;

    __syncthreads();                             // ya of the last panel is read
    for (int i = tid * 4; i < ROWS * L; i += NT * 4) {
      const int row = i / L, col = i % L;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (ti0 + row / G < tv) load4(hp + i, v);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = round_dt<T>(fmaf(v[q], inv[col + q], cvec[col + q]));
      store4(&s.ya[row][col], v);
    }
    __syncthreads();

    float acc[TRI][8] = {};
#pragma unroll 2
    for (int k = 0; k < L; k += 4) {
      float a[TRI][4];
#pragma unroll
      for (int tr = 0; tr < TRI; ++tr) load4(&s.ya[tr * G + g][k], a[tr]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float wv[8];
        load4(&s.w[k + kk][cg * 4], wv);
        load4(&s.w[k + kk][64 + cg * 4], wv + 4);
#pragma unroll
        for (int tr = 0; tr < TRI; ++tr)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[tr][j] = fmaf(a[tr][kk], wv[j], acc[tr][j]);
      }
    }

    // gate in f32 (y recomputed from h), then the time pool
    float z[TRI][8];
#pragma unroll
    for (int tr = 0; tr < TRI; ++tr) {
      float hv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      unsigned int kb[2] = {0u, 0u};
      if (ti0 + tr < tv) {
        const size_t off = ((size_t)bi * Tin + ti0 + tr) * G * L
                           + (size_t)g * L;
        const T* row = hp + (size_t)(tr * G + g) * L;
        load4(row + colA, hv);
        load4(row + colB, hv + 4);
        if constexpr (DROP) {
          kb[0] = *reinterpret_cast<const unsigned int*>(bits + off + colA);
          kb[1] = *reinterpret_cast<const unsigned int*>(bits + off + colB);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = j < 4 ? colA + j : colB + j - 4;
        const float y = fmaf(hv[j], inv[col], cvec[col]);
        const float lin = acc[tr][j] + bvec[col];
        float zz = GLU ? lin * sigmoidf(y) : y * sigmoidf(lin);
        if constexpr (DROP) {
          const unsigned int byte = (kb[j / 4] >> (8 * (j % 4))) & 0xffu;
          zz = (int)byte < keep_k ? zz * keep_scale : 0.f;
        }
        z[tr][j] = zz;
      }
    }
#pragma unroll
    for (int p = 0; p < TRO; ++p) {
      const int to = to0 + p;
      if (to >= Tout) break;
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float za = z[p * PT][j], zb = z[p * PT][j + 4];
        if constexpr (PT == 2) {
          za = (za + z[p * PT + 1][j]) * 0.5f;
          zb = (zb + z[p * PT + 1][j + 4]) * 0.5f;
        }
        o[j] = 0.5f * round_dt<T>(za) + 0.5f * round_dt<T>(zb);
      }
      store4(out + (((size_t)bi * Tout + to) * G + g) * L2 + cg * 4, o);
    }
  }
}

template <typename T, bool GLU, int PT, bool DROP>
int launch(const void* h, const float* inv, const float* c, const void* w,
           const float* b, const unsigned char* bits, int keep_k, void* out,
           int B, int Tin, int Tout, int pc, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(epilogue_kernel<T, GLU, PT, DROP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)sizeof(Smem));
    configured = true;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  constexpr int TRO = TRI / PT;
  const long tiles = (long)B * ((Tout + TRO - 1) / TRO);
  const int grid = (int)(tiles < 2L * sms ? tiles : 2L * sms);
  if (grid > 0)
    epilogue_kernel<T, GLU, PT, DROP><<<grid, NT, sizeof(Smem), stream>>>(
        static_cast<const T*>(h), inv, c, static_cast<const T*>(w), b, bits,
        keep_k, static_cast<T*>(out), B, Tin, Tout, pc);
  return (int)cudaGetLastError();
}

template <typename T, bool GLU, int PT>
int launch_form(const void* h, const float* inv, const float* c,
                const void* w, const float* b, const unsigned char* bits,
                int keep_k, void* out, int B, int Tin, int Tout, int pc,
                cudaStream_t stream) {
  if (bits != nullptr)
    return launch<T, GLU, PT, true>(h, inv, c, w, b, bits, keep_k, out, B,
                                    Tin, Tout, pc, stream);
  return launch<T, GLU, PT, false>(h, inv, c, w, b, bits, keep_k, out, B,
                                   Tin, Tout, pc, stream);
}

}  // namespace

// h: (B, Tin, 16, 128); w: (128, 128), both in the input dtype
// (0 = float32, 1 = bfloat16); inv, c, b: (128,) float32;
// out: (B, Tout, 16, 64) in the input dtype, Tout = Tin // pt.
// act: 0 = GLU, 1 = context gating. pc: channels per fold copy; pool_w
// averages lanes 2q*pc + ch and (2q+1)*pc + ch. bits: (B, Tin, 16, 128)
// uint8 dropout bits, keep where bits < keep_k (1..255), or null for the
// serving form. Returns cudaGetLastError().
extern "C" int bsed_stem_epilogue(const void* h, const float* inv,
                                  const float* c, const void* w,
                                  const float* b, const void* bits,
                                  int keep_k, void* out, int dtype, int act,
                                  int pt, int B, int Tin, int Tout, int pc,
                                  void* stream) {
  if (pc < 4 || pc % 4 != 0 || L % (2 * pc) != 0 || (pt != 1 && pt != 2) ||
      Tout != Tin / pt || dtype < 0 || dtype > 1 || act < 0 || act > 1 ||
      (bits != nullptr && (keep_k < 1 || keep_k > 255)))
    return (int)cudaErrorInvalidValue;
  const unsigned char* kb = static_cast<const unsigned char*>(bits);
  const cudaStream_t st = (cudaStream_t)stream;
  const int key = dtype * 4 + act * 2 + (pt - 1);
  switch (key) {
    case 0: return launch_form<float, true, 1>(h, inv, c, w, b, kb, keep_k, out, B, Tin, Tout, pc, st);
    case 1: return launch_form<float, true, 2>(h, inv, c, w, b, kb, keep_k, out, B, Tin, Tout, pc, st);
    case 2: return launch_form<float, false, 1>(h, inv, c, w, b, kb, keep_k, out, B, Tin, Tout, pc, st);
    case 3: return launch_form<float, false, 2>(h, inv, c, w, b, kb, keep_k, out, B, Tin, Tout, pc, st);
    case 4: return launch_form<__nv_bfloat16, true, 1>(h, inv, c, w, b, kb, keep_k, out, B, Tin, Tout, pc, st);
    case 5: return launch_form<__nv_bfloat16, true, 2>(h, inv, c, w, b, kb, keep_k, out, B, Tin, Tout, pc, st);
    case 6: return launch_form<__nv_bfloat16, false, 1>(h, inv, c, w, b, kb, keep_k, out, B, Tin, Tout, pc, st);
    default: return launch_form<__nv_bfloat16, false, 2>(h, inv, c, w, b, kb, keep_k, out, B, Tin, Tout, pc, st);
  }
}
