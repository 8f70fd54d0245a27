// Shared by the stem-epilogue kernels K2 (csrc/stem_epilogue.cu) and K3
// (csrc/stem_epilogue_bwd.cu): the panel geometry and the dtype helpers.
// Elementwise math is f32; round_dt rounds a value to the input dtype T,
// as the TPU kernel rounds its matmul operands.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int L = 128;        // lanes
constexpr int G = 16;         // groups
constexpr int L2 = 64;        // output lanes (pair-averaged)
constexpr int TRI = 4;        // input time rows per panel
constexpr int ROWS = TRI * G; // panel rows (64)
constexpr int NT = 256;

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
template <typename T> __device__ __forceinline__ float round_dt(float v) {
  return to_f(from_f<T>(v));
}

// 4 consecutive elements <-> f32
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* q = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __bfloat162float(q[i]);
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  uint2 u;
  __nv_bfloat16* q = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = __float2bfloat16_rn(v[i]);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

}  // namespace
