// Shared by the stem-epilogue kernels K2 (csrc/stem_epilogue.cu) and K3
// (csrc/stem_epilogue_bwd.cu): the panel geometry, the dtype helpers and the
// tensor-core building blocks of the bf16 bodies (wgmma on core-matrix
// tiles, cp.async staging, the fragment-row map).
// Elementwise math is f32; round_dt rounds a value to the input dtype T,
// as the TPU kernel rounds its matmul operands.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// ---- the bf16 tensor-core bodies ------------------------------------------
//
// A panel is 64 rows = the four m16 tiles of one warpgroup's wgmma, laid
// out as mma.m16n8k16 fragments. Fragment row f = 16 * mb + i is row i of
// tile mb (warp mb of the group); a thread of the warp (g = lane / 4,
// t = lane % 4) holds rows i = g and g + 8 at columns 8 * n + 2 * t + {0, 1}
// of every n-block of an accumulator, and the same rows and columns
// 16 * kb + 2 * t + {0, 1, 8, 9} of a register A operand. panel_row maps a
// fragment row to the panel row (tl, gi) = tl * groups + gi it holds; a
// thread's two rows (i, i + 8 of a tile) are pair q = 8 * mb + i:
//   pt = 2: the time pair (2 * tp, gi), (2 * tp + 1, gi), q = tp * groups +
//     gi, so the time pool (K2) and the shared cotangent (K3) stay inside
//     the thread; with pg = 2 the pool's other pair (gi ^ 1) is pair q ^ 1,
//     the thread 4 lanes away;
//   pt = 1, pg = 2: the group pair (tl, 2 g'), (tl, 2 g' + 1), rows 2 q and
//     2 q + 1, so the group pool (K2's group form) stays inside the thread;
//   pt = 1, pg = 1: the identity.
// Mirrored by bsed_tpu_torch/ops/stem_epilogue.py:fragment_panel_row, which
// the CPU tests hold to be a bijection whose pairs are pool groups for
// every (groups, pt, pg) the kernels take.
__host__ __device__ constexpr int panel_row(int f, int pt, int groups,
                                            int pg = 1) {
  const int q = (f / 16) * 8 + f % 8;           // pair index, < 32
  if (pt == 2) return (2 * (q / groups) + (f % 16) / 8) * groups + q % groups;
  if (pg == 2) return 2 * q + (f % 16) / 8;
  return f;
}

// The inverse of panel_row: the fragment row that holds panel row p.
__host__ __device__ constexpr int fragment_row(int p, int pt, int groups,
                                               int pg = 1) {
  if (pt == 2) {
    const int tl = p / groups;                  // time row in the panel
    const int q = (tl / 2) * groups + p % groups;
    return (q / 8) * 16 + (tl % 2) * 8 + q % 8;
  }
  if (pg == 2) return (p / 16) * 16 + (p % 2) * 8 + (p / 2) % 8;
  return p;
}

// Staged panels (raw h, gz, dropout bits) are row-major with padded row
// strides: 272 bytes for 128-column bf16 rows, 144 bytes for 128-byte rows,
// so the 8 rows a warp touches with 4-byte accesses fall on distinct banks.
constexpr int TSB = 272;      // row stride in bytes, 128-column bf16 rows
constexpr int BSB = 144;      // row stride in bytes, 128-byte rows
constexpr int STAGE_H = ROWS * TSB;             // one staged 64 x 128 panel
constexpr int STAGE_BITS = ROWS * BSB;          // one panel of dropout bits

// Operands that wgmma reads from shared memory (w, and K3's hi/lo tiles)
// are bf16 tiles of 128 columns in the unswizzled core-matrix layout: 8 x 8
// blocks of 128 contiguous bytes (8 rows of 16 bytes), column blocks 128
// bytes apart, row blocks 2048 bytes apart. One tile serves as a K-major
// operand (K along the columns: leading offset 128, stride offset 2048) and
// as an MN-major one (K along the rows: leading offset 2048, stride offset
// 128, the transposing form). A warp's 4-byte accesses at rows g = 0..7,
// columns 2t.. cover 128 contiguous bytes: no bank conflicts.
constexpr int BLK_COL = 128;  // bytes between column blocks
constexpr int BLK_ROW = 2048; // bytes between row blocks
constexpr int TILE_BYTES = ROWS * L * 2;        // one 64 x 128 bf16 tile
constexpr int W_BYTES = L * L * 2;              // w, 128 x 128 bf16
__host__ __device__ constexpr int blocked(int row, int col) {
  return (row / 8) * BLK_ROW + (col / 8) * BLK_COL + (row % 8) * 16 +
         (col % 8) * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// wgmma: a warpgroup (4 warps) multiplies a 64-row tile asynchronously.
// Warp i of the group holds rows 16 i .. 16 i + 15 of the accumulator and
// of a register A operand, in the mma.m16n8k16 fragment layout above.
// Shared-memory writes made with ordinary stores need fence_async_proxy
// and a barrier before a wgmma reads them.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, int leading,
                                              int stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(leading >> 4) << 16) | ((uint64_t)(stride >> 4) << 32);
}
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return smem_desc(addr, BLK_COL, BLK_ROW);
}
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return smem_desc(addr, BLK_ROW, BLK_COL);
}
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// d (64 x 64) += a (64 x 16, registers) * b (16 x 64, MN-major tile)
__device__ __forceinline__ void wgmma_n64_reg_mn(float (&d)[8][4],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]),
        "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]),
        "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]),
        "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]),
        "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// d (64 x 64) += a (64 x 16, K-major tile) * b (16 x 64, K-major tile)
__device__ __forceinline__ void wgmma_n64_k_k(float (&d)[8][4], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]),
        "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]),
        "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]),
        "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]),
        "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1));
}
// d (64 x 128) += a (64 x 16, MN-major tile) * b (16 x 128, MN-major tile)
__device__ __forceinline__ void wgmma_n128_mn_mn(float (&d)[16][4],
                                                 uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]),
        "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]),
        "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]),
        "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]),
        "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]),
        "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]),
        "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]),
        "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]),
        "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]),
        "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]),
        "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]),
        "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]),
        "+f"(d[15][3])
      : "l"(a), "l"(b), "r"(1));
}

// two f32 -> packed bf16 pair (x in the low half, the lower address)
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}
// the hi/lo split of a pair: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(x, y);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(x - h.x, y - h.y);
}
// sigmoid by the fast exponential and reciprocal (relative error ~1e-6),
// for the bf16 bodies, whose results are rounded to 8 bits of mantissa
__device__ __forceinline__ float sigmoid_fast(float v) {
  return __fdividef(1.f, 1.f + __expf(-v));
}
__device__ __forceinline__ int log2i(int v) { return __ffs(v) - 1; }

}  // namespace
