// Kernel K2: folded-stem epilogue, forward (sm_90a). The bfloat16 forms
// run on the tensor cores (wgmma), the rest in float32 FMA.
//
// Replaces the TPU kernel bsed_tpu/ops/stem_epilogue.py:make_fused_epilogue
// (_run_fwd, body _fwd_kernel) in both frequency-pool forms, each in its
// serving form (no dropout) and its train form (uint8 dropout bits): the
// pool_w lane pool of the folded blocks (epilogue_mma_kernel,
// epilogue_kernel) and the group pool pg of standard-layout blocks
// (epilogue_pg_mma_kernel, epilogue_pg_kernel, below). Wrapper and plain
// version:
// bsed_tpu_torch/ops/stem_epilogue.py; the backward is kernel K3,
// csrc/stem_epilogue_bwd.cu.
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
// Bound on the H100: device memory (h and the bits read once, the pooled
// output written once: ~0.74 GB per batch-64 forward in bf16). All bodies
// are persistent blocks, two per SM, that hold w in shared memory and walk
// over panels of 64 contiguous rows (4 time rows x 16 groups) x 128 lanes.
//
// bfloat16 body (epilogue_mma_kernel; the lane pool with pc >= 8, which
// is every folded block of the model), 8 warps = two warpgroups:
//   * h and the bits arrive raw through a 2-deep cp.async ring, 16 bytes a
//     thread, so h is read once and the next panel loads while this one
//     computes; w sits in shared memory as bf16 in the core-matrix layout
//     (stem_common.cuh), its columns permuted in blocks of 8 so that the
//     64 contiguous columns of warpgroup nh are the four 8-lane blocks
//     that pool into output lanes 32 nh .. 32 nh + 31 and then their
//     partners pc lanes further.
//   * Warp mb of a warpgroup owns m16 tile mb of the panel (fragment rows,
//     see panel_row in stem_common.cuh). It forms the A fragments of
//     bf16(y) in registers from the staged h, and lin = bf16(y) @ w is one
//     chain of eight wgmma.m64n64k16 a warpgroup, each k-block issued as
//     soon as its fragments exist; the gate runs at the accumulator
//     positions with y recomputed in f32 there.
//   * Both pools happen in registers: a thread's two fragment rows are the
//     time pair (t, g), (t + 1, g) when pt = 2, and a lane and its partner
//     are two n-blocks of the same thread. The output panel leaves
//     through shared memory as 16-byte stores.
//   Shared memory 96,768 bytes (MMA_SMEM), 128 registers a thread: two
//   blocks an SM.
// The bfloat16 group pool (epilogue_pg_mma_kernel) is the same body with w
// unpermuted, the fragment-row map choosing a thread's two rows as the
// pool pair (one shuffle when pt = pg = 2), and 128-lane output rows
// (PG_MMA_SMEM = 104,960 bytes).
// float32 body (epilogue_kernel; also bf16 with pc = 4, where a lane pair
// falls inside one 8-column block): FMA products. Each thread owns 4 time
// rows of one group and the 8 lanes that pool into 4 output lanes; the
// panel's round_dt(y) sits in shared memory in f32, h is read a second
// time for the gate, and the bits of a thread's 8 lanes come as two
// 4-byte words.
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

// Shared memory of the bf16 bodies: w, inv / c / b, two stages of (h, bits)
// and the output panel: 64-lane rows at a 144-byte stride for the lane
// pool, 128-lane rows at a 272-byte stride for the group pool.
constexpr int M_VEC = W_BYTES;
constexpr int M_STAGE = M_VEC + 3 * L * 4;
constexpr int STAGE_BYTES = STAGE_H + STAGE_BITS;
constexpr int M_OUT = M_STAGE + 2 * STAGE_BYTES;
constexpr int MMA_SMEM = M_OUT + ROWS * BSB;
constexpr int PG_MMA_SMEM = M_OUT + ROWS * TSB;

// Start the cp.async copies of one panel into stage ``st``: rows ti0 ..
// of clip bi, 64 rows of h (and of the bits when DROP) from ``base``;
// rows at or past Tin are left as they are.
template <bool DROP>
__device__ __forceinline__ void load_panel(unsigned char* st,
                                           const __nv_bfloat16* h,
                                           const unsigned char* bits,
                                           size_t base, int ti0, int Tin,
                                           int groups, int tid) {
  for (int c = tid; c < ROWS * 16; c += NT) {
    const int row = c >> 4, ch = c & 15;
    if (ti0 + row / groups < Tin)
      cp_async16(st + row * TSB + ch * 16, h + base + row * L + ch * 8);
  }
  if constexpr (DROP) {
    for (int c = tid; c < ROWS * 8; c += NT) {
      const int row = c >> 3, ch = c & 7;
      if (ti0 + row / groups < Tin)
        cp_async16(st + STAGE_H + row * BSB + ch * 16,
                   bits + base + row * L + ch * 16);
    }
  }
  cp_async_commit();
}

// lin = bf16(y) @ w for the 64 columns of w at ``w_cols`` (a shared
// address in the core-matrix layout), y = h * inv + c: the A fragments of
// bf16(y) are formed from the thread's two staged h rows and each
// k-block's wgmma starts as soon as its fragments exist, so the tensor
// cores run under the forming of the next ones. B = w as an MN-major
// operand (K along its rows).
__device__ __forceinline__ void lin_product(float (&acc)[8][4],
                                            const uint32_t* const (&hrow)[2],
                                            const float2* inv2,
                                            const float2* c2,
                                            uint32_t w_cols, int t) {
  uint32_t a[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kb = 0; kb < 8; ++kb) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int cp = kb * 8 + half * 4 + t;    // column pair index
      const float2 iv = inv2[cp], cv = c2[cp];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 hv = unpack_bf16(hrow[r][cp]);
        a[kb][half * 2 + r] = pack_bf16(fmaf(hv.x, iv.x, cv.x),
                                        fmaf(hv.y, iv.y, cv.y));
      }
    }
    wgmma_n64_reg_mn(acc, a[kb], desc_mn_major(w_cols + 2 * kb * BLK_ROW));
  }
  wgmma_commit();
  wgmma_wait<0>();
}

template <bool GLU, int PT, bool DROP>
__global__ void __launch_bounds__(NT, 2)
epilogue_mma_kernel(const __nv_bfloat16* __restrict__ h,
                    const float* __restrict__ inv,
                    const float* __restrict__ cvec,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bvec,
                    const unsigned char* __restrict__ bits, int keep_k,
                    __nv_bfloat16* __restrict__ out, int B, int Tin, int Tout,
                    int pc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // warpgroup nh owns output lanes 32 nh .. + 31; its warp mb the m16
  // tile mb
  const int mb = warp % 4, nh = warp / 4;
  const int pcs = log2i(pc);

  // first input lane of the 8-lane block that pools into output lanes
  // o0 .. o0 + 7 (its partner block is pc lanes further)
  auto in_col = [&](int o0) {
    return ((o0 >> pcs) << (pcs + 1)) + (o0 & (pc - 1));
  };
  // w with its columns permuted in blocks of 8: shared column block
  // 8 nh' + v holds, for v < 4, the block that pools into output lanes
  // (4 nh' + v) * 8 .., and for v >= 4 the partner of block v - 4, so a
  // warpgroup's 64 contiguous columns are its eight n-blocks
  for (int c = tid; c < L * 16; c += NT) {
    const int k = c >> 4, sb = c & 15, v = sb & 7;
    const int src = in_col((4 * (sb >> 3) + (v & 3)) * 8) + (v >= 4 ? pc : 0);
    *reinterpret_cast<uint4*>(smem + blocked(k, sb * 8)) =
        *reinterpret_cast<const uint4*>(w + k * L + src);
  }
  float* vec = reinterpret_cast<float*>(smem + M_VEC);
  for (int i = tid; i < L; i += NT) {
    vec[i] = inv[i];
    vec[L + i] = cvec[i];
    vec[2 * L + i] = bvec[i];
  }
  fence_async_proxy();           // w is read by wgmma after the first barrier
  const float2* inv2 = reinterpret_cast<const float2*>(vec);
  const float2* c2 = inv2 + L / 2;
  const float2* b2 = inv2 + L;

  constexpr int TRO = TRI / PT;                  // output rows per panel
  const int tiles_t = (Tout + TRO - 1) / TRO;
  const int ntiles = B * tiles_t;
  const float keep_scale = DROP ? 256.f / (float)keep_k : 1.f;

  int prow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) prow[r] = panel_row(mb * 16 + g + 8 * r, PT, G);
  const uint32_t w_s = smem_addr(smem);
  unsigned char* outp = smem + M_OUT;

  auto stage_panel = [&](int tile, int stage) {
    const int bi = tile / tiles_t;
    const int ti0 = (tile % tiles_t) * TRI;
    load_panel<DROP>(smem + M_STAGE + stage * STAGE_BYTES, h, bits,
                     ((size_t)bi * Tin + ti0) * G * L, ti0, Tin, G, tid);
  };

  if (blockIdx.x < ntiles) stage_panel(blockIdx.x, 0);
  int stage = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, stage ^= 1) {
    cp_async_wait_all();
    __syncthreads();             // this panel landed; the last one is out
    if (tile + gridDim.x < ntiles) stage_panel(tile + gridDim.x, stage ^ 1);

    const unsigned char* st = smem + M_STAGE + stage * STAGE_BYTES;
    const int bi = tile / tiles_t;
    const int to0 = (tile % tiles_t) * TRO;

    // lin = bf16(y) @ w on the warpgroup's 64 permuted columns:
    // accumulator n-block v < 4 is the warpgroup's output block v, v >= 4
    // its partner
    const uint32_t* const hrow[2] = {
        reinterpret_cast<const uint32_t*>(st + prow[0] * TSB),
        reinterpret_cast<const uint32_t*>(st + prow[1] * TSB)};
    float acc[8][4];
    lin_product(acc, hrow, inv2, c2, w_s + 8 * nh * BLK_COL, t);

    // gate and dropout at the accumulator positions in f32, then both
    // pools in registers: n-block ob and its partner ob + 4, rows r = 0, 1
#pragma unroll
    for (int ob = 0; ob < 4; ++ob) {
      const int o0 = (4 * nh + ob) * 8;          // first output lane
      float z[2][2][2];                          // [partner][row][lane]
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int col = in_col(o0) + p * pc + 2 * t;
        const int cp = col / 2;
        const float2 iv = inv2[cp], cv = c2[cp], bv = b2[cp];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 hv = unpack_bf16(hrow[r][cp]);
          const float y[2] = {fmaf(hv.x, iv.x, cv.x),
                              fmaf(hv.y, iv.y, cv.y)};
          const float lin[2] = {acc[ob + 4 * p][2 * r] + bv.x,
                                acc[ob + 4 * p][2 * r + 1] + bv.y};
          unsigned int kb2 = 0;
          if constexpr (DROP)
            kb2 = *reinterpret_cast<const unsigned short*>(
                st + STAGE_H + prow[r] * BSB + col);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float zz = GLU ? lin[e] * sigmoid_fast(y[e])
                           : y[e] * sigmoid_fast(lin[e]);
            if constexpr (DROP)
              zz = (int)((kb2 >> (8 * e)) & 0xffu) < keep_k ? zz * keep_scale
                                                            : 0.f;
            z[p][r][e] = zz;
          }
        }
      }
      if constexpr (PT == 2) {
        // rows r = 0, 1 are (2 tp, gi), (2 tp + 1, gi): output row tp
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float za = (z[0][0][e] + z[0][1][e]) * 0.5f;
          const float zb = (z[1][0][e] + z[1][1][e]) * 0.5f;
          o[e] = 0.5f * round_dt<__nv_bfloat16>(za) +
                 0.5f * round_dt<__nv_bfloat16>(zb);
        }
        const int orow = (prow[0] / (2 * G)) * G + prow[0] % G;
        *reinterpret_cast<uint32_t*>(outp + orow * BSB + (o0 + 2 * t) * 2) =
            pack_bf16(o[0], o[1]);
      } else {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float o[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            o[e] = 0.5f * round_dt<__nv_bfloat16>(z[0][r][e]) +
                   0.5f * round_dt<__nv_bfloat16>(z[1][r][e]);
          *reinterpret_cast<uint32_t*>(outp + prow[r] * BSB +
                                       (o0 + 2 * t) * 2) =
              pack_bf16(o[0], o[1]);
        }
      }
    }
    __syncthreads();             // the output panel is whole

    __nv_bfloat16* dst = out + ((size_t)bi * Tout + to0) * G * L2;
    for (int c = tid; c < TRO * G * 8; c += NT) {
      const int row = c >> 3, ch = c & 7;
      if (to0 + row / G < Tout)
        *reinterpret_cast<uint4*>(dst + row * L2 + ch * 8) =
            *reinterpret_cast<const uint4*>(outp + row * BSB + ch * 16);
    }
  }
}

// Group-pool form (pool_w = None), bfloat16, on the tensor cores: h (B, T,
// G, 128) with G | 64, rows (t, g) with g fastest; per row the same y,
// lin, gate and dropout as above, then the mean over pt time rows and PG
// adjacent groups in f32, written once in bf16: (B, Tout, G / PG, 128).
// The same persistent blocks, cp.async ring and product as the lane-pool
// body, with w unpermuted: warpgroup nh owns lin columns 64 nh .. + 63.
// The fragment-row map (panel_row) makes a thread's two rows the pool
// pair: the group pair (t, 2 g'), (t, 2 g' + 1) when PG = 2 and pt = 1,
// the time pair when pt = 2; when pt = PG = 2 the other time pair of the
// pool is in the thread 4 lanes away (rows i and i ^ 1 of the m16 tile)
// and one shuffle adds it. The pooled panel leaves through shared memory
// (128-lane rows, 272-byte stride) as 16-byte stores.
template <bool GLU, int PT, int PG, bool DROP>
__global__ void __launch_bounds__(NT, 2)
epilogue_pg_mma_kernel(const __nv_bfloat16* __restrict__ h,
                       const float* __restrict__ inv,
                       const float* __restrict__ cvec,
                       const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ bvec,
                       const unsigned char* __restrict__ bits, int keep_k,
                       __nv_bfloat16* __restrict__ out, int B, int Tin,
                       int Tout, int Gn) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int mb = warp % 4, nh = warp / 4;
  constexpr int RU = PT * PG;                    // input rows an output row

  for (int c = tid; c < L * 16; c += NT) {
    const int k = c >> 4, sb = c & 15;
    *reinterpret_cast<uint4*>(smem + blocked(k, sb * 8)) =
        *reinterpret_cast<const uint4*>(w + k * L + sb * 8);
  }
  float* vec = reinterpret_cast<float*>(smem + M_VEC);
  for (int i = tid; i < L; i += NT) {
    vec[i] = inv[i];
    vec[L + i] = cvec[i];
    vec[2 * L + i] = bvec[i];
  }
  fence_async_proxy();           // w is read by wgmma after the first barrier
  const float2* inv2 = reinterpret_cast<const float2*>(vec);
  const float2* c2 = inv2 + L / 2;
  const float2* b2 = inv2 + L;

  const int tp = ROWS / Gn;                      // time rows a panel
  const int tro = tp / PT;                       // output time rows a panel
  const int gout = Gn / PG;
  const int tiles_t = (Tout + tro - 1) / tro;
  const int ntiles = B * tiles_t;
  const float keep_scale = DROP ? 256.f / (float)keep_k : 1.f;

  int prow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    prow[r] = panel_row(mb * 16 + g + 8 * r, PT, Gn, PG);
  // the output row of the panel this thread writes: its pair index, or
  // half of it when the other pair of the pool is 4 lanes away
  const int q = mb * 8 + g;
  const int orow = RU == 4 ? q / 2 : q;
  const bool writes = RU < 4 || g % 2 == 0;
  const uint32_t w_s = smem_addr(smem);
  unsigned char* outp = smem + M_OUT;

  auto stage_panel = [&](int tile, int stage) {
    const int bi = tile / tiles_t;
    const int ti0 = (tile % tiles_t) * tro * PT;
    load_panel<DROP>(smem + M_STAGE + stage * STAGE_BYTES, h, bits,
                     ((size_t)bi * Tin + ti0) * Gn * L, ti0, Tin, Gn, tid);
  };

  if (blockIdx.x < ntiles) stage_panel(blockIdx.x, 0);
  int stage = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, stage ^= 1) {
    cp_async_wait_all();
    __syncthreads();             // this panel landed; the last one is out
    if (tile + gridDim.x < ntiles) stage_panel(tile + gridDim.x, stage ^ 1);

    const unsigned char* st = smem + M_STAGE + stage * STAGE_BYTES;
    const int bi = tile / tiles_t;
    const int to0 = (tile % tiles_t) * tro;
    const uint32_t* const hrow[2] = {
        reinterpret_cast<const uint32_t*>(st + prow[0] * TSB),
        reinterpret_cast<const uint32_t*>(st + prow[1] * TSB)};
    float acc[8][4];
    lin_product(acc, hrow, inv2, c2, w_s + 8 * nh * BLK_COL, t);

    // gate and dropout at the accumulator positions in f32, then the pool
    // in registers: n-block nb holds columns 64 nh + 8 nb + 2 t, + 1
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int col = nh * 64 + nb * 8 + 2 * t;
      const int cp = col / 2;
      const float2 iv = inv2[cp], cv = c2[cp], bv = b2[cp];
      float z[2][2];                             // [row][lane]
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 hv = unpack_bf16(hrow[r][cp]);
        const float y[2] = {fmaf(hv.x, iv.x, cv.x), fmaf(hv.y, iv.y, cv.y)};
        const float lin[2] = {acc[nb][2 * r] + bv.x, acc[nb][2 * r + 1] + bv.y};
        unsigned int kb2 = 0;
        if constexpr (DROP)
          kb2 = *reinterpret_cast<const unsigned short*>(
              st + STAGE_H + prow[r] * BSB + col);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float zz = GLU ? lin[e] * sigmoid_fast(y[e])
                         : y[e] * sigmoid_fast(lin[e]);
          if constexpr (DROP)
            zz = (int)((kb2 >> (8 * e)) & 0xffu) < keep_k ? zz * keep_scale
                                                          : 0.f;
          z[r][e] = zz;
        }
      }
      if constexpr (RU == 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(outp + prow[r] * TSB + col * 2) =
              pack_bf16(z[r][0], z[r][1]);
      } else {
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          o[e] = z[0][e] + z[1][e];
          if constexpr (RU == 4) o[e] += __shfl_xor_sync(0xffffffffu, o[e], 4);
          o[e] *= 1.f / (float)RU;
        }
        if (writes)
          *reinterpret_cast<uint32_t*>(outp + orow * TSB + col * 2) =
              pack_bf16(o[0], o[1]);
      }
    }
    __syncthreads();             // the output panel is whole

    __nv_bfloat16* dst = out + ((size_t)bi * Tout + to0) * gout * L;
    for (int c = tid; c < (ROWS / RU) * 16; c += NT) {
      const int row = c >> 4, ch = c & 15;
      if (to0 + row / gout < Tout)
        *reinterpret_cast<uint4*>(dst + row * L + ch * 8) =
            *reinterpret_cast<const uint4*>(outp + row * TSB + ch * 16);
    }
  }
}

// Group-pool form (pool_w = None), for standard-layout blocks where the
// group axis is the spatial frequency axis: h (B, T, G, 128) with G | 64,
// rows (t, g) with g fastest. Per row the same y, lin, gate and dropout as
// above; then the mean over pt time rows and PG adjacent groups in f32,
//   out[t', g', l] = mean_{a < pt, c < PG} z[t'*pt + a, g'*PG + c, l],
// written once in the input dtype: (B, Tout, G / PG, 128), no lane matrix.
// This FMA body serves float32 (the bf16 form runs epilogue_pg_mma_kernel).
// Design: the same persistent blocks, w in shared memory (unpermuted) and
// panels of 64 contiguous rows (64 / G time rows); each thread owns 4 panel
// rows that make whole pooling groups (4 / (pt * PG) output rows) and 8
// lanes (two float4 columns, as above), so the pool happens in registers.
template <typename T, bool GLU, int PT, int PG, bool DROP>
__global__ void __launch_bounds__(NT, 2)
epilogue_pg_kernel(const T* __restrict__ h, const float* __restrict__ inv,
                   const float* __restrict__ cvec, const T* __restrict__ w,
                   const float* __restrict__ bvec,
                   const unsigned char* __restrict__ bits, int keep_k,
                   T* __restrict__ out, int B, int Tin, int Tout, int Gn) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int rg = tid / 16, cg = tid % 16;
  const int colA = cg * 4, colB = L2 + cg * 4;

  for (int i = tid; i < L * L; i += NT) s.w[i / L][i % L] = to_f(w[i]);

  constexpr int RU = PT * PG;                    // input rows per output row
  constexpr int UT = TRI / RU;                   // output rows per thread
  const int tp = ROWS / Gn;                      // time rows per panel
  const int gout = Gn / PG;
  const int tro = tp / PT;                       // output time rows per panel
  const int tiles_t = (Tout + tro - 1) / tro;
  const int tv = Tout * PT;                      // input rows that count
  const float keep_scale = DROP ? 256.f / (float)keep_k : 1.f;

  // this thread's output rows u = rg*UT + q of a panel, each pooling the
  // panel rows (to_l*PT + a)*G + go*PG + c, kept in order q*RU + a*PG + c
  int prow[TRI], tl[TRI];
#pragma unroll
  for (int q = 0; q < UT; ++q) {
    const int u = rg * UT + q, to_l = u / gout, go = u % gout;
#pragma unroll
    for (int a = 0; a < PT; ++a)
#pragma unroll
      for (int c = 0; c < PG; ++c) {
        const int i = q * RU + a * PG + c;
        tl[i] = to_l * PT + a;
        prow[i] = tl[i] * Gn + go * PG + c;
      }
  }

  for (int tile = blockIdx.x; tile < B * tiles_t; tile += gridDim.x) {
    const int bi = tile / tiles_t;
    const int to0 = (tile % tiles_t) * tro;
    const int ti0 = to0 * PT;
    const size_t base = ((size_t)bi * Tin + ti0) * Gn * L;

    __syncthreads();                             // ya of the last panel is read
    for (int i = tid * 4; i < ROWS * L; i += NT * 4) {
      const int row = i / L, col = i % L;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (ti0 + row / Gn < tv) load4(h + base + i, v);
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
      for (int tr = 0; tr < TRI; ++tr) load4(&s.ya[prow[tr]][k], a[tr]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float wv[8];
        load4(&s.w[k + kk][colA], wv);
        load4(&s.w[k + kk][colB], wv + 4);
#pragma unroll
        for (int tr = 0; tr < TRI; ++tr)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[tr][j] = fmaf(a[tr][kk], wv[j], acc[tr][j]);
      }
    }

    float z[TRI][8];
#pragma unroll
    for (int tr = 0; tr < TRI; ++tr) {
      float hv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      unsigned int kb[2] = {0u, 0u};
      if (ti0 + tl[tr] < tv) {
        const size_t off = base + (size_t)prow[tr] * L;
        load4(h + off + colA, hv);
        load4(h + off + colB, hv + 4);
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
    for (int q = 0; q < UT; ++q) {
      const int u = rg * UT + q, to = to0 + u / gout, go = u % gout;
      if (to >= Tout) continue;
      float o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float acc_p = z[q * RU][j];
#pragma unroll
        for (int i = 1; i < RU; ++i) acc_p += z[q * RU + i][j];
        o[j] = acc_p * (1.f / (float)RU);
      }
      T* dst = out + (((size_t)bi * Tout + to) * gout + go) * L;
      store4(dst + colA, o);
      store4(dst + colB, o + 4);
    }
  }
}

// The arguments of one forward launch.
struct FwdArgs {
  const void* h;
  const float* inv;
  const float* c;
  const void* w;
  const float* b;
  const unsigned char* bits;
  int keep_k;
  void* out;
  int B, Tin, Tout, G, pc, pg;
};

int grid_size(long tiles) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)(tiles < 2L * sms ? tiles : 2L * sms);
}

template <typename T, bool GLU, int PT, bool DROP>
int launch(const FwdArgs& a, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(epilogue_kernel<T, GLU, PT, DROP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)sizeof(Smem));
    configured = true;
  }
  constexpr int TRO = TRI / PT;
  const int grid = grid_size((long)a.B * ((a.Tout + TRO - 1) / TRO));
  if (grid > 0)
    epilogue_kernel<T, GLU, PT, DROP><<<grid, NT, sizeof(Smem), stream>>>(
        static_cast<const T*>(a.h), a.inv, a.c, static_cast<const T*>(a.w),
        a.b, a.bits, a.keep_k, static_cast<T*>(a.out), a.B, a.Tin, a.Tout,
        a.pc);
  return (int)cudaGetLastError();
}

// The bfloat16 lane pool with pc >= 8: the tensor-core body.
template <bool GLU, int PT, bool DROP>
int launch_mma(const FwdArgs& a, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(epilogue_mma_kernel<GLU, PT, DROP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         MMA_SMEM);
    configured = true;
  }
  constexpr int TRO = TRI / PT;
  const int grid = grid_size((long)a.B * ((a.Tout + TRO - 1) / TRO));
  if (grid > 0)
    epilogue_mma_kernel<GLU, PT, DROP><<<grid, NT, MMA_SMEM, stream>>>(
        static_cast<const __nv_bfloat16*>(a.h), a.inv, a.c,
        static_cast<const __nv_bfloat16*>(a.w), a.b, a.bits, a.keep_k,
        static_cast<__nv_bfloat16*>(a.out), a.B, a.Tin, a.Tout, a.pc);
  return (int)cudaGetLastError();
}

// The bfloat16 group pool: the tensor-core body.
template <bool GLU, int PT, int PG, bool DROP>
int launch_pg_mma(const FwdArgs& a, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(epilogue_pg_mma_kernel<GLU, PT, PG, DROP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         PG_MMA_SMEM);
    configured = true;
  }
  const int tro = ROWS / a.G / PT;
  const int grid = grid_size((long)a.B * ((a.Tout + tro - 1) / tro));
  if (grid > 0)
    epilogue_pg_mma_kernel<GLU, PT, PG, DROP>
        <<<grid, NT, PG_MMA_SMEM, stream>>>(
            static_cast<const __nv_bfloat16*>(a.h), a.inv, a.c,
            static_cast<const __nv_bfloat16*>(a.w), a.b, a.bits, a.keep_k,
            static_cast<__nv_bfloat16*>(a.out), a.B, a.Tin, a.Tout, a.G);
  return (int)cudaGetLastError();
}

template <typename T, bool GLU, int PT, int PG, bool DROP>
int launch_pg(const FwdArgs& a, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(epilogue_pg_kernel<T, GLU, PT, PG, DROP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)sizeof(Smem));
    configured = true;
  }
  const int tro = ROWS / a.G / PT;
  const int grid = grid_size((long)a.B * ((a.Tout + tro - 1) / tro));
  if (grid > 0)
    epilogue_pg_kernel<T, GLU, PT, PG, DROP>
        <<<grid, NT, sizeof(Smem), stream>>>(
            static_cast<const T*>(a.h), a.inv, a.c,
            static_cast<const T*>(a.w), a.b, a.bits, a.keep_k,
            static_cast<T*>(a.out), a.B, a.Tin, a.Tout, a.G);
  return (int)cudaGetLastError();
}

// runtime form -> template instance
template <typename T, bool GLU, int PT, bool DROP>
int run_form(const FwdArgs& a, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    if (a.pc >= 8) return launch_mma<GLU, PT, DROP>(a, st);
    if (a.pc == 0)
      return a.pg == 2 ? launch_pg_mma<GLU, PT, 2, DROP>(a, st)
                       : launch_pg_mma<GLU, PT, 1, DROP>(a, st);
    return launch<T, GLU, PT, DROP>(a, st);
  } else {
    if (a.pc > 0) return launch<T, GLU, PT, DROP>(a, st);
    if (a.pg == 2) return launch_pg<T, GLU, PT, 2, DROP>(a, st);
    return launch_pg<T, GLU, PT, 1, DROP>(a, st);
  }
}

template <typename T, bool GLU, int PT>
int run_drop(const FwdArgs& a, cudaStream_t st) {
  return a.bits != nullptr ? run_form<T, GLU, PT, true>(a, st)
                           : run_form<T, GLU, PT, false>(a, st);
}

template <typename T>
int run_act(const FwdArgs& a, int act, int pt, cudaStream_t st) {
  if (act == 0)
    return pt == 2 ? run_drop<T, true, 2>(a, st) : run_drop<T, true, 1>(a, st);
  return pt == 2 ? run_drop<T, false, 2>(a, st) : run_drop<T, false, 1>(a, st);
}

}  // namespace

// Dynamic shared memory of one block of the lane-pool form, by dtype
// (0 = float32, 1 = bfloat16).
extern "C" int bsed_stem_epilogue_smem_bytes(int dtype) {
  return dtype == 1 ? MMA_SMEM : (int)sizeof(Smem);
}

// The same for the group-pool form.
extern "C" int bsed_stem_epilogue_pg_smem_bytes(int dtype) {
  return dtype == 1 ? PG_MMA_SMEM : (int)sizeof(Smem);
}

// h: (B, Tin, G, 128); w: (128, 128), both in the input dtype
// (0 = float32, 1 = bfloat16); inv, c, b: (128,) float32. act: 0 = GLU,
// 1 = context gating; Tout = Tin // pt. bits: (B, Tin, G, 128) uint8
// dropout bits, keep where bits < keep_k (1..255), or null for the serving
// form. Frequency pool, one of:
//   pc > 0: the pool_w lane pool (G = 16, pg = 1): pool_w averages lanes
//     2q*pc + ch and (2q+1)*pc + ch; out (B, Tout, 16, 64);
//   pc = 0: the group pool pg in {1, 2} (G | 64, (64 / G) % pt = 0,
//     G % pg = 0); out (B, Tout, G / pg, 128).
// out is in the input dtype. Returns cudaGetLastError().
extern "C" int bsed_stem_epilogue(const void* h, const float* inv,
                                  const float* c, const void* w,
                                  const float* b, const void* bits,
                                  int keep_k, void* out, int dtype, int act,
                                  int pt, int B, int Tin, int Tout, int G,
                                  int pc, int pg, void* stream) {
  const bool lane_form =
      pc >= 4 && pc % 4 == 0 && L % (2 * pc) == 0 && G == 16 && pg == 1;
  const bool group_form = pc == 0 && (pg == 1 || pg == 2) && G >= 1 &&
                          ROWS % G == 0 && (ROWS / G) % pt == 0 &&
                          G % pg == 0;
  if (!(lane_form || group_form) || (pt != 1 && pt != 2) ||
      Tout != Tin / pt || dtype < 0 || dtype > 1 || act < 0 || act > 1 ||
      (bits != nullptr && (keep_k < 1 || keep_k > 255)))
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{h, inv, c, w, b, static_cast<const unsigned char*>(bits),
                  keep_k, out, B, Tin, Tout, G, pc, pg};
  const cudaStream_t st = (cudaStream_t)stream;
  return dtype == 1 ? run_act<__nv_bfloat16>(a, act, pt, st)
                    : run_act<float>(a, act, pt, st);
}
