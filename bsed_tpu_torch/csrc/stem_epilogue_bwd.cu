// Kernel K3: folded-stem epilogue, backward (sm_90a). bfloat16 runs on the
// tensor cores (wgmma), float32 in FMA.
//
// Replaces the TPU kernel bsed_tpu/ops/stem_epilogue.py:make_fused_epilogue
// (_run_bwd, body _bwd_kernel) for both frequency pools, the pool_w lane
// pool (LANE) and the group pool pg, with or without dropout bits. Forward:
// kernel K2, csrc/stem_epilogue.cu. Wrapper, autograd Function and plain
// version: bsed_tpu_torch/ops/stem_epilogue.py.
//
// Per panel of h (B, T, G, 128) it recomputes the forward intermediates
// (nothing is saved by the forward) and applies the chain backward:
//   y    = h * inv + c                     (f32; h rows past T // pt * pt
//                                           are zeroed, so no 0 * NaN)
//   lin  = round_dt(y) @ w + b             (f32 accumulation)
//   gd   = gz[pair lane] * 0.5 / pt        (LANE: pool_w^T, the time pool)
//   gd   = gz[g / pg, lane] / (pt * pg)    (group pool: broadcast over the
//                                           pooled group and time rows)
//   gd   = bits < k ? gd * 256 / k : 0     (train form)
//   glu: dlin = gd * s(y);  dy = gd * lin * s(y) (1 - s(y)) + round_dt(dlin) @ w^T
//   cg:  dlin = gd * y * s(lin) (1 - s(lin));  dy = gd * s(lin) + round_dt(dlin) @ w^T
//   dh   = round_dt(dy * inv)
//   dW = y^T dlin (f32 operands), db = sum dlin, dinv = sum dy * h,
//   dc = sum dy
// The parameter reductions are deterministic: each block keeps its partial
// sums in registers over the panels it owns (a fixed grid-stride walk),
// writes them to a workspace, and a second kernel adds the partials in
// block order. No float atomics, so two runs give the same bits.
//
// Bound on the H100: the bytes (gz, h and bits read once, dh written once),
// once the three 128 x 128 products per row run on the tensor cores. Both
// bodies are persistent blocks, one per SM, over panels of 64 contiguous
// rows (t, g), g fastest: 4 time rows of the folded blocks' 16 groups,
// 64 / G time rows in the group-pool form, which takes every G | 64; each
// row reads its own cotangent, so a panel need not hold whole pooling
// groups.
//
// bfloat16 body (epilogue_bwd_mma_kernel; every bf16 form), 8 warps = two
// warpgroups; warpgroup nh owns columns 64 nh .. + 63 of the row products,
// its warp mb the m16 tile mb of the panel (fragment rows, see panel_row):
//   * w sits in shared memory once per block as bf16 in the core-matrix
//     layout (stem_common.cuh): lin reads it as an MN-major operand, w^T
//     is the same tile read K-major. No second copy.
//   * h, bits and gz panels arrive through a 2-deep cp.async ring, 16
//     bytes a thread: the next panel loads while this one computes. h rows
//     that do not count are zero-filled as they are staged, so a NaN
//     there never reaches a product, and their cotangent is masked.
//   * lin = bf16(y) @ w is one chain of eight wgmma.m64n64k16 a warpgroup,
//     its A fragments formed in registers from the staged h and each
//     k-block issued as soon as it exists. The gate runs at the
//     accumulator positions with y recomputed in f32 there; the
//     accumulators then hold the elementwise part of dy, and the second
//     chain dy += bf16(dlin) @ w^T accumulates onto them (A = the dlin hi
//     tile, written by both warpgroups, so one barrier stands between).
//   * dW keeps float32-grade operands on the tensor cores without a y
//     tile: y = h inv + c per lane, so y^T dlin = inv (h^T dlin) + c db^T,
//     and h is exact in bf16. The staged h panel (a core-matrix tile in
//     fragment-row order, its rows that do not count zero-filled) is the
//     A operand as it lies; dlin is split as hi = bf16(x), lo =
//     bf16(x - hi) into two shared tiles, and h^T dl + h^T dh runs as two
//     wgmma.m64n128k16 a 16-row step, both operands transposed by their
//     descriptors, f32 accumulation; warpgroup nh keeps rows 64 nh .. + 63
//     in registers (64 a thread) over all its panels, and the second
//     kernel applies inv and c db^T after the sum over blocks. The chain
//     runs asynchronously under the threads' dh and reduction work. Error
//     budget: bf16 keeps 8 significant bits, so |x - hi| <= 2^-8 |x| and
//     |x - hi - lo| <= 2^-16 |x|: every term of h^T dlin is within 2^-16
//     relative (1.5e-5) of the f32-operand product, against 2^-8 for one
//     pass on bf16(dlin); tests/test_torch_stem_epilogue_train.py holds
//     the whole dW, f32 accumulation included, to 2^-15.
//   * dinv, dc and db are per-thread partials, reduced over the fragment's
//     row lanes by shuffles in a fixed order, then over the four row warps
//     in order.
//   Measured and not kept (slower on the H100): mma.sync m16n8k16 fed by
//   ldmatrix in 8 or 16 warps (shared-memory bandwidth of the fragment
//   loads), dh staged for 16-byte stores (one more barrier), and a third
//   warpgroup that loads the panels and keeps h^T dlin.
//   Shared memory 153,088 bytes (MMA_SMEM), 255 registers a thread: one
//   block an SM.
// float32 body (epilogue_bwd_kernel; every f32 form): FMA products on
// unrounded operands (TF32 would break the 2e-4 gradient gates); w with a
// padded row stride and the panel's y and dlin in f32 in shared memory
// (132 KB); a thread owns 4 panel rows x 8 lanes and an 8 x 8 tile of dW.
#include "stem_common.cuh"

namespace {

constexpr int WS = L + 1;     // padded row stride of w in shared memory
constexpr int NRED = L * L + 3 * L;  // partial sums: dW, dinv, dc, db

struct Smem {
  float w[L][WS];
  float y[ROWS][L];
  float dlin[ROWS][L];
};

template <typename T, bool GLU, int PT, bool DROP, bool LANE>
__global__ void __launch_bounds__(NT, 1)
epilogue_bwd_kernel(const T* __restrict__ gz, const T* __restrict__ h,
                    const float* __restrict__ inv,
                    const float* __restrict__ cvec, const T* __restrict__ w,
                    const float* __restrict__ bvec,
                    const unsigned char* __restrict__ bits, int keep_k,
                    T* __restrict__ dh, float* __restrict__ part, int B,
                    int Tin, int Tout, int pc, int Gn, int pg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  // row products: panel rows rg*4 + i (i < 4), lanes cg + 16*j (j < 8);
  // dW tile: rows rg + 16*i, columns cg + 16*j (i, j < 8)
  const int rg = tid / 16, cg = tid % 16;

  for (int i = tid; i < L * L; i += NT) s.w[i / L][i % L] = to_f(w[i]);

  float inv_r[8], b_r[8];
  int ol[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = cg + 16 * j;
    inv_r[j] = inv[col];
    b_r[j] = bvec[col];
    // the output lane it pools to (lane form; pc = 0 in the group form)
    ol[j] = LANE ? (col / (2 * pc)) * pc + col % pc : col;
  }
  float dw[8][8] = {};
  float dinv_acc[8] = {}, dc_acc[8] = {}, db_acc[8] = {};

  const int gr = LANE ? G : Gn;                  // groups
  const int tp = ROWS / gr;                      // time rows per panel
  const int tro = tp / PT;                       // output rows per panel
  const int gout = LANE ? G : gr / pg;           // gz: (B, Tout, gout, lout)
  const int lout = LANE ? L2 : L;
  const int tiles_t = (Tout + tro - 1) / tro;
  const int tv = Tout * PT;                      // input rows that count
  const float keep_scale = DROP ? 256.f / (float)keep_k : 1.f;
  const float gscale = LANE ? 0.5f / (float)PT : 1.f / (float)(PT * pg);

  for (int tile = blockIdx.x; tile < B * tiles_t; tile += gridDim.x) {
    const int bi = tile / tiles_t;
    const int ti0 = (tile % tiles_t) * tp;
    const size_t base = ((size_t)bi * Tin + ti0) * gr * L;

    __syncthreads();                             // last panel's y, dlin read
    for (int i = tid * 4; i < ROWS * L; i += NT * 4) {
      const int row = i / L, col = i % L;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (ti0 + row / gr < tv) load4(h + base + i, v);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        s.y[row][col + q] = fmaf(v[q], inv[col + q], cvec[col + q]);
    }
    __syncthreads();

    // lin = round_dt(y) @ w for this thread's 4 rows x 8 lanes
    float acc[4][8] = {};
#pragma unroll 4
    for (int k = 0; k < L; ++k) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = round_dt<T>(s.y[rg * 4 + i][k]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float wv = s.w[k][cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], wv, acc[i][j]);
      }
    }

    // pool, dropout and gate backward, elementwise in f32; a thread's rows
    // share one time row in the lane form (G = 16), not in general
    float dyv[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rg * 4 + i;
      const int trow = ti0 + (LANE ? rg / 4 : row / gr);
      const bool valid = trow < tv;
      const int g = row % gr;
      const T* gzr = gz + (((size_t)bi * Tout + trow / PT) * gout
                           + (LANE ? g : g / pg)) * lout;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = cg + 16 * j;
        float gd = 0.f;
        if (valid) {
          gd = to_f(gzr[LANE ? ol[j] : col]) * gscale;
          if constexpr (DROP)
            gd = (int)bits[base + (size_t)row * L + col] < keep_k
                     ? gd * keep_scale : 0.f;
        }
        const float y = s.y[row][col];
        const float lin = acc[i][j] + b_r[j];
        float dl, dy;
        if constexpr (GLU) {
          const float sy = sigmoidf(y);
          dl = gd * sy;
          dy = gd * lin * sy * (1.f - sy);
        } else {
          const float sl = sigmoidf(lin);
          dl = gd * y * sl * (1.f - sl);
          dy = gd * sl;
        }
        s.dlin[row][col] = dl;
        db_acc[j] += dl;
        dyv[i][j] = dy;
      }
    }
    __syncthreads();

    // dy += round_dt(dlin) @ w^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int n = 0; n < L; ++n) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = round_dt<T>(s.dlin[rg * 4 + i][n]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float wv = s.w[cg + 16 * j][n];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], wv, acc[i][j]);
      }
    }

    // dh and the per-lane reductions
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rg * 4 + i;
      const int trow = ti0 + (LANE ? rg / 4 : row / gr);
      const bool valid = trow < tv;
      const size_t off = base + (size_t)row * L;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = cg + 16 * j;
        const float dy = valid ? dyv[i][j] + acc[i][j] : 0.f;
        if (trow < Tin) dh[off + col] = from_f<T>(dy * inv_r[j]);
        if (valid) {
          dc_acc[j] += dy;
          dinv_acc[j] += dy * to_f(h[off + col]);
        }
      }
    }

    // dW += y^T dlin over the panel's rows, f32 operands
#pragma unroll 2
    for (int r = 0; r < ROWS; ++r) {
      float a[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = s.y[r][rg + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = s.dlin[r][cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) dw[i][j] = fmaf(a[i], bv[j], dw[i][j]);
    }
  }

  // per-block partials: the 16 threads of a lane column add in rg order
  __syncthreads();
  float* red = &s.y[0][0];                       // 3 x 16 x 128 floats
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = cg + 16 * j;
    red[(0 * 16 + rg) * L + col] = dinv_acc[j];
    red[(1 * 16 + rg) * L + col] = dc_acc[j];
    red[(2 * 16 + rg) * L + col] = db_acc[j];
  }
  __syncthreads();
  float* out = part + (size_t)blockIdx.x * NRED;
  for (int q = tid; q < 3 * L; q += NT) {
    const int which = q / L, col = q % L;
    float acc = 0.f;
    for (int r = 0; r < 16; ++r) acc += red[(which * 16 + r) * L + col];
    out[L * L + q] = acc;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      out[(rg + 16 * i) * L + cg + 16 * j] = dw[i][j];
}

// Shared memory of the bf16 body: w and the dlin hi / lo tiles in the
// core-matrix layout, inv / c / b, and two stages of (h as a core-matrix
// tile in fragment-row order, raw gz, raw bits).
constexpr int M_TILES = W_BYTES;                       // dlin hi, dlin lo
constexpr int M_VEC = M_TILES + 2 * TILE_BYTES;        // inv, c, b (f32)
constexpr int M_STAGE = M_VEC + 3 * L * 4;
constexpr int S_GZ = TILE_BYTES;                       // within a stage
constexpr int S_BITS = TILE_BYTES + STAGE_H;
constexpr int STAGE_BYTES = TILE_BYTES + STAGE_H + STAGE_BITS;
constexpr int MMA_SMEM = M_STAGE + 2 * STAGE_BYTES;

template <bool GLU, int PT, bool DROP, bool LANE>
__global__ void __launch_bounds__(NT, 1)
epilogue_bwd_mma_kernel(const __nv_bfloat16* __restrict__ gz,
                        const __nv_bfloat16* __restrict__ h,
                        const float* __restrict__ inv,
                        const float* __restrict__ cvec,
                        const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ bvec,
                        const unsigned char* __restrict__ bits, int keep_k,
                        __nv_bfloat16* __restrict__ dh,
                        float* __restrict__ part, int B, int Tin, int Tout,
                        int pc, int Gn, int pg) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // warpgroup nh owns columns 64 nh .. + 63 of the row products and rows
  // 64 nh .. + 63 of dW; its warp mb owns the m16 tile mb
  const int mb = warp % 4, nh = warp / 4;

  for (int c = tid; c < L * 16; c += NT)
    *reinterpret_cast<uint4*>(smem + blocked(c >> 4, (c & 15) * 8)) =
        *reinterpret_cast<const uint4*>(w + (c >> 4) * L + (c & 15) * 8);
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

  const int gr = LANE ? G : Gn;                  // groups
  const int grs = log2i(gr);
  const int tp = ROWS >> grs;                    // time rows per panel
  const int tro = tp / PT;                       // output rows per panel
  const int gout = LANE ? G : gr / pg;           // gz: (B, Tout, gout, lout)
  const int gos = log2i(gout);
  const int lout = LANE ? L2 : L;
  const int gzsb = LANE ? BSB : TSB;             // staged gz row stride
  const int cprs = LANE ? 3 : 4;                 // log2(16-byte chunks a row)
  const int pcs = LANE ? log2i(pc) : 0;
  const int tiles_t = (Tout + tro - 1) / tro;
  const int ntiles = B * tiles_t;
  const int tv = Tout * PT;                      // input rows that count
  // the pools' weight times the dropout scale 256 / k
  const float gscale = (LANE ? 0.5f / (float)PT : 1.f / (float)(PT * pg)) *
                       (DROP ? 256.f / (float)keep_k : 1.f);

  // this thread's two fragment rows: panel row, its time row, staged gz
  // row and the row's offset in the staged h tile
  int prow[2], tl[2], gzoff[2], hoff[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    prow[r] = panel_row(mb * 16 + g + 8 * r, PT, gr);
    tl[r] = prow[r] >> grs;
    const int gi = prow[r] & (gr - 1);
    gzoff[r] = ((tl[r] / PT) * gout + (LANE ? gi : gi / pg)) * gzsb;
    hoff[r] = blocked(mb * 16 + g + 8 * r, 0);
  }
  unsigned char* tiles = smem + M_TILES;
  const uint32_t w_s = smem_addr(smem);
  const uint32_t tiles_s = smem_addr(tiles);

  auto load_panel = [&](int tile, int stage) {
    unsigned char* st = smem + M_STAGE + stage * STAGE_BYTES;
    const int bi = tile / tiles_t;
    const int ti0 = (tile % tiles_t) * tp;
    const size_t base = ((size_t)bi * Tin + ti0) * gr * L;
    // h lands as a core-matrix tile in fragment-row order; rows that do
    // not count (the dropped odd row, the ragged end) are zero-filled
    for (int c = tid; c < ROWS * 16; c += NT) {
      const int row = c >> 4, ch = c & 15;
      unsigned char* dst = st + blocked(fragment_row(row, PT, gr), ch * 8);
      if (ti0 + (row >> grs) < tv)
        cp_async16(dst, h + base + row * L + ch * 8);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    if constexpr (DROP) {
      for (int c = tid; c < ROWS * 8; c += NT) {
        const int row = c >> 3, ch = c & 7;
        if (ti0 + (row >> grs) < Tin)
          cp_async16(st + S_BITS + row * BSB + ch * 16,
                     bits + base + row * L + ch * 16);
      }
    }
    const int to0 = ti0 / PT;
    const size_t gzbase = ((size_t)bi * Tout + to0) * gout * lout;
    for (int c = tid; c < ((tro * gout) << cprs); c += NT) {
      const int row = c >> cprs, ch = c & ((1 << cprs) - 1);
      if (to0 + (row >> gos) < Tout)
        cp_async16(st + S_GZ + row * gzsb + ch * 16,
                   gz + gzbase + (size_t)row * lout + ch * 8);
    }
    cp_async_commit();
  };

  float dw[16][4] = {};                          // rows of h^T dlin
  float dinv_acc[8][2] = {}, dc_acc[8][2] = {}, db_acc[8][2] = {};

  if (blockIdx.x < ntiles) load_panel(blockIdx.x, 0);
  int stage = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, stage ^= 1) {
    cp_async_wait_all();
    wgmma_wait<0>();             // the last panel's dW has read its tiles
    __syncthreads();             // this panel landed; the last one is done
    if (tile + gridDim.x < ntiles) load_panel(tile + gridDim.x, stage ^ 1);

    const unsigned char* st = smem + M_STAGE + stage * STAGE_BYTES;
    const int bi = tile / tiles_t;
    const int ti0 = (tile % tiles_t) * tp;
    const size_t base = ((size_t)bi * Tin + ti0) * gr * L;
    const bool valid[2] = {ti0 + tl[0] < tv, ti0 + tl[1] < tv};
    const uint32_t st_s = smem_addr(st);
    // staged h of this thread's rows: column pair cp is bf16 pair
    // hpair(r, cp)
    auto hpair = [&](int r, int cp) {
      return unpack_bf16(*reinterpret_cast<const uint32_t*>(
          st + hoff[r] + (cp >> 2) * BLK_COL + (cp & 3) * 4));
    };

    // lin = bf16(y) @ w: A fragments formed from the staged h, B = w as
    // an MN-major operand (K along its rows)
    // each k-block's wgmma is issued as soon as its fragments exist, so
    // the tensor cores run under the forming of the next ones
    uint32_t a[8][4];
    float acc[8][4] = {};
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < 8; ++kb) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int cp = kb * 8 + half * 4 + t;    // column pair index
        const float2 iv = inv2[cp], cv = c2[cp];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 hv = hpair(r, cp);
          a[kb][half * 2 + r] = pack_bf16(fmaf(hv.x, iv.x, cv.x),
                                          fmaf(hv.y, iv.y, cv.y));
        }
      }
      wgmma_n64_reg_mn(acc, a[kb], desc_mn_major(w_s + 2 * kb * BLK_ROW +
                                                 8 * nh * BLK_COL));
    }
    wgmma_commit();
    wgmma_wait<0>();

    // pool, dropout and gate backward at the accumulator positions, in
    // f32; acc becomes the elementwise part of dy, dlin goes to its hi/lo
    // tiles
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int col = nh * 64 + nb * 8 + 2 * t;
      const int cp = col / 2;
      const float2 iv = inv2[cp], cv = c2[cp], bv = b2[cp];
      const int ocol =
          LANE ? ((col >> (pcs + 1)) << pcs) + (col & (pc - 1)) : col;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 hv = hpair(r, cp);
        float2 gd = make_float2(0.f, 0.f);
        if (valid[r]) {
          gd = unpack_bf16(*reinterpret_cast<const uint32_t*>(
              st + S_GZ + gzoff[r] + ocol * 2));
          gd.x *= gscale;
          gd.y *= gscale;
          if constexpr (DROP) {
            const unsigned int kb2 = *reinterpret_cast<const unsigned short*>(
                st + S_BITS + prow[r] * BSB + col);
            if ((int)(kb2 & 0xffu) >= keep_k) gd.x = 0.f;
            if ((int)(kb2 >> 8) >= keep_k) gd.y = 0.f;
          }
        }
        const float y[2] = {fmaf(hv.x, iv.x, cv.x), fmaf(hv.y, iv.y, cv.y)};
        const float gdv[2] = {gd.x, gd.y};
        const float bb[2] = {bv.x, bv.y};
        float dl[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float lin = acc[nb][2 * r + e] + bb[e];
          float dy;
          if constexpr (GLU) {
            const float sy = sigmoid_fast(y[e]);
            dl[e] = gdv[e] * sy;
            dy = gdv[e] * lin * sy * (1.f - sy);
          } else {
            const float sl = sigmoid_fast(lin);
            dl[e] = gdv[e] * y[e] * sl * (1.f - sl);
            dy = gdv[e] * sl;
          }
          db_acc[nb][e] += dl[e];
          acc[nb][2 * r + e] = dy;
        }
        uint32_t hi, lo;
        const int off = hoff[r] + (cp >> 2) * BLK_COL + (cp & 3) * 4;
        split_bf16(dl[0], dl[1], hi, lo);
        *reinterpret_cast<uint32_t*>(tiles + off) = hi;
        *reinterpret_cast<uint32_t*>(tiles + TILE_BYTES + off) = lo;
      }
    }
    fence_async_proxy();
    __syncthreads();             // the two tiles are whole

    // dy += bf16(dlin) @ w^T: A = the dlin hi tile, B = w, both K-major
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < 8; ++kb)
      wgmma_n64_k_k(acc,
                    desc_k_major(tiles_s + 2 * kb * BLK_COL),
                    desc_k_major(w_s + 8 * nh * BLK_ROW + 2 * kb * BLK_COL));
    wgmma_commit();

    // (h^T dlin)[64 nh .. + 63][:] += h^T dl + h^T dh over the panel's 64
    // rows, both operands MN-major (K along the tiles' rows); it runs on
    // while the threads finish dy below
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t ha =
          desc_mn_major(st_s + 2 * ks * BLK_ROW + 8 * nh * BLK_COL);
      const uint32_t da = tiles_s + 2 * ks * BLK_ROW;
      wgmma_n128_mn_mn(dw, ha, desc_mn_major(da + TILE_BYTES));
      wgmma_n128_mn_mn(dw, ha, desc_mn_major(da));
    }
    wgmma_commit();
    wgmma_wait<1>();             // dy is whole; dW may still run

    // dh, 4 bytes a thread (a warp fills 128 contiguous bytes of a row
    // over its eight n-blocks; staging it for 16-byte stores costs a
    // barrier and measured slower), and the per-lane reductions
    __nv_bfloat16* dhrow[2] = {dh + base + prow[0] * L,
                               dh + base + prow[1] * L};
    const bool inside[2] = {ti0 + tl[0] < Tin, ti0 + tl[1] < Tin};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int cp = nh * 32 + nb * 4 + t;
      const float2 iv = inv2[cp];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 hv = hpair(r, cp);
        float dy0 = acc[nb][2 * r], dy1 = acc[nb][2 * r + 1];
        if (!valid[r]) dy0 = dy1 = 0.f;
        dc_acc[nb][0] += dy0;
        dc_acc[nb][1] += dy1;
        dinv_acc[nb][0] = fmaf(dy0, hv.x, dinv_acc[nb][0]);
        dinv_acc[nb][1] = fmaf(dy1, hv.y, dinv_acc[nb][1]);
        if (inside[r])
          reinterpret_cast<uint32_t*>(dhrow[r])[cp] =
              pack_bf16(dy0 * iv.x, dy1 * iv.y);
      }
    }
  }

  // per-block partials. dinv, dc, db: over the 8 row lanes by shuffles in
  // a fixed order, then over the 4 row warps in order.
  wgmma_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(tiles);  // [3][4][128]
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v[3] = {dinv_acc[nb][e], dc_acc[nb][e], db_acc[nb][e]};
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        v[q] += __shfl_xor_sync(0xffffffffu, v[q], 4);
        v[q] += __shfl_xor_sync(0xffffffffu, v[q], 8);
        v[q] += __shfl_xor_sync(0xffffffffu, v[q], 16);
        if (g == 0)
          red[(q * 4 + mb) * L + nh * 64 + nb * 8 + 2 * t + e] = v[q];
      }
    }
  __syncthreads();
  float* out = part + (size_t)blockIdx.x * NRED;
  for (int q = tid; q < 3 * L; q += NT) {
    const int which = q / L, col = q % L;
    float a = 0.f;
    for (int r = 0; r < 4; ++r) a += red[(which * 4 + r) * L + col];
    out[L * L + q] = a;
  }
#pragma unroll
  for (int nb = 0; nb < 16; ++nb)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(out + (nh * 64 + mb * 16 + g + 8 * r) * L +
                                 nb * 8 + 2 * t) =
          make_float2(dw[nb][2 * r], dw[nb][2 * r + 1]);
}

// Second stage: add the per-block partials in block order. The bf16 body
// leaves h^T dlin in the dW slots (affine): dW = inv (h^T dlin) + c db^T.
__global__ void reduce_partials(const float* __restrict__ part, int nblk,
                                bool affine, const float* __restrict__ inv,
                                const float* __restrict__ cvec,
                                float* __restrict__ dw,
                                float* __restrict__ dinv,
                                float* __restrict__ dc,
                                float* __restrict__ db) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= NRED) return;
  float acc = 0.f;
  for (int b = 0; b < nblk; ++b) acc += part[(size_t)b * NRED + q];
  if (q < L * L) {
    if (affine) {
      const int m = q / L, n = q % L;
      float dbn = 0.f;
      for (int b = 0; b < nblk; ++b)
        dbn += part[(size_t)b * NRED + L * L + 2 * L + n];
      acc = fmaf(inv[m], acc, cvec[m] * dbn);
    }
    dw[q] = acc;
  } else if (q < L * L + L) dinv[q - L * L] = acc;
  else if (q < L * L + 2 * L) dc[q - L * L - L] = acc;
  else db[q - L * L - 2 * L] = acc;
}

// The arguments of one backward launch.
struct BwdArgs {
  const void* gz;
  const void* h;
  const float* inv;
  const float* c;
  const void* w;
  const float* b;
  const unsigned char* bits;
  int keep_k;
  void* dh;
  float* part;
  int nblk, B, Tin, Tout, G, pc, pg;
};

// float32 takes the FMA body, bfloat16 the tensor-core body.
template <typename T, bool GLU, int PT, bool DROP, bool LANE>
int launch(const BwdArgs& a, cudaStream_t stream) {
  static bool configured = false;
  if constexpr (sizeof(T) == 4) {
    if (!configured) {
      cudaFuncSetAttribute(epilogue_bwd_kernel<T, GLU, PT, DROP, LANE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sizeof(Smem));
      configured = true;
    }
    if (a.nblk > 0)
      epilogue_bwd_kernel<T, GLU, PT, DROP, LANE>
          <<<a.nblk, NT, sizeof(Smem), stream>>>(
              static_cast<const T*>(a.gz), static_cast<const T*>(a.h), a.inv,
              a.c, static_cast<const T*>(a.w), a.b, a.bits, a.keep_k,
              static_cast<T*>(a.dh), a.part, a.B, a.Tin, a.Tout, a.pc, a.G,
              a.pg);
  } else {
    if (!configured) {
      cudaFuncSetAttribute(epilogue_bwd_mma_kernel<GLU, PT, DROP, LANE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MMA_SMEM);
      configured = true;
    }
    if (a.nblk > 0)
      epilogue_bwd_mma_kernel<GLU, PT, DROP, LANE>
          <<<a.nblk, NT, MMA_SMEM, stream>>>(
              static_cast<const T*>(a.gz), static_cast<const T*>(a.h), a.inv,
              a.c, static_cast<const T*>(a.w), a.b, a.bits, a.keep_k,
              static_cast<T*>(a.dh), a.part, a.B, a.Tin, a.Tout, a.pc, a.G,
              a.pg);
  }
  return (int)cudaGetLastError();
}

// runtime form -> template instance
template <typename T, bool GLU, int PT>
int run_drop(const BwdArgs& a, cudaStream_t st) {
  const bool lane = a.pc > 0;
  if (a.bits != nullptr)
    return lane ? launch<T, GLU, PT, true, true>(a, st)
                : launch<T, GLU, PT, true, false>(a, st);
  return lane ? launch<T, GLU, PT, false, true>(a, st)
              : launch<T, GLU, PT, false, false>(a, st);
}

template <typename T>
int run_act(const BwdArgs& a, int act, int pt, cudaStream_t st) {
  if (act == 0)
    return pt == 2 ? run_drop<T, true, 2>(a, st) : run_drop<T, true, 1>(a, st);
  return pt == 2 ? run_drop<T, false, 2>(a, st) : run_drop<T, false, 1>(a, st);
}

}  // namespace

// The number of floats of workspace one block of the backward writes.
extern "C" int bsed_stem_epilogue_bwd_partial_size() { return NRED; }

// Dynamic shared memory of one block, by dtype (0 = float32, 1 = bfloat16).
extern "C" int bsed_stem_epilogue_bwd_smem_bytes(int dtype) {
  return dtype == 1 ? MMA_SMEM : (int)sizeof(Smem);
}

// h, dh: (B, Tin, G, 128) and gz: the forward's output shape, all in the
// input dtype (0 = float32, 1 = bfloat16), as is w (128, 128); inv, c, b:
// (128,) float32; bits: (B, Tin, G, 128) uint8 (keep where bits < keep_k)
// or null. Outputs: dh, and dw (128, 128), dinv, dc, db (128,) float32.
// part: workspace of max_blocks * bsed_stem_epilogue_bwd_partial_size()
// floats; the grid is min(max_blocks, panels). act: 0 = GLU, 1 = context
// gating. Frequency pool as in csrc/stem_epilogue.cu: pc > 0 the lane pool
// (G = 16, pg = 1, gz (B, Tout, 16, 64)); pc = 0 the group pool pg in
// {1, 2} (G | 64, (64 / G) % pt = 0, G % pg = 0, gz (B, Tout, G / pg,
// 128)). Returns the first nonzero cudaError_t of the two launches.
extern "C" int bsed_stem_epilogue_bwd(const void* gz, const void* h,
                                      const float* inv, const float* c,
                                      const void* w, const float* b,
                                      const void* bits, int keep_k, void* dh,
                                      float* dw, float* dinv, float* dc,
                                      float* db, float* part, int max_blocks,
                                      int dtype, int act, int pt, int B,
                                      int Tin, int Tout, int G, int pc,
                                      int pg, void* stream) {
  const bool lane_form =
      pc >= 4 && pc % 4 == 0 && L % (2 * pc) == 0 && G == 16 && pg == 1;
  const bool group_form = pc == 0 && (pg == 1 || pg == 2) && G >= 1 &&
                          ROWS % G == 0 && (ROWS / G) % pt == 0 &&
                          G % pg == 0;
  if (!(lane_form || group_form) || (pt != 1 && pt != 2) ||
      Tout != Tin / pt || dtype < 0 || dtype > 1 || act < 0 || act > 1 ||
      max_blocks < 1 || (bits != nullptr && (keep_k < 1 || keep_k > 255)))
    return (int)cudaErrorInvalidValue;
  const int tro = ROWS / G / pt;
  const long tiles = (long)B * ((Tout + tro - 1) / tro);
  const int nblk = (int)(tiles < max_blocks ? tiles : max_blocks);
  const BwdArgs a{gz, h, inv, c, w, b, static_cast<const unsigned char*>(bits),
                  keep_k, dh, part, nblk, B, Tin, Tout, G, pc, pg};
  const cudaStream_t st = (cudaStream_t)stream;
  const int err = dtype == 1 ? run_act<__nv_bfloat16>(a, act, pt, st)
                             : run_act<float>(a, act, pt, st);
  if (err != 0) return err;
  reduce_partials<<<(NRED + 255) / 256, 256, 0, st>>>(
      part, nblk, dtype == 1, inv, c, dw, dinv, dc, db);
  return (int)cudaGetLastError();
}
