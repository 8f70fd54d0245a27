// Kernel K3: folded-stem epilogue, backward (sm_90a, float32 FMA).
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
// Bound on the H100: the three 128 x 128 products per row (lin, dlin @ w^T,
// y^T dlin), which this first kernel runs in f32 FMA; the bytes (gz, h, bits
// read once, dh written once) take less. Design: persistent blocks, one per
// SM (132 KB of shared memory: w with a padded row stride so both w and
// w^T reads are conflict-free, and the panel's y and dlin in f32). A panel
// is 64 contiguous rows (t, g), g fastest: 4 time rows of the folded
// blocks' 16 groups, 64 / G time rows in the group-pool form, which takes
// every G | 64; each row reads its own cotangent, so a panel need not hold
// whole pooling groups. A thread owns 4 panel rows x 8 lanes for the row
// products and an 8 x 8 tile of dW.
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

// Second stage: add the per-block partials in block order.
__global__ void reduce_partials(const float* __restrict__ part, int nblk,
                                float* __restrict__ dw,
                                float* __restrict__ dinv,
                                float* __restrict__ dc,
                                float* __restrict__ db) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= NRED) return;
  float acc = 0.f;
  for (int b = 0; b < nblk; ++b) acc += part[(size_t)b * NRED + q];
  if (q < L * L) dw[q] = acc;
  else if (q < L * L + L) dinv[q - L * L] = acc;
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

template <typename T, bool GLU, int PT, bool DROP, bool LANE>
int launch(const BwdArgs& a, cudaStream_t stream) {
  static bool configured = false;
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
  reduce_partials<<<(NRED + 255) / 256, 256, 0, st>>>(part, nblk, dw, dinv,
                                                       dc, db);
  return (int)cudaGetLastError();
}
