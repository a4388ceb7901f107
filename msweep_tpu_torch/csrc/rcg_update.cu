// K2: pass 2 of one implicit rcg iteration, the update (one or two softmaxes).
//
// Replaces the TPU kernel msweep_tpu/ops/rcg_pallas.py rcg_update /
// _update_kernel, and its float64 twins msweep_tpu/ops/rcg_xla.py
// rcg_update and rcg_bound_stats.  With gamma = masked row softmax of
// c * logL + v and row(c, v) = sum_g w * (logL - gamma),
// w = counts * exp(gamma) (taken as exp(ghat - m) * (cnt / denom)), it
// returns
//
//     colsum_g = sum_e w_eg at (c_new, v_new)                  (G,)
//     scalar   = sum_e (row(c_new, v_new) - row(c_old, v_old))  delta mode
//              = sum_e row(c_new, v_new)                        absolute mode
//
// The delta mode is the ELBO data-term change of one step, differenced per
// row so that nearly equal row terms cancel before the cross-row sum.  Both
// row terms come from one device function (rcg_common.cuh data_row) with one
// reduction order, so the new term at (c, v) in one iteration rounds as the
// old term at the same (c, v) in the next.  With rows_old not null the old
// terms are K1's of the same iteration (rcg_norm.cu; norm_row's DATA gives
// data_row's bits), so the delta keeps its bits and K2 takes one softmax,
// one exp a cell; a tile's terms come into shared memory by cp.async while
// phase A runs, and the thread that adds the rows subtracts them in the
// compute type.  With rows_old null K2 takes the old softmax itself.  The
// absolute mode is the exact-bound pass of the escalation supervisor and
// the implicit init at (c, v) = (0, 0).  One division per row where the plain version divides
// per cell; the rtol the kernel is held to (1e-5 / 1e-12) covers it.
//
// Bound: one read of logL, 4 B/cell in float32.  The work per cell holds it
// above that: a correctly rounded exp for each softmax it takes and ~12
// other operations for each, and in float64 compute the FP64 exps.  The design
// does the least of that work.  A CTA walks its contiguous rows in tiles.
// Phase A: a warp holds its row in registers (16 cells a lane for
// G <= 512, 16-byte loads), so each cell of logL is read once from memory;
// v_old and v_new stay in registers across all the CTA's rows; each
// softmax takes one exp per cell, and the new one's weights w serve both
// the row term and the column sums: phase A writes them into the tile's
// rows in shared memory (as many rows as fit the CTAs an SM).  Phase B:
// one thread per column adds the tile's w into the CTA's own row of the
// (n_cta, G) double partials in row order, with no re-read of logL and no
// second exp.  A row of weights too wide for shared memory (G beyond
// about 29,000 on an H100) runs direct: one warp takes the CTA's rows in order and adds w
// into the partials itself, the same adds in the same order, so the same
// bits.  No atomics.  Left for later work: TMA bulk loads,
// prefetching the next row, and holding the column partials in registers.
//
// c_old, c_new and the done flag come by device pointer, as in K1
// (rcg_norm.cu): when *done is set every CTA writes zero partials and
// returns without reading logL.
#include "rcg_common.cuh"

namespace rcg {

// What phase A takes for a row: the new softmax's term alone (the absolute
// mode), less the old softmax's term (the delta mode, both softmaxes), or
// less K1's row term (the delta mode against K1's row terms).
enum UpdateMode { ABSOLUTE, OWN_OLD, HANDED };

// The CTA's rows from its first tile: phase A and phase B of each tile,
// then its partials.  One body per mode, so that no mode holds the
// registers of another's operands (v_old's columns in OWN_OLD).
template <typename LT, typename CT, UpdateMode MODE>
__device__ __forceinline__ void update_rows(
    const LT* __restrict__ logL, const LT* __restrict__ counts, CT c_old,
    const CT* __restrict__ v_old, CT c_new, const CT* __restrict__ v_new,
    const CT* __restrict__ rows_old, int64_t lo, int64_t hi, int64_t G, bool vec, int tile,
    CT* __restrict__ wt, CT* __restrict__ rowres, CT* __restrict__ rowold,
    double* __restrict__ cols, double* __restrict__ part_scalar) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nch = (int)((G + CHUNK - 1) / CHUNK);
  // tile 0: a row of weights does not fit shared memory, so warp 0 takes
  // the rows one by one and adds its w straight into the column partials.
  const bool direct = tile == 0;
  const int step = direct ? 1 : tile;
  LT L[NPL];
  CT vn[NPL], vo[NPL], w[NPL];
  load_cols(v_new, 0, G, lane, vn);
  if (MODE == OWN_OLD) load_cols(v_old, 0, G, lane, vo);
  double acc = 0.0;  // read by thread 0 only
  for (int64_t t0 = lo; t0 < hi; t0 += step) {
    const int nr = (int)((hi - t0 < step) ? hi - t0 : step);
    // K1's row terms of the tile, copied to shared memory while phase A runs.
    if (MODE == HANDED) {
      if (threadIdx.x < nr)
        cp_async<(int)sizeof(CT)>(rowold + threadIdx.x, rows_old + t0 + threadIdx.x);
      cp_async_commit();
    }
    // Phase A: row terms and the tile's weights, one warp per row.
    for (int r = warp; r < nr; r += WARPS) {
      const LT* row = logL + (t0 + r) * G;
      const CT cnt = (CT)counts[t0 + r];
      load_row_chunk(row, 0, G, vec, lane, L);
      CT res = data_row<LT, CT>(row, G, vec, nch, lane, cnt, c_new, v_new, L, vn,
                                direct ? nullptr : wt + (int64_t)r * G, direct ? cols : nullptr,
                                w);
      if (MODE == OWN_OLD)
        res = res - data_row<LT, CT>(row, G, vec, nch, lane, cnt, c_old, v_old, L, vo, nullptr,
                                     nullptr, w);
      if (lane == 0) rowres[r] = res;
    }
    if (MODE == HANDED) cp_async_wait<0>();
    __syncthreads();
    if (threadIdx.x == 0) {  // a row's difference rounds in CT, as it does with OWN_OLD
      for (int r = 0; r < nr; ++r)
        acc += (double)(MODE == HANDED ? rowres[r] - rowold[r] : rowres[r]);
    }
    // Phase B: column partials of the tile's w, rows in order.
    if (!direct) {
      for (int64_t g = threadIdx.x; g < G; g += THREADS) {
        double s = cols[g];
        for (int r = 0; r < nr; ++r) s += (double)wt[(int64_t)r * G + g];
        cols[g] = s;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) part_scalar[blockIdx.x] = acc;
}

template <typename LT, typename CT>
__global__ void __launch_bounds__(THREADS, MinCtas<CT>::value)
rcg_update_kernel(const LT* __restrict__ logL, const LT* __restrict__ counts,
                  const CT* __restrict__ c_old_ptr, const CT* __restrict__ v_old,
                  const CT* __restrict__ c_new_ptr, const CT* __restrict__ v_new,
                  const CT* __restrict__ rows_old, const bool* __restrict__ done, int absolute,
                  int64_t E, int64_t G, bool vec, int64_t rows_per_cta, int tile,
                  double* __restrict__ part_scalar, double* __restrict__ part_cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  CT* __restrict__ wt = reinterpret_cast<CT*>(smem);  // (tile, G) weights of the new softmax
  __shared__ CT rowres[TILE_ROWS], rowold[TILE_ROWS];
  int64_t lo, hi;
  cta_rows(E, rows_per_cta, lo, hi);
  double* __restrict__ cols = part_cols + (int64_t)blockIdx.x * G;
  for (int64_t g = threadIdx.x; g < G; g += THREADS) cols[g] = 0.0;
  if (done != nullptr && *done) {  // the same on every thread of the CTA
    if (threadIdx.x == 0) part_scalar[blockIdx.x] = 0.0;
    return;
  }
  __syncthreads();
  const CT c_new = *c_new_ptr;
  if (absolute)
    update_rows<LT, CT, ABSOLUTE>(logL, counts, c_new, v_old, c_new, v_new, rows_old, lo, hi,
                                  G, vec, tile, wt, rowres, rowold, cols, part_scalar);
  else if (rows_old == nullptr)
    update_rows<LT, CT, OWN_OLD>(logL, counts, *c_old_ptr, v_old, c_new, v_new, rows_old, lo,
                                 hi, G, vec, tile, wt, rowres, rowold, cols, part_scalar);
  else
    update_rows<LT, CT, HANDED>(logL, counts, c_new, v_old, c_new, v_new, rows_old, lo, hi, G,
                                vec, tile, wt, rowres, rowold, cols, part_scalar);
}

template <typename LT, typename CT>
static int launch_update(const void* logL, const void* counts, const void* c_old,
                         const void* v_old, const void* c_new, const void* v_new,
                         const void* rows_old, const void* done, int absolute, int64_t E,
                         int64_t G, int64_t rows_per_cta, int64_t n_cta, void* part_scalar,
                         void* part_cols, void* out_scalar, void* out_cols,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  static WtileBudget cache;
  int64_t budget = 0;
  cudaError_t err = wtile_budget((const void*)rcg_update_kernel<LT, CT>, MinCtas<CT>::value,
                                 cache, budget);
  if (err != cudaSuccess) return (int)err;
  const int64_t row_bytes = (G > 0 ? G : 1) * (int64_t)sizeof(CT);
  const int tile = wtile_rows(budget, row_bytes);
  const size_t smem = (size_t)tile * row_bytes;
  rcg_update_kernel<LT, CT><<<(unsigned)n_cta, THREADS, smem, s>>>(
      (const LT*)logL, (const LT*)counts, (const CT*)c_old, (const CT*)v_old, (const CT*)c_new,
      (const CT*)v_new, (const CT*)rows_old, (const bool*)done, absolute, E, G,
      vector_rows(logL, G), rows_per_cta, tile, (double*)part_scalar, (double*)part_cols);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rcg_reduce_scalar<<<1, 32, 0, s>>>((const double*)part_scalar, n_cta,
                                     (double*)out_scalar);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (G + 255) / 256;
  rcg_reduce_cols<<<(unsigned)(blocks > 0 ? blocks : 1), 256, 0, s>>>(
      (const double*)part_cols, n_cta, G, (double*)out_cols);
  return (int)cudaGetLastError();
}

}  // namespace rcg

// Plain C entry points, one per instantiation (matrix type _ compute type).
// c_old and c_new are one scalar each in the compute type, rows_old E
// values in the compute type or null, done one bool or null (never done);
// part_scalar is scratch of n_cta doubles, part_cols of n_cta * G doubles;
// out_scalar is one double, out_cols G doubles; all on the device.  In
// absolute mode rows_old, v_old and c_old are not read, and in delta mode
// with rows_old not null neither are v_old and c_old.  Returns a CUDA error.
#define RCG_UPDATE_ENTRY(NAME, LT, CT)                                                     \
  extern "C" int NAME(const void* logL, const void* counts, const void* c_old,             \
                      const void* v_old, const void* c_new, const void* v_new,             \
                      const void* rows_old, const void* done, int absolute, int64_t E,     \
                      int64_t G, int64_t rows_per_cta, int64_t n_cta, void* part_scalar,   \
                      void* part_cols, void* out_scalar, void* out_cols, void* stream) {   \
    return rcg::launch_update<LT, CT>(logL, counts, c_old, v_old, c_new, v_new, rows_old, \
                                      done, absolute, E, G, rows_per_cta, n_cta,          \
                                      part_scalar, part_cols, out_scalar, out_cols,       \
                                      stream);                                            \
  }

RCG_UPDATE_ENTRY(rcg_update_f32_f32, float, float)
RCG_UPDATE_ENTRY(rcg_update_f32_f64, float, double)
RCG_UPDATE_ENTRY(rcg_update_f64_f64, double, double)
