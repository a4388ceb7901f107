// K5: one EM iteration (the "emgpu" algorithm) in one pass over logL.
//
// Replaces the TPU kernel msweep_tpu/ops/em_pallas.py em_step / _em_kernel.
// With t = logL + log(theta) (logtheta is NEG where theta = 0), it returns
//
//     lse_e    = logsumexp_g t_eg                                   (E,)
//     colsum_g = sum_e counts_e * exp(t_eg - lse_e)                 (G,)
//     ddot     = sum_e counts_e * (lse_e - lse_prev_e)              scalar
//
// colsum is the M-step's sufficient statistic and ddot the deferred change
// of the objective's data term (msweep_tpu/inference/em.py _make_step):
// per-row differences of nearly equal logsumexps, so the change stays
// accurate near convergence.  lse is written in the compute type, the type
// lse_prev is read in, so the differences are the ones the JAX step takes.
// counts * exp(t - lse) is taken as exp(t - max) * (counts / denom), one
// division per row, as the TPU kernel takes (c / s) * e.
//
// Bound: one read of logL (4 or 8 B/cell) in both types.  The work per
// cell is one exp and ~6 other operations; in float64 the exp is 18 FP64
// instructions (msweep_tpu_torch/exp_cost.py), which puts the operations
// bound (~1.7 ms at 2,301,952 x 512) below the bytes bound (2.83 ms): the
// FP64 exp chain's latency and the registers it takes are what the design
// must hide.  The design is K2's: a CTA walks its contiguous rows in tiles.
// The row ranges are the ones K6 (em_step_batch.cu) runs on, so that its
// replicates give K5's bits: lcm(K5's CTAs an SM, K6's) x SMs ranges of
// whole tiles (rcg_common.cuh split_rows, ops/rcg_kernels.py em_ranges), a
// whole number of waves for both kernels.  So K5's numerics follow K6's
// build: a change to K6's CTAs an SM (em_step_batch.cu RepBuild::ctas)
// moves K5's row ranges, and K5's bits by float64 round-off.
// Rows of one chunk (G <= 512) run an instantiation compiled for one chunk
// at three CTAs an SM, in float64 too, so that one CTA's exps overlap the
// others' loads and phase B.  Phase A: a warp holds its row in registers
// (16 cells a lane, 16-byte loads), so each cell of logL is read once from
// memory; one exp per cell gives the row's max, exp sum and lse
// (rcg_common.cuh em_row_stats), and the kept exps times cnt / denom are
// the weights w, written into the tile's rows in shared memory; the row's
// ddot term waits in shared memory and is added into the CTA's float64
// partial in row order.  Phase B: one thread per column adds the tile's w
// into its columns of the CTA's partials in row order, with no re-read of
// logL and no second exp; a thread keeps its two columns in registers
// across the tiles and writes them once at the end.  Three CTAs leave 85
// registers a thread, so logtheta is read from L1 for each row rather
// than held in registers.  The exps are K6's, rcg_common.cuh row_exps: in
// float64 CUDA's exp with its branches taken as selects, so a row's 16
// exps interleave whatever their arguments.
// Wider rows run the general instantiation at two CTAs an SM, on tiles of
// at least 8 rows, one a warp, whatever G: phase A merges a row's chunks
// into its max and exp sum; then, a slab of columns at a time (as many
// chunks as 8 rows of weights fit in the CTA's shared memory: 1,536
// columns in float64, 3,584 in float32 on an H100), each warp reads its
// row's chunks in the slab again and takes w with a second exp
// (em_chunk_w) into the slab's tile, and phase B adds the slab's columns
// in row order.  So a wide row costs two reads and two exps per cell, and
// no warp idles for want of shared memory.  The weights, and the order of
// the adds into each column, do not depend on the tile or the slab.
// No atomics: the second stage sums the partials in CTA order, so a rerun
// gives the same bits.  Padding: NEG cells (and NEG + NEG = -2e8 where
// theta = 0, finite in float32) get weight exactly 0; count-0 rows add 0.
// The done flag comes by device pointer: when *done is set every CTA
// writes zeros (its rows of lse, its partials) and returns without reading
// logL, so a converged state inside a chunk of inference/em.py costs
// launches, not passes.
// Left for later work: prefetching the warp's next row.
#include "rcg_common.cuh"

namespace rcg {

// CTAs an SM: three for rows of one chunk (at most 85 registers a thread,
// so that one CTA's FP64 exps overlap the others' phase B and loads), two
// for wider rows, whose second pass needs more registers.
template <bool ONE_CHUNK>
constexpr int EM_CTAS = ONE_CHUNK ? 3 : 2;

// ONE_CHUNK: G <= CHUNK, so the row functions are compiled for one chunk.
// A tile is `tile` rows of `slab` columns of weights in shared memory: the
// whole row for one chunk, a slab of whole chunks for the general build.
template <typename LT, typename CT, bool ONE_CHUNK>
__global__ void __launch_bounds__(THREADS, EM_CTAS<ONE_CHUNK>)
em_step_kernel(const LT* __restrict__ logL, const LT* __restrict__ counts,
               const CT* __restrict__ lse_prev, const CT* __restrict__ logtheta,
               const bool* __restrict__ done, int64_t E, int64_t G, bool vec,
               int64_t tq, int64_t tr, int tile, int64_t slab,
               CT* __restrict__ lse_out, double* __restrict__ part_scalar,
               double* __restrict__ part_cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  CT* __restrict__ wt = reinterpret_cast<CT*>(smem);  // (tile, slab) weights
  __shared__ CT rowres[TILE_ROWS], rmax[TILE_ROWS], rcrow[TILE_ROWS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nch = ONE_CHUNK ? 1 : (int)((G + CHUNK - 1) / CHUNK);
  int64_t lo, hi;
  split_rows(blockIdx.x, E, tq, tr, lo, hi);
  double* __restrict__ cols = part_cols + (int64_t)blockIdx.x * G;
  for (int64_t g = threadIdx.x; g < G; g += THREADS) cols[g] = 0.0;
  if (done != nullptr && *done) {  // the same on every thread of the CTA
    for (int64_t e = lo + threadIdx.x; e < hi; e += THREADS) lse_out[e] = 0;
    if (threadIdx.x == 0) part_scalar[blockIdx.x] = 0.0;
    return;
  }
  __syncthreads();
  LT L[NPL];
  CT w[NPL];
  double acc = 0.0;  // read by thread 0 only
  // One chunk: a thread's columns (at most CHUNK / THREADS) of the CTA's
  // partials stay in registers across tiles, written out at the end.
  constexpr int NCOL = CHUNK / THREADS;
  double cacc[NCOL];
#pragma unroll
  for (int j = 0; j < NCOL; ++j) cacc[j] = 0.0;
  for (int64_t t0 = lo; t0 < hi; t0 += tile) {
    const int nr = (int)((hi - t0 < tile) ? hi - t0 : tile);
    // Phase A: lse, the ddot term and (max, cnt / denom) of each row, one
    // warp per row; for one chunk also the tile's weights.
    for (int r = warp; r < nr; r += WARPS) {
      const int64_t e = t0 + r;
      const LT* row = logL + e * G;
      const CT cnt = (CT)counts[e];
      CT m, den;
      load_row_chunk(row, 0, G, vec, lane, L);
      em_row_stats<LT, CT>(row, G, vec, nch, lane, logtheta, L, m, den, w);
      const CT crow = cnt / den, lse = m + clog(den);
      if (ONE_CHUNK) {
#pragma unroll
        for (int i = 0; i < NPL; ++i) w[i] = w[i] * crow;
        store_row_chunk(wt + (int64_t)r * G, 0, G, lane, w);
      }
      if (lane == 0) {
        lse_out[e] = lse;
        rowres[r] = cnt * (lse - lse_prev[e]);
        rmax[r] = m;
        rcrow[r] = crow;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int r = 0; r < nr; ++r) acc += (double)rowres[r];
    }
    if (ONE_CHUNK) {
      // Phase B: column partials of the tile's w, rows in order.
      for (int r = 0; r < nr; ++r) {
#pragma unroll
        for (int j = 0; j < NCOL; ++j) {
          const int64_t g = threadIdx.x + j * THREADS;
          if (g < G) cacc[j] += (double)wt[(int64_t)r * G + g];
        }
      }
      __syncthreads();
    } else {
      // A slab of columns at a time: the tile's w on the slab's chunks, one
      // warp per row, then phase B on the slab's columns, rows in order.
      for (int64_t s0 = 0; s0 < G; s0 += slab) {
        const int64_t sw = (G - s0 < slab) ? G - s0 : slab;
        for (int r = warp; r < nr; r += WARPS) {
          const LT* row = logL + (t0 + r) * G;
          for (int64_t c0 = s0; c0 < s0 + sw; c0 += CHUNK) {
            em_chunk_w<LT, CT>(row, c0, G, vec, lane, logtheta, rmax[r], rcrow[r], w);
            store_row_chunk(wt + (int64_t)r * slab, c0 - s0, sw, lane, w);
          }
        }
        __syncthreads();
        for (int64_t g = threadIdx.x; g < sw; g += THREADS) {
          double s = cols[s0 + g];
          for (int r = 0; r < nr; ++r) s += (double)wt[(int64_t)r * slab + g];
          cols[s0 + g] = s;
        }
        __syncthreads();
      }
    }
  }
  if (ONE_CHUNK) {
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      const int64_t g = threadIdx.x + j * THREADS;
      if (g < G) cols[g] = cacc[j];
    }
  }
  if (threadIdx.x == 0) part_scalar[blockIdx.x] = acc;
}

// The instantiation for G columns, its tile of weights (from its
// shared-memory budget, read from the runtime once per device) and the
// dynamic shared memory that takes.  The general build's slab is the row's
// chunks, at most as many as WARPS rows of weights fit in the budget.
template <typename LT, typename CT, bool ONE_CHUNK>
static cudaError_t em_plan_one(int64_t G, const void*& kernel, int& tile, int64_t& slab,
                               size_t& smem) {
  static WtileBudget cache;
  int64_t budget = 0;
  kernel = (const void*)em_step_kernel<LT, CT, ONE_CHUNK>;
  cudaError_t err = wtile_budget(kernel, EM_CTAS<ONE_CHUNK>, cache, budget);
  if (ONE_CHUNK) {
    slab = G > 0 ? G : 1;
  } else {
    const int64_t nch = (G + CHUNK - 1) / CHUNK;
    const int64_t fit = budget / ((int64_t)WARPS * CHUNK * (int64_t)sizeof(CT));
    slab = (nch < fit ? nch : fit) * CHUNK;
  }
  const int64_t row_bytes = slab * (int64_t)sizeof(CT);
  tile = row_bytes > 0 ? wtile_rows(budget, row_bytes) : 0;
  smem = (size_t)tile * row_bytes;
  // No tile of weights fits (not so on an H100).
  if (err == cudaSuccess && tile == 0) err = cudaErrorInvalidConfiguration;
  return err;
}

template <typename LT, typename CT>
static cudaError_t em_plan(int64_t G, const void*& kernel, int& tile, int64_t& slab,
                           size_t& smem) {
  return G <= CHUNK ? em_plan_one<LT, CT, true>(G, kernel, tile, slab, smem)
                    : em_plan_one<LT, CT, false>(G, kernel, tile, slab, smem);
}

template <typename LT, typename CT>
static int launch_em_step(const void* logL, const void* counts, const void* lse_prev,
                          const void* logtheta, const void* done, int64_t E, int64_t G,
                          int64_t n_cta, void* lse_out, void* part_scalar, void* part_cols,
                          void* out_scalar, void* out_cols, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* kernel = nullptr;
  int tile = 0;
  int64_t slab = 0;
  size_t smem = 0;
  cudaError_t err = em_plan<LT, CT>(G, kernel, tile, slab, smem);
  if (err != cudaSuccess) return (int)err;
  bool vec = vector_rows(logL, G);
  int64_t tq = 0, tr = 0;
  split_plan(E, n_cta, tq, tr);
  void* args[] = {&logL, &counts, &lse_prev, &logtheta, &done, &E, &G, &vec, &tq, &tr,
                  &tile, &slab, &lse_out, &part_scalar, &part_cols};
  err = cudaLaunchKernel(kernel, dim3((unsigned)n_cta), dim3(THREADS), args, smem, s);
  if (err != cudaSuccess) return (int)err;
  rcg_reduce_scalar<<<1, 32, 0, s>>>((const double*)part_scalar, n_cta, (double*)out_scalar);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (G + 255) / 256;
  rcg_reduce_cols<<<(unsigned)(blocks > 0 ? blocks : 1), 256, 0, s>>>(
      (const double*)part_cols, n_cta, G, (double*)out_cols);
  return (int)cudaGetLastError();
}

// out = {registers a thread, local (spilled) bytes a thread, rows and
// columns of the tile of weights at G columns, CTAs resident an SM at that
// tile}, for the instantiation that G columns run, on the current device.
template <typename LT, typename CT>
static int info_em_step(int64_t G, int* out) {
  const void* kernel = nullptr;
  int tile = 0;
  int64_t slab = 0;
  size_t smem = 0;
  cudaError_t err = em_plan<LT, CT>(G, kernel, tile, slab, smem);
  cudaFuncAttributes attr;
  int ctas = 0;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = tile;
  out[3] = (int)slab;
  out[4] = ctas;
  return 0;
}

// The EM passes' exp (rcg_common.cuh exp_sel) against CUDA's exp, bit for
// bit (two NaNs count as equal), over n arguments: a third spread evenly
// over [-760, 760], a third drawn over exp's slow range [-746.5, -707.5],
// a third any 64 bits (hashed from the index).  *bad counts those that
// differ; first holds the first one met, exp_sel's value and exp's.
__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  return x ^ (x >> 33);
}
__global__ void exp_sel_check(int64_t n, unsigned long long* bad, double* first) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    double a;
    if (i % 3 == 0) a = -760.0 + 1520.0 * ((double)(i / 3) / (double)(n / 3 + 1));
    else if (i % 3 == 1) a = -746.5 + 39.0 * ((double)(mix64(i) >> 11) * 0x1.0p-53);
    else a = __longlong_as_double((long long)mix64(i));
    const double x = exp_sel(a), y = exp(a);
    if (__double_as_longlong(x) != __double_as_longlong(y) && !(x != x && y != y) &&
        atomicAdd(bad, 1ULL) == 0) {
      first[0] = a;
      first[1] = x;
      first[2] = y;
    }
  }
}

}  // namespace rcg

// bad: one zeroed unsigned 64-bit count, first: three doubles, on the
// device (rcg::exp_sel_check).  Returns a CUDA error.
extern "C" int em_exp_check(int64_t n, void* bad, void* first, void* stream) {
  rcg::exp_sel_check<<<2048, 256, 0, (cudaStream_t)stream>>>(n, (unsigned long long*)bad,
                                                            (double*)first);
  return (int)cudaGetLastError();
}

// Plain C entry points, one per instantiation (matrix type _ compute type).
// counts is (E,) in the matrix type; lse_prev, lse_out (E,) and logtheta
// (G,) in the compute type; done is one bool or null (never done).
// n_cta is the number of row ranges (rcg_common.cuh split_plan), one CTA
// each.  part_scalar is scratch of n_cta doubles,
// part_cols of n_cta * G; out_scalar is one double (ddot), out_cols G
// doubles (colsum); all on the device.  em_step_info_* fills five ints
// (rcg::info_em_step).  Both return a CUDA error.
#define EM_STEP_ENTRY(NAME, LT, CT)                                                          \
  extern "C" int NAME(const void* logL, const void* counts, const void* lse_prev,            \
                      const void* logtheta, const void* done, int64_t E, int64_t G,          \
                      int64_t n_cta, void* lse_out, void* part_scalar, void* part_cols,      \
                      void* out_scalar, void* out_cols, void* stream) {                      \
    return rcg::launch_em_step<LT, CT>(logL, counts, lse_prev, logtheta, done, E, G, n_cta,  \
                                       lse_out, part_scalar, part_cols, out_scalar, out_cols, \
                                       stream);                                              \
  }                                                                                          \
  extern "C" int NAME##_info(int64_t G, int* out) { return rcg::info_em_step<LT, CT>(G, out); }

EM_STEP_ENTRY(em_step_f32_f32, float, float)
EM_STEP_ENTRY(em_step_f64_f64, double, double)
