// K6: one EM iteration for B bootstrap replicates in one pass over logL.
//
// The JAX package has no kernel for this: its fit_em_batch
// (msweep_tpu/inference/em.py) vmaps the XLA branch of the EM step over
// the (B, E) counts.  For each replicate b (counts = column b of the
// (E, B) countsT, lse_prev column b, logtheta row b) K6 returns what K5
// (em_step.cu, the port of msweep_tpu/ops/em_pallas.py em_step) returns
// for that replicate alone, with t_b = logL + logtheta_b:
//
//     lse_eb    = logsumexp_g t_beg                                  (E, B)
//     colsum_bg = sum_e c_eb * exp(t_beg - lse_eb)                   (B, G)
//     ddot_b    = sum_e c_eb * (lse_eb - lse_prev_eb)                (B,)
//
// taken as K5 takes them: c / den once a row, exp(t - max) once a cell
// (rcg_common.cuh em_chunk_stats / em_row_stats, em_chunk_w), the row
// terms in the compute type, the sums across rows in float64 in row
// order.  The grid is K5's (its CTAs an SM give the same row ranges,
// ops/em_batch_kernels.py), so replicate b gives K5's bits on column b.
// A replicate flagged in done[] does no row work and returns zeros.
//
// Bound by compute: logL is read from device memory once a pass for all
// B replicates, but each replicate has its own theta, so each cell takes
// one exp a replicate (B exps a cell; 18 FP64 instructions each in
// float64).  Rows of one chunk (G <= 512) run K4's layout: CTA (x, y)
// stages K5's row range y tile by tile in shared memory (cp.async,
// walk_staged_rows), and warp w walks every row for replicate 8x + w with
// that replicate's logtheta in registers, adding each row's ddot term
// (lane 0, in a register) and each column's weight (the lane's 16 columns,
// in its own slice of shared memory) in float64 in row order: the adds K5
// makes, with no tile of weights and no barrier between the exps and the
// column adds.  Three things the first version lacked, each timed with
// msweep_tpu_torch/time_batch_kernels.py --em at 2,301,952 x 512, B = 8, on
// an NVIDIA H100 80GB HBM3 at 700 W: the exps are sexp, which has uexp's
// values but no branch around each exp, so a warp interleaves its row's 16
// exps (float64 54.3 -> 45.8 ms); the column sums in shared memory rather
// than registers leave room for three CTAs an SM in float32 and two in
// float64 (12.0 -> 11.0 and 45.8 -> 37.8 ms); and a row's count and
// lse_prev are read one row ahead (11.0 -> 10.5 and 37.8 -> 35.1 ms).
// That is 0.32 / 0.38 of the operations bound: each warp's row is a chain
// of dependent steps (max and sum across lanes, division, log) that 24 /
// 16 warps an SM do not hide.  Wider rows run a warp per row, as
// K5's general build does: each warp takes its row's statistics for each
// replicate of a block of rb in turn (rereading the row's later chunks
// from L1/L2), then, a slab of columns at a time, the weights of the
// block's replicates go through a (rb, WARPS, slab) tile of shared memory
// and one thread per column adds them in row order into the CTA's (B, G)
// float64 partials.  No atomics; the second stage sums the partials in
// CTA order, as K5's does.  Any E >= 0, G >= 1, B >= 1.
#include "rcg_common.cuh"

namespace rcg {

// CTAs an SM of the one-chunk build: three in float32 (at most 85
// registers a thread) and two in float64 (128), so that a warp's serial
// steps (the row's max and sum across lanes, its division and log) overlap
// other warps' exps.  K5's grid at G <= 512 is three CTAs an SM, one wave at
// three; float64 at 1 CTA an SM (190 registers) ran 1.2x slower, and at
// three it spilled.
template <typename CT>
struct RepCtas {
  static constexpr int value = sizeof(CT) == 4 ? 3 : 2;
};
// Shared memory of the lanes' column sums: slot i of lane l of warp w at
// (w * NPL + i) * 32 + l, a slice no other lane touches.
constexpr int64_t REP_COLS_BYTES = (int64_t)WARPS * NPL * 32 * sizeof(double);

// Rows of one chunk: warp w of CTA (x, y) is replicate 8x + w over row range y.
template <typename LT, typename CT>
__global__ void __launch_bounds__(THREADS, RepCtas<CT>::value)
em_step_batch_rep_kernel(const LT* __restrict__ logL, const LT* __restrict__ countsT,
                         const CT* __restrict__ lse_prev, const CT* __restrict__ logtheta,
                         const bool* __restrict__ done, int64_t E, int64_t G, int64_t B,
                         bool vec, int64_t rows_per_cta, int tile, CT* __restrict__ lse_out,
                         double* __restrict__ part_scalar, double* __restrict__ part_cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  double* __restrict__ csum = reinterpret_cast<double*>(smem) + warp * NPL * 32 + lane;
  LT* ring = reinterpret_cast<LT*>(smem + REP_COLS_BYTES);  // staged rows of logL
  const int64_t b = (int64_t)blockIdx.x * WARPS + warp;
  const bool live = b < B && !(done != nullptr && done[b]);
  int64_t lo, hi;
  range_rows(blockIdx.y, E, rows_per_cta, lo, hi);
  if (b < B && !live) {  // a done replicate: zeros in its column of lse
    for (int64_t e = lo + lane; e < hi; e += 32) lse_out[e * B + b] = 0;
  }
  double acc = 0.0;  // lane 0's is the replicate's
#pragma unroll
  for (int i = 0; i < NPL; ++i) csum[i * 32] = 0.0;
  if (__syncthreads_or(live)) {
    LT L[NPL];
    CT lt[NPL], w[NPL];
    // The row's count and lse_prev are read one row ahead: a read at the
    // row's end would hold the warp for a trip to L2 every row.
    CT cnt_n = 0, lp_n = 0;
    if (live) {
      load_cols(logtheta + b * G, 0, G, lane, lt);
      if (lo < hi) {
        cnt_n = (CT)countsT[lo * B + b];
        lp_n = lse_prev[lo * B + b];
      }
    }
    walk_staged_rows(ring, logL, G, vec, lo, hi, tile, live, [&](int64_t e, const LT* row) {
      const CT cnt = cnt_n, lp = lp_n;
      if (e + 1 < hi) {
        cnt_n = (CT)countsT[(e + 1) * B + b];
        lp_n = lse_prev[(e + 1) * B + b];
      }
      CT m = neg_inf<CT>(), den = 0;
      load_row_shared(row, G, vec, lane, L);
      em_chunk_stats<SExp>(L, lt, m, den, w);
      const CT crow = cnt / den, lse = m + clog(den);
      if (lane == 0) {
        lse_out[e * B + b] = lse;
        acc += (double)(cnt * (lse - lp));
      }
#pragma unroll
      for (int i = 0; i < NPL; ++i) csum[i * 32] += (double)(w[i] * crow);
    });
  }
  if (b < B) {
    double* __restrict__ cols = part_cols + ((int64_t)blockIdx.y * B + b) * G;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int64_t g = slot_col(0, i, lane);
      if (g < G) cols[g] = csum[i * 32];
    }
    if (lane == 0) part_scalar[(int64_t)blockIdx.y * B + b] = acc;
  }
}

// Wider rows: a warp per row, replicates in blocks of rb, the weights of a
// slab of columns through the shared-memory tile.
template <typename LT, typename CT>
__global__ void __launch_bounds__(THREADS, MinCtas<CT>::value)
em_step_batch_kernel(const LT* __restrict__ logL, const LT* __restrict__ countsT,
                     const CT* __restrict__ lse_prev, const CT* __restrict__ logtheta,
                     const bool* __restrict__ done, int64_t E, int64_t G, int64_t B, bool vec,
                     int64_t rows_per_cta, int rb, int64_t slab, CT* __restrict__ lse_out,
                     double* __restrict__ part_scalar, double* __restrict__ part_cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  CT* __restrict__ wt = reinterpret_cast<CT*>(smem);  // (rb, WARPS, slab) weights
  __shared__ CT rowres[WARPS * RB], rmax[WARPS * RB], rcrow[WARPS * RB];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nch = (int)((G + CHUNK - 1) / CHUNK);
  int64_t lo, hi;
  cta_rows(E, rows_per_cta, lo, hi);
  double* __restrict__ acc = part_scalar + (int64_t)blockIdx.x * B;
  double* __restrict__ cols = part_cols + (int64_t)blockIdx.x * B * G;
  for (int64_t i = threadIdx.x; i < B * G; i += THREADS) cols[i] = 0.0;
  for (int64_t i = threadIdx.x; i < B; i += THREADS) acc[i] = 0.0;
  __syncthreads();
  LT L[NPL];
  CT w[NPL];
  for (int64_t t0 = lo; t0 < hi; t0 += WARPS) {
    const int nr = (int)((hi - t0 < WARPS) ? hi - t0 : WARPS);
    for (int64_t b0 = 0; b0 < B; b0 += rb) {
      const int nb = (int)((B - b0 < rb) ? B - b0 : rb);
      // Phase A: warp r takes row t0 + r, each replicate of the block in turn.
      if (warp < nr) {
        const int64_t e = t0 + warp;
        const LT* row = logL + e * G;
        for (int j = 0; j < nb; ++j) {
          const int64_t b = b0 + j;
          CT lse = 0, res = 0, m = 0, crow = 0;
          if (done == nullptr || !done[b]) {
            const CT cnt = (CT)countsT[e * B + b];
            CT den;
            load_row_chunk(row, 0, G, vec, lane, L);
            em_row_stats<LT, CT>(row, G, vec, nch, lane, logtheta + b * G, L, m, den, w);
            crow = cnt / den;
            lse = m + clog(den);
            res = cnt * (lse - lse_prev[e * B + b]);
          }
          if (lane == 0) {
            lse_out[e * B + b] = lse;
            rowres[warp * RB + j] = res;
            rmax[warp * RB + j] = m;
            rcrow[warp * RB + j] = crow;
          }
        }
      }
      __syncthreads();
      if (threadIdx.x < nb) {  // each replicate's ddot terms, rows in order
        double s = acc[b0 + threadIdx.x];
        for (int r = 0; r < nr; ++r) s += (double)rowres[r * RB + threadIdx.x];
        acc[b0 + threadIdx.x] = s;
      }
      for (int64_t s0 = 0; s0 < G; s0 += slab) {
        const int64_t sw = (G - s0 < slab) ? G - s0 : slab;
        if (warp < nr) {
          const LT* row = logL + (t0 + warp) * G;
          for (int j = 0; j < nb; ++j) {
            const int64_t b = b0 + j;
            if (done != nullptr && done[b]) continue;
            CT* wrow = wt + ((int64_t)j * WARPS + warp) * slab;
            for (int64_t c0 = s0; c0 < s0 + sw; c0 += CHUNK) {
              em_chunk_w<LT, CT>(row, c0, G, vec, lane, logtheta + b * G, rmax[warp * RB + j],
                                 rcrow[warp * RB + j], w);
              store_row_chunk(wrow, c0 - s0, sw, lane, w);
            }
          }
        }
        __syncthreads();
        // Phase B: each live replicate's column partials of the slab, rows in order.
        for (int j = 0; j < nb; ++j) {
          if (done != nullptr && done[b0 + j]) continue;
          double* __restrict__ colb = cols + (b0 + j) * G + s0;
          const CT* __restrict__ wj = wt + (int64_t)j * WARPS * slab;
          for (int64_t g = threadIdx.x; g < sw; g += THREADS) {
            double s = colb[g];
            for (int r = 0; r < nr; ++r) s += (double)wj[(int64_t)r * slab + g];
            colb[g] = s;
          }
        }
        __syncthreads();
      }
    }
  }
}

// The build G columns run, with its tile rows (staged rows of logL for one
// chunk; WARPS rows of weights beyond), replicate block, slab of columns
// and dynamic shared memory.  The wide build takes the largest block of
// replicates (RB, 4, 2 or 1) whose WARPS rows of one chunk of weights fit
// its share of shared memory, then as many chunks a slab as fit.
template <typename LT, typename CT>
static cudaError_t em_batch_plan(int64_t G, const void*& kernel, int& tile, int& rb,
                                 int64_t& slab, size_t& smem) {
  if (G <= CHUNK) {
    // A ring of two tiles of staged rows beside the column sums in the
    // build's share of the SM, at most TILE_ROWS rows a tile.
    static WtileBudget cache;
    kernel = (const void*)em_step_batch_rep_kernel<LT, CT>;
    rb = WARPS;
    slab = G;
    int64_t budget = 0;
    cudaError_t err = wtile_budget(kernel, RepCtas<CT>::value, cache, budget);
    const int64_t buf = 2 * G * (int64_t)sizeof(LT);
    const int64_t t = (budget - REP_COLS_BYTES) / buf;
    tile = (int)(t < TILE_ROWS ? t : TILE_ROWS);
    smem = (size_t)(REP_COLS_BYTES + tile * buf);
    if (err == cudaSuccess && tile < 1) err = cudaErrorInvalidConfiguration;
    return err;
  }
  static WtileBudget cache;
  kernel = (const void*)em_step_batch_kernel<LT, CT>;
  int64_t budget = 0;
  cudaError_t err = wtile_budget(kernel, MinCtas<CT>::value, cache, budget);
  const int64_t chunk_bytes = (int64_t)WARPS * CHUNK * (int64_t)sizeof(CT);
  rb = RB;
  while (rb > 1 && rb * chunk_bytes > budget) rb /= 2;
  const int64_t nch = (G + CHUNK - 1) / CHUNK;
  const int64_t fit = budget / (rb * chunk_bytes);
  slab = (nch < fit ? nch : fit) * CHUNK;
  tile = WARPS;
  smem = (size_t)rb * WARPS * slab * sizeof(CT);
  // Not one chunk of weights fits (not so on an H100).
  if (err == cudaSuccess && fit < 1) err = cudaErrorInvalidConfiguration;
  return err;
}

template <typename LT, typename CT>
static int launch_em_step_batch(const void* logL, const void* countsT, const void* lse_prev,
                                const void* logtheta, const void* done, int64_t E, int64_t G,
                                int64_t B, int64_t rows_per_cta, int64_t n_cta, void* lse_out,
                                void* part_scalar, void* part_cols, void* out_scalar,
                                void* out_cols, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* kernel = nullptr;
  int tile = 0, rb = 0;
  int64_t slab = 0;
  size_t smem = 0;
  cudaError_t err = em_batch_plan<LT, CT>(G, kernel, tile, rb, slab, smem);
  if (err != cudaSuccess) return (int)err;
  bool vec = vector_rows(logL, G);
  if (G <= CHUNK) {
    void* args[] = {&logL, &countsT, &lse_prev, &logtheta, &done, &E, &G, &B, &vec,
                    &rows_per_cta, &tile, &lse_out, &part_scalar, &part_cols};
    err = cudaLaunchKernel(kernel, dim3((unsigned)((B + WARPS - 1) / WARPS), (unsigned)n_cta),
                           dim3(THREADS), args, smem, s);
  } else {
    void* args[] = {&logL, &countsT, &lse_prev, &logtheta, &done, &E, &G, &B, &vec,
                    &rows_per_cta, &rb, &slab, &lse_out, &part_scalar, &part_cols};
    err = cudaLaunchKernel(kernel, dim3((unsigned)n_cta), dim3(THREADS), args, smem, s);
  }
  if (err != cudaSuccess) return (int)err;
  // Second stage, in CTA order: out_scalar[b] over the (n_cta, B) partials,
  // out_cols[b, g] over the (n_cta, B * G) ones.
  rcg_reduce_cols<<<(unsigned)((B + 255) / 256), 256, 0, s>>>((const double*)part_scalar,
                                                                n_cta, B, (double*)out_scalar);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t BG = B * G;
  rcg_reduce_cols<<<(unsigned)((BG + 255) / 256), 256, 0, s>>>((const double*)part_cols, n_cta,
                                                                 BG, (double*)out_cols);
  return (int)cudaGetLastError();
}

// out = kernel_info of the build G columns run: registers, spilled bytes,
// tile rows and CTAs an SM.
template <typename LT, typename CT>
static int info_em_step_batch(int64_t G, int* out) {
  const void* kernel = nullptr;
  int tile = 0, rb = 0;
  int64_t slab = 0;
  size_t smem = 0;
  const cudaError_t err = em_batch_plan<LT, CT>(G, kernel, tile, rb, slab, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)kernel_info(kernel, tile, smem, out);
}

}  // namespace rcg

// Plain C entry points, one per instantiation (matrix type _ compute type).
// countsT is (E, B) in the matrix type; lse_prev and lse_out (E, B) and
// logtheta (B, G) in the compute type; done is (B,) bool or null (no
// replicate done).  part_scalar is scratch of n_cta * B doubles, part_cols
// of n_cta * B * G; out_scalar is B doubles (ddot), out_cols B * G
// (colsum); all on the device.  *_info fills four ints
// (rcg::info_em_step_batch).  Both return a CUDA error.
#define EM_STEP_BATCH_ENTRY(NAME, LT, CT)                                                       \
  extern "C" int NAME(const void* logL, const void* countsT, const void* lse_prev,             \
                      const void* logtheta, const void* done, int64_t E, int64_t G, int64_t B, \
                      int64_t rows_per_cta, int64_t n_cta, void* lse_out, void* part_scalar,    \
                      void* part_cols, void* out_scalar, void* out_cols, void* stream) {        \
    return rcg::launch_em_step_batch<LT, CT>(logL, countsT, lse_prev, logtheta, done, E, G, B, \
                                             rows_per_cta, n_cta, lse_out, part_scalar,        \
                                             part_cols, out_scalar, out_cols, stream);         \
  }                                                                                             \
  extern "C" int NAME##_info(int64_t G, int* out) {                                             \
    return rcg::info_em_step_batch<LT, CT>(G, out);                                             \
  }

EM_STEP_BATCH_ENTRY(em_step_batch_f32_f32, float, float)
EM_STEP_BATCH_ENTRY(em_step_batch_f64_f64, double, double)
