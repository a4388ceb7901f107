// K4: pass 2 of one implicit rcg iteration for B bootstrap replicates.
//
// Replaces the TPU kernel msweep_tpu/ops/rcg_pallas.py rcg_update_batch /
// _update_batch_kernel.  For each replicate b (counts = column b of the
// (E, B) countsT) it returns what K2 (rcg_update.cu) returns for that
// replicate alone:
//
//     colsum_bg = sum_e w_eg at (c_new_b, v_new_b)                (B, G)
//     scalar_b  = sum_e (row(c_new_b, v_new_b) - rows_old_eb)     delta
//               = sum_e row(c_new_b, v_new_b)                     absolute
//
// rows_old is K3's (E, B) output of the same iteration: the row terms at
// the replicate's current state, data_row's bits, so the delta has K2's
// delta-mode bits and each live replicate takes one softmax, one exp per
// cell.  The absolute mode (rows_old null) at (c, v) = (0, 0) is the
// batched init: colsum0 and data0 of every replicate in one pass
// (msweep_tpu/inference/rcg.py _rcg_init_implicit_batch computes them with
// two einsums).  A replicate flagged in done[] does no row work: its
// colsum and scalar are 0.
//
// Bound by compute: logL is read from device memory once a pass.  Rows of
// one chunk (G <= 512) run a warp per replicate, as K3 does: CTA (x, y)
// stages row range y (K2's ranges) tile by tile in shared memory, and
// warp w walks every row for replicate 8x + w with v_new and c_new in
// registers, adding the row terms into a float64 register and each
// column's weight into the lane's float64 column sums, in registers too,
// all in row order: the adds K2 makes, so with the same grid replicate b
// gives K2's bits on column b, with no tile of weights and no barrier
// between the exps and the column adds.  Wider rows run a warp per row as
// K2 does: a warp loads its row's first chunk once per chunk of replicates
// (RB, 4, 2 or 1) and runs data_row for each, writing the weights into the
// tile's (replicate, row, G) block of shared memory; then one thread per
// column adds them in row order into the CTA's (B, G) slice of the
// (n_cta, B, G) float64 partials.  No atomics; the second stage sums the
// partials in CTA order.  c comes by device pointer, so a batched
// iteration needs no host sync.  Any B >= 1.
#include "rcg_common.cuh"

namespace rcg {

// Rows of one chunk: warp w of CTA (x, y) is replicate 8x + w over row range y.
template <typename LT, typename CT>
__global__ void __launch_bounds__(THREADS, MinCtas<CT>::value)
rcg_update_batch_rep_kernel(const LT* __restrict__ logL, const LT* __restrict__ countsT,
                            const CT* __restrict__ rows_old, const CT* __restrict__ c_new,
                            const CT* __restrict__ v_new, const bool* __restrict__ done,
                            int64_t E, int64_t G, int64_t B, bool vec, int64_t rows_per_cta,
                            int tile, double* __restrict__ part_scalar,
                            double* __restrict__ part_cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t b = (int64_t)blockIdx.x * WARPS + warp;
  const bool live = b < B && !(done != nullptr && done[b]);
  int64_t lo, hi;
  range_rows(blockIdx.y, E, rows_per_cta, lo, hi);
  double acc = 0.0;  // lane 0's is the replicate's
  double cacc[NPL];  // the lane's columns (rcg_common.cuh slot_col)
#pragma unroll
  for (int i = 0; i < NPL; ++i) cacc[i] = 0.0;
  if (__syncthreads_or(live)) {
    LT L[NPL];
    CT vn[NPL], w[NPL], cb = 0;
    if (live) {
      load_cols(v_new + b * G, 0, G, lane, vn);
      cb = c_new[b];
    }
    walk_staged_rows(reinterpret_cast<LT*>(smem), logL, G, vec, lo, hi, tile, live,
                     [&](int64_t e, const LT* row) {
                       const CT cnt = (CT)countsT[e * B + b];
                       const CT old = rows_old != nullptr ? rows_old[e * B + b] : (CT)0;
                       load_row_shared(row, G, vec, lane, L);
                       CT res = data_row<LT, CT>(row, G, vec, 1, lane, cnt, cb, nullptr, L,
                                                 vn, nullptr, nullptr, w);
                       if (rows_old != nullptr) res = res - old;
                       if (lane == 0) acc += (double)res;
#pragma unroll
                       for (int i = 0; i < NPL; ++i) cacc[i] += (double)w[i];
                     });
  }
  if (b < B) {
    double* __restrict__ cols = part_cols + ((int64_t)blockIdx.y * B + b) * G;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int64_t g = slot_col(0, i, lane);
      if (g < G) cols[g] = cacc[i];
    }
    if (lane == 0) part_scalar[(int64_t)blockIdx.y * B + b] = acc;
  }
}

// Wider rows: a warp per row, replicates in chunks of rb over one load of
// the row's first chunk, weights through the shared-memory tile.
template <typename LT, typename CT>
__global__ void __launch_bounds__(THREADS, MinCtas<CT>::value)
rcg_update_batch_kernel(const LT* __restrict__ logL, const LT* __restrict__ countsT,
                        const CT* __restrict__ rows_old, const CT* __restrict__ c_new,
                        const CT* __restrict__ v_new, const bool* __restrict__ done, int64_t E,
                        int64_t G, int64_t B, bool vec, int64_t rows_per_cta, int tile, int rb,
                        double* __restrict__ part_scalar, double* __restrict__ part_cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  CT* __restrict__ wt = reinterpret_cast<CT*>(smem);  // (rb, tile, G) weights
  __shared__ CT rowres[TILE_ROWS * RB];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nch = (int)((G + CHUNK - 1) / CHUNK);
  // tile 0: a row of weights does not fit shared memory, so warp 0 takes
  // the rows one by one and adds its w straight into the column partials.
  const bool direct = tile == 0;
  const int step = direct ? 1 : tile;
  int64_t lo, hi;
  cta_rows(E, rows_per_cta, lo, hi);
  double* __restrict__ acc = part_scalar + (int64_t)blockIdx.x * B;
  double* __restrict__ cols = part_cols + (int64_t)blockIdx.x * B * G;
  for (int64_t i = threadIdx.x; i < B * G; i += THREADS) cols[i] = 0.0;
  for (int64_t b = threadIdx.x; b < B; b += THREADS) acc[b] = 0.0;
  __syncthreads();
  LT L[NPL];
  CT vn[NPL], w[NPL];
  for (int64_t t0 = lo; t0 < hi; t0 += step) {
    const int nr = (int)((hi - t0 < step) ? hi - t0 : step);
    for (int64_t b0 = 0; b0 < B; b0 += rb) {
      const int nb = (int)((B - b0 < rb) ? B - b0 : rb);
      bool any = done == nullptr;
      for (int j = 0; j < nb && !any; ++j) any = !done[b0 + j];
      if (!any) continue;  // the same on every thread: no barrier skipped unevenly
      // Phase A: row terms and weights, one warp per row, over one load of it.
      for (int r = warp; r < nr; r += WARPS) {
        const int64_t e = t0 + r;
        const LT* row = logL + e * G;
        load_row_chunk(row, 0, G, vec, lane, L);
        for (int j = 0; j < nb; ++j) {
          const int64_t b = b0 + j;
          CT res = 0;
          if (done == nullptr || !done[b]) {
            const CT cnt = (CT)countsT[e * B + b];
            load_cols(v_new + b * G, 0, G, lane, vn);
            res = data_row<LT, CT>(row, G, vec, nch, lane, cnt, c_new[b], v_new + b * G, L, vn,
                                   direct ? nullptr : wt + ((int64_t)j * tile + r) * G,
                                   direct ? cols + b * G : nullptr, w);
            if (rows_old != nullptr) res = res - rows_old[e * B + b];
          }
          if (lane == 0) rowres[r * RB + j] = res;
        }
      }
      __syncthreads();
      if (threadIdx.x < nb) {
        double s = acc[b0 + threadIdx.x];
        for (int r = 0; r < nr; ++r) s += (double)rowres[r * RB + threadIdx.x];
        acc[b0 + threadIdx.x] = s;
      }
      // Phase B: column partials of each live replicate's w, rows in order.
      for (int j = 0; j < nb && !direct; ++j) {
        if (done != nullptr && done[b0 + j]) continue;
        double* __restrict__ colb = cols + (b0 + j) * G;
        const CT* __restrict__ wj = wt + (int64_t)j * tile * G;
        for (int64_t g = threadIdx.x; g < G; g += THREADS) {
          double s = colb[g];
          for (int r = 0; r < nr; ++r) s += (double)wj[(int64_t)r * G + g];
          colb[g] = s;
        }
      }
      __syncthreads();
    }
  }
}

// The build G columns run, with its tile rows (staged rows of logL for one
// chunk, rows of weights otherwise; 0 for direct), replicate chunk and
// dynamic shared memory.
template <typename LT, typename CT>
static cudaError_t update_plan(int64_t G, const void*& kernel, int& tile, int& rb,
                               size_t& smem) {
  rb = WARPS;
  if (G <= CHUNK) {
    static WtileBudget cache;
    kernel = (const void*)rcg_update_batch_rep_kernel<LT, CT>;
    return rep_tile<LT, CT>(kernel, G, cache, tile, smem);
  }
  static WtileBudget cache;
  kernel = (const void*)rcg_update_batch_kernel<LT, CT>;
  int64_t budget = 0;
  const cudaError_t err = wtile_budget(kernel, MinCtas<CT>::value, cache, budget);
  // The replicate chunk (RB, 4, 2 or 1) whose tile of weights keeps the
  // most warps busy in phase A (one row each), the widest on a tie; with
  // no tile that fits, RB replicates run direct.
  const int64_t row_bytes = G * (int64_t)sizeof(CT);
  rb = RB;
  tile = 0;
  for (int r = RB; r >= 1; r /= 2) {
    const int t = wtile_rows(budget, r * row_bytes);
    if ((t < WARPS ? t : WARPS) > (tile < WARPS ? tile : WARPS)) rb = r, tile = t;
  }
  smem = (size_t)rb * tile * row_bytes;
  return err;
}

template <typename LT, typename CT>
static int launch_update_batch(const void* logL, const void* countsT, const void* rows_old,
                               const void* c_new, const void* v_new, const void* done,
                               int64_t E, int64_t G, int64_t B, int64_t rows_per_cta,
                               int64_t n_cta, void* part_scalar, void* part_cols,
                               void* out_scalar, void* out_cols, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* kernel = nullptr;
  int tile = 0, rb = 0;
  size_t smem = 0;
  cudaError_t err = update_plan<LT, CT>(G, kernel, tile, rb, smem);
  if (err != cudaSuccess) return (int)err;
  bool vec = vector_rows(logL, G);
  if (G <= CHUNK) {
    void* args[] = {&logL, &countsT, &rows_old, &c_new, &v_new, &done, &E, &G, &B, &vec,
                    &rows_per_cta, &tile, &part_scalar, &part_cols};
    err = cudaLaunchKernel(kernel, dim3((unsigned)((B + WARPS - 1) / WARPS), (unsigned)n_cta),
                           dim3(THREADS), args, smem, s);
  } else {
    void* args[] = {&logL, &countsT, &rows_old, &c_new, &v_new, &done, &E, &G, &B, &vec,
                    &rows_per_cta, &tile, &rb, &part_scalar, &part_cols};
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
// tile rows, CTAs an SM and warps an SM.
template <typename LT, typename CT>
static int info_update_batch(int64_t G, int* out) {
  const void* kernel = nullptr;
  int tile = 0, rb = 0;
  size_t smem = 0;
  const cudaError_t err = update_plan<LT, CT>(G, kernel, tile, rb, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)kernel_info(kernel, tile, smem, out);
}

}  // namespace rcg

// Plain C entry points, one per instantiation (matrix type _ compute type).
// countsT is (E, B) in the matrix type; rows_old (E, B) (K3's row terms;
// null: absolute mode), v_new (B, G) and c_new (B,) in the compute type;
// done is (B,) bool or null (no replicate done).  part_scalar is scratch of
// n_cta * B doubles, part_cols of n_cta * B * G; out_scalar is B doubles,
// out_cols B * G; all on the device.  *_info fills five ints
// (rcg::info_update_batch).  Both return a CUDA error.
#define RCG_UPDATE_BATCH_ENTRY(NAME, LT, CT)                                                  \
  extern "C" int NAME(const void* logL, const void* countsT, const void* rows_old,            \
                      const void* c_new, const void* v_new, const void* done, int64_t E,      \
                      int64_t G, int64_t B, int64_t rows_per_cta, int64_t n_cta,              \
                      void* part_scalar, void* part_cols, void* out_scalar, void* out_cols,   \
                      void* stream) {                                                         \
    return rcg::launch_update_batch<LT, CT>(logL, countsT, rows_old, c_new, v_new, done, E,  \
                                            G, B, rows_per_cta, n_cta, part_scalar,          \
                                            part_cols, out_scalar, out_cols, stream);        \
  }                                                                                           \
  extern "C" int NAME##_info(int64_t G, int* out) {                                           \
    return rcg::info_update_batch<LT, CT>(G, out);                                            \
  }

RCG_UPDATE_BATCH_ENTRY(rcg_update_batch_f32_f32, float, float)
RCG_UPDATE_BATCH_ENTRY(rcg_update_batch_f64_f64, double, double)
