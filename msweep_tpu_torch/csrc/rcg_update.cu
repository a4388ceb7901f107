// K2: pass 2 of one implicit rcg iteration, the dual-softmax update.
//
// Replaces the TPU kernel msweep_tpu/ops/rcg_pallas.py rcg_update /
// _update_kernel, and its float64 twins msweep_tpu/ops/rcg_xla.py
// rcg_update and rcg_bound_stats.  With gamma = masked row softmax of
// c * logL + v and row(c, v) = sum_g w * (logL - gamma),
// w = counts * exp(gamma) (taken as num / denom), it returns
//
//     colsum_g = sum_e w_eg at (c_new, v_new)                  (G,)
//     scalar   = sum_e (row(c_new, v_new) - row(c_old, v_old))  delta mode
//              = sum_e row(c_new, v_new)                        absolute mode
//
// The delta mode is the ELBO data-term change of one step, differenced per
// row so that nearly equal row terms cancel before the cross-row sum.  The
// absolute mode is the exact-bound pass of the escalation supervisor and the
// implicit init at (c, v) = (0, 0).
//
// Bound by memory: one pass streams logL once, 4 B/cell in float32.  A CTA
// walks its contiguous rows in tiles of TILE_ROWS.  Phase A: one warp per
// row computes the row terms and keeps (max, denom, count) of the new
// softmax in shared memory.  Phase B: threads own columns and walk the
// tile's rows in order, adding w into the CTA's own row of the (n_cta, G)
// double partials, so the column sum needs no atomics.  Phase B re-reads the
// tile from L1/L2 and recomputes exp(ghat - m).  Left on the table for later
// work: TMA tiles in shared memory shared by both phases, holding the row in
// registers, vectorised loads, and skipping the old softmax's max walk.
#include "rcg_common.cuh"

namespace rcg {

template <typename LT, typename CT>
__global__ void __launch_bounds__(THREADS)
rcg_update_kernel(const LT* __restrict__ logL, const LT* __restrict__ counts, CT c_old,
                  const CT* __restrict__ v_old, CT c_new, const CT* __restrict__ v_new,
                  int absolute, int64_t E, int64_t G, int64_t rows_per_cta,
                  double* __restrict__ part_scalar, double* __restrict__ part_cols) {
  __shared__ CT rowres[TILE_ROWS], rmax[TILE_ROWS], rden[TILE_ROWS], rcnt[TILE_ROWS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int64_t lo, hi;
  cta_rows(E, rows_per_cta, lo, hi);
  double* __restrict__ cols = part_cols + (int64_t)blockIdx.x * G;
  for (int64_t g = threadIdx.x; g < G; g += THREADS) cols[g] = 0.0;
  double acc = 0.0;  // read by thread 0 only
  for (int64_t t0 = lo; t0 < hi; t0 += TILE_ROWS) {
    // Phase A: row terms, one warp per row.
    for (int k = 0; k < ROWS_PER_WARP; ++k) {
      const int r = warp * ROWS_PER_WARP + k;
      const int64_t e = t0 + r;
      if (e < hi) {
        const LT* row = logL + e * G;
        const CT cnt = (CT)counts[e];
        CT m, den;
        CT res = row_data_term<LT, CT>(row, G, cnt, c_new, v_new, lane, m, den);
        if (!absolute) {
          CT m_o, den_o;
          res = res - row_data_term<LT, CT>(row, G, cnt, c_old, v_old, lane, m_o, den_o);
        }
        if (lane == 0) {
          rowres[r] = res;
          rmax[r] = m;
          rden[r] = den;
          rcnt[r] = cnt;
        }
      }
    }
    __syncthreads();
    const int nr = (int)((hi - t0 < TILE_ROWS) ? hi - t0 : TILE_ROWS);
    if (threadIdx.x == 0) {
      for (int r = 0; r < nr; ++r) acc += (double)rowres[r];
    }
    // Phase B: column partials of w at (c_new, v_new), rows in order.
    for (int64_t g = threadIdx.x; g < G; g += THREADS) {
      const CT vg = v_new[g];
      double s = cols[g];
      for (int r = 0; r < nr; ++r) {
        const CT gh = ghat((CT)logL[(t0 + r) * G + g], c_new, vg);
        const CT num = cexp(gh - rmax[r]);
        s += (double)(rcnt[r] * (num / rden[r]));
      }
      cols[g] = s;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) part_scalar[blockIdx.x] = acc;
}

template <typename LT, typename CT>
static int launch_update(const void* logL, const void* counts, CT c_old, const void* v_old,
                         CT c_new, const void* v_new, int absolute, int64_t E, int64_t G,
                         int64_t rows_per_cta, int64_t n_cta, void* part_scalar,
                         void* part_cols, void* out_scalar, void* out_cols,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  rcg_update_kernel<LT, CT><<<(unsigned)n_cta, THREADS, 0, s>>>(
      (const LT*)logL, (const LT*)counts, c_old, (const CT*)v_old, c_new,
      (const CT*)v_new, absolute, E, G, rows_per_cta, (double*)part_scalar,
      (double*)part_cols);
  cudaError_t err = cudaGetLastError();
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
// part_scalar is scratch of n_cta doubles, part_cols of n_cta * G doubles;
// out_scalar is one double, out_cols G doubles; all on the device.  In
// absolute mode v_old and c_old are not read.
#define RCG_UPDATE_ENTRY(NAME, LT, CT)                                                   \
  extern "C" int NAME(const void* logL, const void* counts, CT c_old, const void* v_old, \
                      CT c_new, const void* v_new, int absolute, int64_t E, int64_t G,   \
                      int64_t rows_per_cta, int64_t n_cta, void* part_scalar,            \
                      void* part_cols, void* out_scalar, void* out_cols, void* stream) { \
    return rcg::launch_update<LT, CT>(logL, counts, c_old, v_old, c_new, v_new,         \
                                      absolute, E, G, rows_per_cta, n_cta, part_scalar, \
                                      part_cols, out_scalar, out_cols, stream);         \
  }

RCG_UPDATE_ENTRY(rcg_update_f32_f32, float, float)
RCG_UPDATE_ENTRY(rcg_update_f32_f64, float, double)
RCG_UPDATE_ENTRY(rcg_update_f64_f64, double, double)
