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
// exp(t - lse) is taken as num / denom with num = exp(t - max).
//
// Bound by memory in float32 (one read of logL, 4 B/cell) and by FP64 exp
// in float64.  A CTA walks its contiguous rows in tiles of TILE_ROWS.
// Phase A: one warp per row finds the row max and exp sum, writes lse and
// keeps (max, denom, count) in shared memory; the row's ddot term waits
// there too and is added into the CTA's float64 partial in row order.
// Phase B: threads own columns and walk the tile's rows in order, adding w
// into the CTA's row of the (n_cta, G) float64 partials.  The TPU kernel
// keeps its one exp sweep for w; here phase B recomputes exp(t - max) on
// the tile re-read from L1/L2, two exps per cell in all.  No
// atomics: the second stage sums the partials in CTA order, so a rerun
// gives the same bits.  Padding: NEG cells (and NEG + NEG = -2e8 where
// theta = 0, finite in float32) get weight exactly 0; count-0 rows add 0.
#include "rcg_common.cuh"

namespace rcg {

template <typename LT, typename CT>
__global__ void __launch_bounds__(THREADS)
em_step_kernel(const LT* __restrict__ logL, const LT* __restrict__ counts,
               const CT* __restrict__ lse_prev, const CT* __restrict__ logtheta, int64_t E,
               int64_t G, int64_t rows_per_cta, CT* __restrict__ lse_out,
               double* __restrict__ part_scalar, double* __restrict__ part_cols) {
  __shared__ CT rowres[TILE_ROWS], rmax[TILE_ROWS], rden[TILE_ROWS], rcnt[TILE_ROWS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int64_t lo, hi;
  cta_rows(E, rows_per_cta, lo, hi);
  double* __restrict__ cols = part_cols + (int64_t)blockIdx.x * G;
  for (int64_t g = threadIdx.x; g < G; g += THREADS) cols[g] = 0.0;
  double acc = 0.0;  // read by thread 0 only
  for (int64_t t0 = lo; t0 < hi; t0 += TILE_ROWS) {
    // Phase A: row logsumexp, one warp per row.
    for (int k = 0; k < ROWS_PER_WARP; ++k) {
      const int r = warp * ROWS_PER_WARP + k;
      const int64_t e = t0 + r;
      if (e < hi) {
        const LT* row = logL + e * G;
        CT mx = neg_inf<CT>();
#pragma unroll 4
        for (int64_t g = lane; g < G; g += 32) mx = cmax(mx, (CT)row[g] + logtheta[g]);
        mx = warp_max(mx);
        CT s = 0;
#pragma unroll 4
        for (int64_t g = lane; g < G; g += 32) s += cexp(((CT)row[g] + logtheta[g]) - mx);
        s = warp_sum(s);
        if (lane == 0) {
          const CT lse = mx + clog(s);
          const CT cnt = (CT)counts[e];
          lse_out[e] = lse;
          rowres[r] = cnt * (lse - lse_prev[e]);
          rmax[r] = mx;
          rden[r] = s;
          rcnt[r] = cnt;
        }
      }
    }
    __syncthreads();
    const int nr = (int)((hi - t0 < TILE_ROWS) ? hi - t0 : TILE_ROWS);
    if (threadIdx.x == 0) {
      for (int r = 0; r < nr; ++r) acc += (double)rowres[r];
    }
    // Phase B: column partials of w = cnt * exp(t - max) / denom, rows in order.
    for (int64_t g = threadIdx.x; g < G; g += THREADS) {
      const CT lt = logtheta[g];
      double s = cols[g];
      for (int r = 0; r < nr; ++r) {
        const CT num = cexp(((CT)logL[(t0 + r) * G + g] + lt) - rmax[r]);
        s += (double)(rcnt[r] * (num / rden[r]));
      }
      cols[g] = s;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) part_scalar[blockIdx.x] = acc;
}

template <typename LT, typename CT>
static int launch_em_step(const void* logL, const void* counts, const void* lse_prev,
                          const void* logtheta, int64_t E, int64_t G, int64_t rows_per_cta,
                          int64_t n_cta, void* lse_out, void* part_scalar, void* part_cols,
                          void* out_scalar, void* out_cols, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  em_step_kernel<LT, CT><<<(unsigned)n_cta, THREADS, 0, s>>>(
      (const LT*)logL, (const LT*)counts, (const CT*)lse_prev, (const CT*)logtheta, E, G,
      rows_per_cta, (CT*)lse_out, (double*)part_scalar, (double*)part_cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rcg_reduce_scalar<<<1, 32, 0, s>>>((const double*)part_scalar, n_cta, (double*)out_scalar);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (G + 255) / 256;
  rcg_reduce_cols<<<(unsigned)(blocks > 0 ? blocks : 1), 256, 0, s>>>(
      (const double*)part_cols, n_cta, G, (double*)out_cols);
  return (int)cudaGetLastError();
}

}  // namespace rcg

// Plain C entry points, one per instantiation (matrix type _ compute type).
// counts is (E,) in the matrix type; lse_prev, lse_out (E,) and logtheta
// (G,) in the compute type.  part_scalar is scratch of n_cta doubles,
// part_cols of n_cta * G; out_scalar is one double (ddot), out_cols G
// doubles (colsum); all on the device.
#define EM_STEP_ENTRY(NAME, LT, CT)                                                          \
  extern "C" int NAME(const void* logL, const void* counts, const void* lse_prev,            \
                      const void* logtheta, int64_t E, int64_t G, int64_t rows_per_cta,      \
                      int64_t n_cta, void* lse_out, void* part_scalar, void* part_cols,      \
                      void* out_scalar, void* out_cols, void* stream) {                      \
    return rcg::launch_em_step<LT, CT>(logL, counts, lse_prev, logtheta, E, G, rows_per_cta, \
                                       n_cta, lse_out, part_scalar, part_cols, out_scalar,   \
                                       out_cols, stream);                                    \
  }

EM_STEP_ENTRY(em_step_f32_f32, float, float)
EM_STEP_ENTRY(em_step_f64_f64, double, double)
