// K1: pass 1 of one implicit rcg iteration, the Fletcher-Reeves metric norm.
//
// Replaces the TPU kernel msweep_tpu/ops/rcg_pallas.py rcg_norm /
// _norm_kernel, and its float64 twin msweep_tpu/ops/rcg_xla.py rcg_norm.
// With t = logL + psi, s = (t - lse_row(t)) - gamma and
// gamma = masked row softmax of c * logL + v, it returns
//
//     sum_e sum_g counts_e * exp(gamma_eg) * s_eg^2
//
// with exp(gamma) taken as exp(ghat - m) * (cnt / denom): one division per
// row, where the TPU kernel and the plain version divide num / denom per
// cell.  That moves a cell's weight by an ulp or two, well inside the
// rtol (1e-5 in float32, 1e-12 in float64) the kernel is held to.
//
// Bound: one read of logL, 4 B/cell in float32 (an iteration is this pass
// plus K2).  The arithmetic per cell is what holds it above that: two
// correctly rounded exps (the floor and the escalation trigger need them)
// and ~20 other operations, so in float32 it sits near the profiler's T3
// (two exp sweeps), and in float64 compute it is bound by the FP64 exps.
// The design does the least of that work: a warp holds its row in
// registers (16 cells a lane for G <= 512, 16-byte loads), reads each cell
// of logL once from memory, takes exp(t - m1) for lse(t) and exp(ghat - m)
// for the softmax once each, keeps the latter in registers for the
// w * s^2 term, and holds psi and v in registers across all the CTA's rows
// (rcg_common.cuh norm_row).  Left for later work: TMA bulk loads and
// prefetching the warp's next row while it computes this one.
#include "rcg_common.cuh"

namespace rcg {

template <typename LT, typename CT>
__global__ void __launch_bounds__(THREADS, MinCtas<CT>::value)
rcg_norm_kernel(const LT* __restrict__ logL, const LT* __restrict__ counts,
                const CT* __restrict__ psi, CT c, const CT* __restrict__ v, int64_t E,
                int64_t G, bool vec, int64_t rows_per_cta, double* __restrict__ part) {
  __shared__ CT rowres[TILE_ROWS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nch = (int)((G + CHUNK - 1) / CHUNK);
  int64_t lo, hi;
  cta_rows(E, rows_per_cta, lo, hi);
  LT L[NPL];
  CT pr[NPL], vr[NPL];
  load_cols(psi, 0, G, lane, pr);
  load_cols(v, 0, G, lane, vr);
  double acc = 0.0;  // read by thread 0 only
  for (int64_t t0 = lo; t0 < hi; t0 += TILE_ROWS) {
    const int nr = (int)((hi - t0 < TILE_ROWS) ? hi - t0 : TILE_ROWS);
    for (int r = warp; r < nr; r += WARPS) {
      const LT* row = logL + (t0 + r) * G;
      load_row_chunk(row, 0, G, vec, lane, L);
      const CT res = norm_row<LT, CT>(row, G, vec, nch, lane, (CT)counts[t0 + r], c, psi, v,
                                      L, pr, vr);
      if (lane == 0) rowres[r] = res;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int r = 0; r < nr; ++r) acc += (double)rowres[r];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) part[blockIdx.x] = acc;
}

template <typename LT, typename CT>
static int launch_norm(const void* logL, const void* counts, const void* psi, CT c,
                       const void* v, int64_t E, int64_t G, int64_t rows_per_cta,
                       int64_t n_cta, void* part, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  rcg_norm_kernel<LT, CT><<<(unsigned)n_cta, THREADS, 0, s>>>(
      (const LT*)logL, (const LT*)counts, (const CT*)psi, c, (const CT*)v, E, G,
      vector_rows(logL, G), rows_per_cta, (double*)part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rcg_reduce_scalar<<<1, 32, 0, s>>>((const double*)part, n_cta, (double*)out);
  return (int)cudaGetLastError();
}

}  // namespace rcg

// Plain C entry points, one per instantiation (matrix type _ compute type).
// part is scratch of n_cta doubles, out one double; both on the device.
#define RCG_NORM_ENTRY(NAME, LT, CT)                                                    \
  extern "C" int NAME(const void* logL, const void* counts, const void* psi, CT c,    \
                      const void* v, int64_t E, int64_t G, int64_t rows_per_cta,      \
                      int64_t n_cta, void* part, void* out, void* stream) {           \
    return rcg::launch_norm<LT, CT>(logL, counts, psi, c, v, E, G, rows_per_cta,     \
                                    n_cta, part, out, stream);                       \
  }

RCG_NORM_ENTRY(rcg_norm_f32_f32, float, float)
RCG_NORM_ENTRY(rcg_norm_f32_f64, float, double)
RCG_NORM_ENTRY(rcg_norm_f64_f64, double, double)

// Rows per CTA tile: the host rounds each CTA's row range to a multiple of
// it (msweep_tpu_torch/ops/rcg_kernels.py _grid), so it is read from here.
extern "C" int rcg_tile_rows(void) { return rcg::TILE_ROWS; }
