// K1: pass 1 of one implicit rcg iteration, the Fletcher-Reeves metric norm.
//
// Replaces the TPU kernel msweep_tpu/ops/rcg_pallas.py rcg_norm /
// _norm_kernel, and its float64 twin msweep_tpu/ops/rcg_xla.py rcg_norm.
// With t = logL + psi, s = (t - lse_row(t)) - gamma and
// gamma = masked row softmax of c * logL + v, it returns
//
//     sum_e sum_g counts_e * exp(gamma_eg) * s_eg^2
//
// with exp(gamma) taken as num / denom of the softmax, as the TPU kernel does.
//
// Bound by memory: one pass streams logL once, 4 B/cell in float32 (an
// iteration is this pass plus K2, 8 B/cell).  One warp owns a row and walks
// it three times (maxima, exp sums, weighted terms); the second and third
// walks hit L1, so device memory sees the row once.  Left on the table for
// later work: TMA bulk loads of row tiles into shared memory, holding the
// row in registers so the third walk does not recompute exp(ghat - m), and
// vectorised 16-byte loads.
#include "rcg_common.cuh"

namespace rcg {

template <typename LT, typename CT>
__global__ void __launch_bounds__(THREADS)
rcg_norm_kernel(const LT* __restrict__ logL, const LT* __restrict__ counts,
                const CT* __restrict__ psi, CT c, const CT* __restrict__ v, int64_t E,
                int64_t G, int64_t rows_per_cta, double* __restrict__ part) {
  __shared__ CT rowres[TILE_ROWS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int64_t lo, hi;
  cta_rows(E, rows_per_cta, lo, hi);
  double acc = 0.0;  // read by thread 0 only
  for (int64_t t0 = lo; t0 < hi; t0 += TILE_ROWS) {
    for (int k = 0; k < ROWS_PER_WARP; ++k) {
      const int r = warp * ROWS_PER_WARP + k;
      const int64_t e = t0 + r;
      if (e < hi) {
        const CT res = norm_row<LT, CT>(logL + e * G, G, (CT)counts[e], psi, c, v, lane);
        if (lane == 0) rowres[r] = res;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int64_t nr = (hi - t0 < TILE_ROWS) ? hi - t0 : TILE_ROWS;
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
      rows_per_cta, (double*)part);
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
