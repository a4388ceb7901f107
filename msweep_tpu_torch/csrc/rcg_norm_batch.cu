// K3: pass 1 of one implicit rcg iteration for B bootstrap replicates.
//
// Replaces the TPU kernel msweep_tpu/ops/rcg_pallas.py rcg_norm_batch /
// _norm_batch_kernel.  Replicate b has its own counts (column b of the
// (E, B) countsT), psi_b, c_b and v_b; all B share one stream of logL.  It
// returns, for each b, the Fletcher-Reeves metric norm that K1
// (rcg_norm.cu) returns for that replicate alone.
//
// Bound by compute once B is more than a few: logL is read from device
// memory once per pass, and every replicate does K1's two exps per cell.
// A CTA walks its contiguous rows in tiles of TILE_ROWS; inside a tile the
// replicates go in chunks of RB.  A warp loads its row into registers once
// per chunk and runs K1's row function (rcg_common.cuh norm_row) for each
// replicate of the chunk over those registers, with the replicate's psi
// and v loaded from L1/L2.  The row terms wait in shared memory until one
// thread per replicate adds them in row order into the CTA's float64
// partial: the order in which K1 adds them, so with the same grid
// replicate b gives the bits of K1 on column b.  Partials are (n_cta, B)
// doubles, summed in CTA order by the second stage: no atomics.  c comes
// by device pointer, so a batched iteration needs no host sync.  The TPU
// kernel's replicate padding to 8, iota masks and SMEM scalar tables have
// no counterpart: any B >= 1 is taken as it is.  Left for later work:
// sharing the per-row setup across replicates.
#include "rcg_common.cuh"

namespace rcg {

template <typename LT, typename CT>
__global__ void __launch_bounds__(THREADS, MinCtas<CT>::value)
rcg_norm_batch_kernel(const LT* __restrict__ logL, const LT* __restrict__ countsT,
                      const CT* __restrict__ psi, const CT* __restrict__ c,
                      const CT* __restrict__ v, int64_t E, int64_t G, int64_t B, bool vec,
                      int64_t rows_per_cta, double* __restrict__ part) {
  __shared__ CT rowres[TILE_ROWS * RB];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nch = (int)((G + CHUNK - 1) / CHUNK);
  int64_t lo, hi;
  cta_rows(E, rows_per_cta, lo, hi);
  double* __restrict__ acc = part + (int64_t)blockIdx.x * B;
  for (int64_t b = threadIdx.x; b < B; b += THREADS) acc[b] = 0.0;
  __syncthreads();
  LT L[NPL];
  CT pr[NPL], vr[NPL];
  for (int64_t t0 = lo; t0 < hi; t0 += TILE_ROWS) {
    const int nr = (int)((hi - t0 < TILE_ROWS) ? hi - t0 : TILE_ROWS);
    for (int64_t b0 = 0; b0 < B; b0 += RB) {
      const int nb = (int)((B - b0 < RB) ? B - b0 : RB);
      for (int r = warp; r < nr; r += WARPS) {
        const int64_t e = t0 + r;
        const LT* row = logL + e * G;
        load_row_chunk(row, 0, G, vec, lane, L);
        for (int j = 0; j < nb; ++j) {
          const int64_t b = b0 + j;
          load_cols(psi + b * G, 0, G, lane, pr);
          load_cols(v + b * G, 0, G, lane, vr);
          const CT res = norm_row<LT, CT>(row, G, vec, nch, lane, (CT)countsT[e * B + b], c[b],
                                          psi + b * G, v + b * G, L, pr, vr);
          if (lane == 0) rowres[r * RB + j] = res;
        }
      }
      __syncthreads();
      if (threadIdx.x < nb) {
        double s = acc[b0 + threadIdx.x];
        for (int r = 0; r < nr; ++r) s += (double)rowres[r * RB + threadIdx.x];
        acc[b0 + threadIdx.x] = s;
      }
      __syncthreads();
    }
  }
}

template <typename LT, typename CT>
static int launch_norm_batch(const void* logL, const void* countsT, const void* psi,
                             const void* c, const void* v, int64_t E, int64_t G, int64_t B,
                             int64_t rows_per_cta, int64_t n_cta, void* part, void* out,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  rcg_norm_batch_kernel<LT, CT><<<(unsigned)n_cta, THREADS, 0, s>>>(
      (const LT*)logL, (const LT*)countsT, (const CT*)psi, (const CT*)c, (const CT*)v, E, G,
      B, vector_rows(logL, G), rows_per_cta, (double*)part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // out[b] = sum over CTAs of part[cta, b], in CTA order.
  rcg_reduce_cols<<<(unsigned)((B + 255) / 256), 256, 0, s>>>((const double*)part, n_cta, B,
                                                                (double*)out);
  return (int)cudaGetLastError();
}

}  // namespace rcg

// Plain C entry points, one per instantiation (matrix type _ compute type).
// countsT is (E, B) in the matrix type; psi and v are (B, G) and c is (B,)
// in the compute type; part is scratch of n_cta * B doubles, out B doubles;
// all on the device.
#define RCG_NORM_BATCH_ENTRY(NAME, LT, CT)                                                   \
  extern "C" int NAME(const void* logL, const void* countsT, const void* psi, const void* c, \
                      const void* v, int64_t E, int64_t G, int64_t B, int64_t rows_per_cta,  \
                      int64_t n_cta, void* part, void* out, void* stream) {                  \
    return rcg::launch_norm_batch<LT, CT>(logL, countsT, psi, c, v, E, G, B, rows_per_cta,  \
                                          n_cta, part, out, stream);                        \
  }

RCG_NORM_BATCH_ENTRY(rcg_norm_batch_f32_f32, float, float)
RCG_NORM_BATCH_ENTRY(rcg_norm_batch_f64_f64, double, double)
