// K4: pass 2 of one implicit rcg iteration for B bootstrap replicates.
//
// Replaces the TPU kernel msweep_tpu/ops/rcg_pallas.py rcg_update_batch /
// _update_batch_kernel.  For each replicate b (counts = column b of the
// (E, B) countsT) it returns what K2 (rcg_update.cu) returns for that
// replicate alone:
//
//     colsum_bg = sum_e w_eg at (c_new_b, v_new_b)                  (B, G)
//     scalar_b  = sum_e (row(c_new_b, v_new_b) - row(c_old_b, v_old_b))  delta
//               = sum_e row(c_new_b, v_new_b)                     absolute
//
// The absolute mode at (c, v) = (0, 0) is the batched init: colsum0 and
// data0 of every replicate in one pass (msweep_tpu/inference/rcg.py
// _rcg_init_implicit_batch computes them with two einsums).
//
// Bound by compute once B is more than a few: logL is read from device
// memory once per pass; each replicate re-walks the tile from L1/L2.  A CTA
// walks its contiguous rows in tiles of TILE_ROWS, and inside a tile the
// replicates in chunks of RB.  Phase A: one warp per row computes the
// replicates' row terms and keeps (max, denom, count) of each new softmax
// in shared memory.  Phase B: threads own columns and walk the tile's rows
// in order for each replicate, adding w into the CTA's own (B, G) slice of
// the (n_cta, B, G) float64 partials.  Both phases add in the order K2
// does, so with the same grid replicate b gives the bits of K2 on column b.
// No atomics; the second stage sums the partials in CTA order.  c comes by
// device pointer, so a batched iteration needs no host sync.  Any B >= 1.
#include "rcg_common.cuh"

namespace rcg {

template <typename LT, typename CT>
__global__ void __launch_bounds__(THREADS)
rcg_update_batch_kernel(const LT* __restrict__ logL, const LT* __restrict__ countsT,
                        const CT* __restrict__ c_old, const CT* __restrict__ v_old,
                        const CT* __restrict__ c_new, const CT* __restrict__ v_new,
                        int absolute, int64_t E, int64_t G, int64_t B, int64_t rows_per_cta,
                        double* __restrict__ part_scalar, double* __restrict__ part_cols) {
  __shared__ CT rowres[TILE_ROWS * RB], rmax[TILE_ROWS * RB], rden[TILE_ROWS * RB],
      rcnt[TILE_ROWS * RB];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int64_t lo, hi;
  cta_rows(E, rows_per_cta, lo, hi);
  double* __restrict__ acc = part_scalar + (int64_t)blockIdx.x * B;
  double* __restrict__ cols = part_cols + (int64_t)blockIdx.x * B * G;
  for (int64_t i = threadIdx.x; i < B * G; i += THREADS) cols[i] = 0.0;
  for (int64_t b = threadIdx.x; b < B; b += THREADS) acc[b] = 0.0;
  __syncthreads();
  for (int64_t t0 = lo; t0 < hi; t0 += TILE_ROWS) {
    const int nr = (int)((hi - t0 < TILE_ROWS) ? hi - t0 : TILE_ROWS);
    for (int64_t b0 = 0; b0 < B; b0 += RB) {
      const int nb = (int)((B - b0 < RB) ? B - b0 : RB);
      // Phase A: row terms, one warp per row, the chunk's replicates in turn.
      for (int k = 0; k < ROWS_PER_WARP; ++k) {
        const int r = warp * ROWS_PER_WARP + k;
        const int64_t e = t0 + r;
        if (e < hi) {
          const LT* row = logL + e * G;
          for (int j = 0; j < nb; ++j) {
            const int64_t b = b0 + j;
            const CT cnt = (CT)countsT[e * B + b];
            CT m, den;
            CT res = row_data_term<LT, CT>(row, G, cnt, c_new[b], v_new + b * G, lane, m, den);
            if (!absolute) {
              CT m_o, den_o;
              res = res - row_data_term<LT, CT>(row, G, cnt, c_old[b], v_old + b * G, lane, m_o,
                                                den_o);
            }
            if (lane == 0) {
              const int i = r * RB + j;
              rowres[i] = res;
              rmax[i] = m;
              rden[i] = den;
              rcnt[i] = cnt;
            }
          }
        }
      }
      __syncthreads();
      if (threadIdx.x < nb) {
        double s = acc[b0 + threadIdx.x];
        for (int r = 0; r < nr; ++r) s += (double)rowres[r * RB + threadIdx.x];
        acc[b0 + threadIdx.x] = s;
      }
      // Phase B: column partials of w at (c_new, v_new), rows in order.
      for (int j = 0; j < nb; ++j) {
        const int64_t b = b0 + j;
        const CT cb = c_new[b];
        const CT* __restrict__ vb = v_new + b * G;
        double* __restrict__ colb = cols + b * G;
        for (int64_t g = threadIdx.x; g < G; g += THREADS) {
          const CT vg = vb[g];
          double s = colb[g];
          for (int r = 0; r < nr; ++r) {
            const int i = r * RB + j;
            const CT gh = ghat((CT)logL[(t0 + r) * G + g], cb, vg);
            const CT num = cexp(gh - rmax[i]);
            s += (double)(rcnt[i] * (num / rden[i]));
          }
          colb[g] = s;
        }
      }
      __syncthreads();
    }
  }
}

template <typename LT, typename CT>
static int launch_update_batch(const void* logL, const void* countsT, const void* c_old,
                               const void* v_old, const void* c_new, const void* v_new,
                               int absolute, int64_t E, int64_t G, int64_t B,
                               int64_t rows_per_cta, int64_t n_cta, void* part_scalar,
                               void* part_cols, void* out_scalar, void* out_cols,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  rcg_update_batch_kernel<LT, CT><<<(unsigned)n_cta, THREADS, 0, s>>>(
      (const LT*)logL, (const LT*)countsT, (const CT*)c_old, (const CT*)v_old,
      (const CT*)c_new, (const CT*)v_new, absolute, E, G, B, rows_per_cta,
      (double*)part_scalar, (double*)part_cols);
  cudaError_t err = cudaGetLastError();
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

}  // namespace rcg

// Plain C entry points, one per instantiation (matrix type _ compute type).
// countsT is (E, B) in the matrix type; v_old and v_new are (B, G), c_old
// and c_new (B,), in the compute type.  part_scalar is scratch of n_cta * B
// doubles, part_cols of n_cta * B * G; out_scalar is B doubles, out_cols
// B * G; all on the device.  In absolute mode c_old and v_old are not read.
#define RCG_UPDATE_BATCH_ENTRY(NAME, LT, CT)                                                  \
  extern "C" int NAME(const void* logL, const void* countsT, const void* c_old,               \
                      const void* v_old, const void* c_new, const void* v_new, int absolute,  \
                      int64_t E, int64_t G, int64_t B, int64_t rows_per_cta, int64_t n_cta,   \
                      void* part_scalar, void* part_cols, void* out_scalar, void* out_cols,   \
                      void* stream) {                                                         \
    return rcg::launch_update_batch<LT, CT>(logL, countsT, c_old, v_old, c_new, v_new,       \
                                            absolute, E, G, B, rows_per_cta, n_cta,          \
                                            part_scalar, part_cols, out_scalar, out_cols,    \
                                            stream);                                         \
  }

RCG_UPDATE_BATCH_ENTRY(rcg_update_batch_f32_f32, float, float)
RCG_UPDATE_BATCH_ENTRY(rcg_update_batch_f64_f64, double, double)
