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
// memory once per pass, and every replicate does K2's two exps per cell.
// A CTA walks its contiguous rows in tiles, and inside a tile the
// replicates in chunks of up to RB.  Phase A: a warp loads its row into
// registers once per chunk and runs K2's row function (rcg_common.cuh
// data_row) for each replicate over those registers, writing the new
// softmax's weights into the tile's (replicate, row, G) block of shared
// memory.  Phase B: one thread per column adds each replicate's weights
// in row order into the CTA's own (B, G) slice of the (n_cta, B, G)
// float64 partials.  Rows are added in the order K2 adds them, whatever
// the tile size, so with the same grid replicate b gives the bits of K2
// on column b.  No atomics; the second stage sums the partials in CTA
// order.  c comes by device pointer, so a batched iteration needs no host
// sync.  Any B >= 1.  Left for later work: sharing the per-row setup
// across replicates.
#include "rcg_common.cuh"

namespace rcg {

template <typename LT, typename CT>
__global__ void __launch_bounds__(THREADS, MinCtas<CT>::value)
rcg_update_batch_kernel(const LT* __restrict__ logL, const LT* __restrict__ countsT,
                        const CT* __restrict__ c_old, const CT* __restrict__ v_old,
                        const CT* __restrict__ c_new, const CT* __restrict__ v_new,
                        int absolute, int64_t E, int64_t G, int64_t B, bool vec,
                        int64_t rows_per_cta, int tile, int rb,
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
  CT vn[NPL], vo[NPL];
  for (int64_t t0 = lo; t0 < hi; t0 += step) {
    const int nr = (int)((hi - t0 < step) ? hi - t0 : step);
    for (int64_t b0 = 0; b0 < B; b0 += rb) {
      const int nb = (int)((B - b0 < rb) ? B - b0 : rb);
      // Phase A: row terms and weights, one warp per row, over one load of it.
      for (int r = warp; r < nr; r += WARPS) {
        const int64_t e = t0 + r;
        const LT* row = logL + e * G;
        load_row_chunk(row, 0, G, vec, lane, L);
        for (int j = 0; j < nb; ++j) {
          const int64_t b = b0 + j;
          const CT cnt = (CT)countsT[e * B + b];
          load_cols(v_new + b * G, 0, G, lane, vn);
          CT res = data_row<LT, CT>(row, G, vec, nch, lane, cnt, c_new[b], v_new + b * G, L, vn,
                                    direct ? nullptr : wt + ((int64_t)j * tile + r) * G,
                                    direct ? cols + b * G : nullptr);
          if (!absolute) {
            load_cols(v_old + b * G, 0, G, lane, vo);
            res = res - data_row<LT, CT>(row, G, vec, nch, lane, cnt, c_old[b], v_old + b * G, L,
                                         vo, nullptr, nullptr);
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
      // Phase B: column partials of each replicate's w, rows in order.
      for (int j = 0; j < nb && !direct; ++j) {
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

template <typename LT, typename CT>
static int launch_update_batch(const void* logL, const void* countsT, const void* c_old,
                               const void* v_old, const void* c_new, const void* v_new,
                               int absolute, int64_t E, int64_t G, int64_t B,
                               int64_t rows_per_cta, int64_t n_cta, void* part_scalar,
                               void* part_cols, void* out_scalar, void* out_cols,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  static WtileBudget cache;
  int64_t budget = 0;
  cudaError_t err =
      wtile_budget<CT>((const void*)rcg_update_batch_kernel<LT, CT>, cache, budget);
  if (err != cudaSuccess) return (int)err;
  // The replicate chunk (RB, 4, 2 or 1) whose tile of weights keeps the
  // most warps busy in phase A (one row each), the widest on a tie; with
  // no tile that fits, RB replicates run direct.
  const int64_t row_bytes = (G > 0 ? G : 1) * (int64_t)sizeof(CT);
  int rb = RB, tile = 0;
  for (int r = RB; r >= 1; r /= 2) {
    const int t = wtile_rows(budget, r * row_bytes);
    if ((t < WARPS ? t : WARPS) > (tile < WARPS ? tile : WARPS)) rb = r, tile = t;
  }
  const size_t smem = (size_t)rb * tile * row_bytes;
  rcg_update_batch_kernel<LT, CT><<<(unsigned)n_cta, THREADS, smem, s>>>(
      (const LT*)logL, (const LT*)countsT, (const CT*)c_old, (const CT*)v_old,
      (const CT*)c_new, (const CT*)v_new, absolute, E, G, B, vector_rows(logL, G), rows_per_cta,
      tile, rb, (double*)part_scalar, (double*)part_cols);
  err = cudaGetLastError();
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
// Returns a CUDA error.
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
