// K3: pass 1 of one implicit rcg iteration for B bootstrap replicates.
//
// Replaces the TPU kernel msweep_tpu/ops/rcg_pallas.py rcg_norm_batch /
// _norm_batch_kernel.  Replicate b has its own counts (column b of the
// (E, B) countsT), psi_b, c_b and v_b; all B share one stream of logL.  It
// returns, for each b, the Fletcher-Reeves metric norm that K1
// (rcg_norm.cu) returns for that replicate alone, and the (E, B) row terms
// of the ELBO's data term at (c_b, v_b) (rcg_common.cuh data_row's bits),
// which K4 subtracts in the same iteration in place of a second softmax.
// A replicate flagged in done[] (the caller's done mask, read on the card)
// does no row work: its norm and row terms are 0.
//
// Bound by compute: logL is read from device memory once a pass, and each
// live replicate does K1's two exps per cell.  Rows of one chunk
// (G <= 512) run a warp per replicate: CTA (x, y) takes the y-th range of
// rows (K1's ranges) for replicates 8x to 8x + 7, stages its rows tile by
// tile in shared memory with cp.async (rcg_common.cuh walk_staged_rows),
// and each warp walks every row of the range for its own replicate with
// that replicate's psi, v and c at hand, reading the row from shared
// memory.  Each row is a chain of dependent steps (two merges, each with a
// warp max and a warp sum, two logs and a division, then a second pass and
// two more warp sums), so the time follows the warps an SM that keep
// chains in flight.  In float32 the row, psi and v sit in registers at two
// CTAs of 8 warps an SM.  In float64 psi and v are written once a launch
// to shared memory (64 KB a CTA) and the rows are staged there, all in
// slot order (rcg_common.cuh SharedSlots), and read where a row uses them:
// that keeps a thread within 128 registers, so two CTAs, 16 warps, fit an
// SM where the row, psi and v in registers took 255 registers and one CTA
// (with the row alone left in registers, 128 spilled in the row loop); the
// ring takes what is left (6 rows a tile at G = 512).  The warp adds its
// row norms into a float64 register in row order, the order in which K1
// adds them, so with the same grid replicate b gives K1's bits on column b.  Wider rows run a warp per row, as K1
// does: a warp loads its row's first chunk once per chunk of RB replicates
// and runs norm_row for each, reloading the replicate's psi and v, and one
// thread per replicate adds the row norms in row order.  Partials are
// (n_cta, B) doubles, summed in CTA order by the second stage: no atomics.
// c comes by device pointer, so a batched iteration needs no host sync.
// The TPU kernel's replicate padding to 8, iota masks and SMEM scalar
// tables have no counterpart: any B >= 1 is taken as it is.
#include "rcg_common.cuh"

namespace rcg {

// K3's float64 one-chunk build keeps the staged rows and each warp's psi
// and v in shared memory in slot order (rcg_common.cuh SharedSlots), the
// vectors in front of the ring.
template <typename CT>
struct RepSlots {
  static constexpr bool shared = sizeof(CT) == 8;
  static constexpr int64_t cols_bytes = shared ? 2 * (int64_t)WARPS * CHUNK * sizeof(CT) : 0;
};
constexpr int REP_CTAS = 2;  // CTAs an SM of the one-chunk build, in both types

// walk_staged_rows with each row staged in slot order: CHUNK cells a row,
// -inf beyond G (written once, never overwritten), one cp.async a cell, so
// that fn(e, row) reads a lane's slots of row e as SharedSlots at row +
// lane.  ring holds 2 * tile rows.
template <typename LT, typename Fn>
__device__ __forceinline__ void walk_slot_rows(LT* ring, const LT* __restrict__ logL, int64_t G,
                                               int64_t lo, int64_t hi, int tile, bool live,
                                               Fn fn) {
  const int64_t cells = (int64_t)tile * CHUNK;
  for (int64_t i = threadIdx.x; i < 2 * cells; i += THREADS)
    if (slot_col(0, (int)(i % CHUNK) / 32, (int)(i % 32)) >= G) ring[i] = neg_inf<LT>();
  auto stage = [&](LT* dst, int64_t t0, int64_t t1) {
    for (int64_t e = t0; e < t1; ++e, dst += CHUNK)
      for (int c = threadIdx.x; c < G; c += THREADS)
        cp_async<(int)sizeof(LT)>(dst + slot_pos(c), logL + e * G + c);
  };
  if (lo < hi) {
    stage(ring, lo, hi - lo < tile ? hi : lo + tile);
    cp_async_commit();
  }
  int k = 0;
  for (int64_t t0 = lo; t0 < hi; t0 += tile, k ^= 1) {
    const int64_t t1 = hi - t0 < tile ? hi : t0 + tile;
    if (t1 < hi) stage(ring + (k ^ 1) * cells, t1, hi - t1 < tile ? hi : t1 + tile);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (this thread's), then everyone's
    __syncthreads();
    if (live)
      for (int64_t e = t0; e < t1; ++e) fn(e, ring + k * cells + (e - t0) * CHUNK);
    __syncthreads();  // the buffer is refilled by the next iteration
  }
}

// Rows of one chunk: warp w of CTA (x, y) is replicate 8x + w over row range y.
template <typename LT, typename CT>
__global__ void __launch_bounds__(THREADS, REP_CTAS)
rcg_norm_batch_rep_kernel(const LT* __restrict__ logL, const LT* __restrict__ countsT,
                          const CT* __restrict__ psi, const CT* __restrict__ c,
                          const CT* __restrict__ v, const bool* __restrict__ done, int64_t E,
                          int64_t G, int64_t B, bool vec, int64_t rows_per_cta, int tile,
                          double* __restrict__ part, CT* __restrict__ rowterm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t b = (int64_t)blockIdx.x * WARPS + warp;
  const bool live = b < B && !(done != nullptr && done[b]);
  int64_t lo, hi;
  range_rows(blockIdx.y, E, rows_per_cta, lo, hi);
  double acc = 0.0;  // lane 0's is the replicate's
  if (__syncthreads_or(live)) {
    if constexpr (RepSlots<CT>::shared) {
      const CT cb = live ? c[b] : (CT)0;
      CT* cols = reinterpret_cast<CT*>(smem) + (int64_t)warp * 2 * CHUNK + lane;
      if (live) {  // each lane reads back only the slots it writes
        store_shared_cols(psi + b * G, G, lane, cols);
        store_shared_cols(v + b * G, G, lane, cols + CHUNK);
      }
      SharedSlots<CT> pr{cols}, vr{cols + CHUNK};
      walk_slot_rows(reinterpret_cast<LT*>(smem + RepSlots<CT>::cols_bytes), logL, G, lo, hi,
                     tile, live, [&](int64_t e, const LT* row) {
                       SharedSlots<LT> L{row + lane};
                       CT data;
                       const CT res = norm_row<LT, CT, true>(row, G, vec, 1, lane,
                                                             (CT)countsT[e * B + b], cb, nullptr,
                                                             nullptr, L, pr, vr, &data);
                       if (lane == 0) {
                         acc += (double)res;
                         rowterm[e * B + b] = data;
                       }
                     });
    } else {
      LT L[NPL];
      CT pr[NPL], vr[NPL], cb = 0;
      if (live) {
        load_cols(psi + b * G, 0, G, lane, pr);
        load_cols(v + b * G, 0, G, lane, vr);
        cb = c[b];
      }
      walk_staged_rows(reinterpret_cast<LT*>(smem), logL, G, vec, lo, hi, tile, live,
                       [&](int64_t e, const LT* row) {
                         const CT cnt = (CT)countsT[e * B + b];
                         load_row_shared(row, G, vec, lane, L);
                         CT data;
                         const CT res = norm_row<LT, CT, true>(row, G, vec, 1, lane, cnt, cb,
                                                               nullptr, nullptr, L, pr, vr, &data);
                         if (lane == 0) {
                           acc += (double)res;
                           rowterm[e * B + b] = data;
                         }
                       });
    }
  }
  if (b < B && lane == 0) part[(int64_t)blockIdx.y * B + b] = acc;
}

// Wider rows: a warp per row, replicates in chunks of RB over one load of
// the row's first chunk.
template <typename LT, typename CT>
__global__ void __launch_bounds__(THREADS, MinCtas<CT>::value)
rcg_norm_batch_kernel(const LT* __restrict__ logL, const LT* __restrict__ countsT,
                      const CT* __restrict__ psi, const CT* __restrict__ c,
                      const CT* __restrict__ v, const bool* __restrict__ done, int64_t E,
                      int64_t G, int64_t B, bool vec, int64_t rows_per_cta,
                      double* __restrict__ part, CT* __restrict__ rowterm) {
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
      bool any = done == nullptr;
      for (int j = 0; j < nb && !any; ++j) any = !done[b0 + j];
      if (!any) continue;  // the same on every thread: no barrier skipped unevenly
      for (int r = warp; r < nr; r += WARPS) {
        const int64_t e = t0 + r;
        const LT* row = logL + e * G;
        load_row_chunk(row, 0, G, vec, lane, L);
        for (int j = 0; j < nb; ++j) {
          const int64_t b = b0 + j;
          CT res = 0;
          if (done == nullptr || !done[b]) {
            load_cols(psi + b * G, 0, G, lane, pr);
            load_cols(v + b * G, 0, G, lane, vr);
            CT data;
            res = norm_row<LT, CT, true>(row, G, vec, nch, lane, (CT)countsT[e * B + b], c[b],
                                         psi + b * G, v + b * G, L, pr, vr, &data);
            if (lane == 0) rowterm[e * B + b] = data;
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
      __syncthreads();
    }
  }
}

template <typename LT, typename CT>
static cudaError_t norm_rep_plan(int64_t G, const void*& kernel, int& tile, size_t& smem) {
  static WtileBudget cache;
  kernel = (const void*)rcg_norm_batch_rep_kernel<LT, CT>;
  // the slot-order ring holds CHUNK cells a row
  return rep_tile<LT, CT>(kernel, RepSlots<CT>::shared ? CHUNK : G, cache, tile, smem, REP_CTAS,
                          RepSlots<CT>::cols_bytes);
}

template <typename LT, typename CT>
static int launch_norm_batch(const void* logL, const void* countsT, const void* psi,
                             const void* c, const void* v, const void* done, int64_t E,
                             int64_t G, int64_t B, int64_t rows_per_cta, int64_t n_cta,
                             void* part, void* rowterm, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  bool vec = vector_rows(logL, G);
  cudaError_t err;
  if (G <= CHUNK) {
    const void* kernel = nullptr;
    int tile = 0;
    size_t smem = 0;
    err = norm_rep_plan<LT, CT>(G, kernel, tile, smem);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {&logL, &countsT, &psi, &c, &v, &done, &E, &G, &B, &vec, &rows_per_cta,
                    &tile, &part, &rowterm};
    err = cudaLaunchKernel(kernel, dim3((unsigned)((B + WARPS - 1) / WARPS), (unsigned)n_cta),
                           dim3(THREADS), args, smem, s);
  } else {
    rcg_norm_batch_kernel<LT, CT><<<(unsigned)n_cta, THREADS, 0, s>>>(
        (const LT*)logL, (const LT*)countsT, (const CT*)psi, (const CT*)c, (const CT*)v,
        (const bool*)done, E, G, B, vec, rows_per_cta, (double*)part, (CT*)rowterm);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  // out[b] = sum over CTAs of part[cta, b], in CTA order.
  rcg_reduce_cols<<<(unsigned)((B + 255) / 256), 256, 0, s>>>((const double*)part, n_cta, B,
                                                                (double*)out);
  return (int)cudaGetLastError();
}

// out = kernel_info of the build G columns run: registers, spilled bytes,
// tile rows (0 for the warp-per-row build, which stages no rows), CTAs an
// SM and warps an SM.
template <typename LT, typename CT>
static int info_norm_batch(int64_t G, int* out) {
  const void* kernel = (const void*)rcg_norm_batch_kernel<LT, CT>;
  int tile = 0;
  size_t smem = 0;
  if (G <= CHUNK) {
    const cudaError_t err = norm_rep_plan<LT, CT>(G, kernel, tile, smem);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)kernel_info(kernel, tile, smem, out);
}

}  // namespace rcg

// Plain C entry points, one per instantiation (matrix type _ compute type).
// countsT is (E, B) in the matrix type; psi and v are (B, G) and c is (B,)
// in the compute type; done is (B,) bool or null (no replicate done); part
// is scratch of n_cta * B doubles, rowterm (E, B) in the compute type
// (left as it is for done replicates), out B doubles; all on the device.
// *_info fills five ints (rcg::info_norm_batch).  Both return a CUDA error.
#define RCG_NORM_BATCH_ENTRY(NAME, LT, CT)                                                    \
  extern "C" int NAME(const void* logL, const void* countsT, const void* psi, const void* c,  \
                      const void* v, const void* done, int64_t E, int64_t G, int64_t B,       \
                      int64_t rows_per_cta, int64_t n_cta, void* part, void* rowterm,         \
                      void* out, void* stream) {                                              \
    return rcg::launch_norm_batch<LT, CT>(logL, countsT, psi, c, v, done, E, G, B,           \
                                          rows_per_cta, n_cta, part, rowterm, out, stream);  \
  }                                                                                           \
  extern "C" int NAME##_info(int64_t G, int* out) {                                           \
    return rcg::info_norm_batch<LT, CT>(G, out);                                              \
  }

RCG_NORM_BATCH_ENTRY(rcg_norm_batch_f32_f32, float, float)
RCG_NORM_BATCH_ENTRY(rcg_norm_batch_f64_f64, double, double)
