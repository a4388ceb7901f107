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
// counts * exp(t - lse) is taken as exp(t - max) * (counts / denom), one
// division per row, as the TPU kernel takes (c / s) * e.
//
// Bound: one read of logL (4 or 8 B/cell) in both types.  The work per
// cell is one exp and ~6 other operations; in float64 the exp is 18 FP64
// instructions (msweep_tpu_torch/exp_cost.py), which puts the operations
// bound (~1.7 ms at 2,301,952 x 512) below the bytes bound (2.83 ms): the
// FP64 exp chain's latency and the registers it takes are what the design
// must hide.  The design is K2's: a CTA walks its contiguous rows in tiles.
// The row ranges are the ones K6 (em_step_batch.cu) runs on, so that its
// replicates give K5's bits: lcm(K5's CTAs an SM, K6's) x SMs ranges of
// whole tiles (rcg_common.cuh split_rows, ops/rcg_kernels.py em_ranges), a
// whole number of waves for both kernels.  So K5's numerics follow K6's
// build: a change to K6's CTAs an SM (em_step_batch.cu RepBuild::ctas)
// moves K5's row ranges, and K5's bits by float64 round-off.
// Rows of one chunk (G <= 512) run an instantiation compiled for one chunk
// at three CTAs an SM, in float64 too, so that one CTA's exps overlap the
// others' loads and phase B.  Phase A: a warp holds its row in registers
// (16 cells a lane, 16-byte loads), so each cell of logL is read once from
// memory; one exp per cell gives the row's max, exp sum and lse
// (rcg_common.cuh em_row_stats), and the kept exps times cnt / denom are
// the weights w, written into the tile's rows in shared memory; the row's
// ddot term waits in shared memory and is added into the CTA's float64
// partial in row order.  Phase B: one thread per column adds the tile's w
// into its columns of the CTA's partials in row order, with no re-read of
// logL and no second exp; a thread keeps its two columns in registers
// across the tiles and writes them once at the end.  Three CTAs leave 85
// registers a thread, so logtheta is read from L1 for each row rather
// than held in registers.  The exps are K6's, rcg_common.cuh row_exps: in
// float64 CUDA's exp with its branches taken as selects, so a row's 16
// exps interleave whatever their arguments.
// Wider rows (G > 512) keep K5's values: chunk c's exps at the running
// max M_c = cmax(M_{c-1}, max of chunk c), den = den * exp(M_{c-1} - M_c)
// + the chunk's sum in chunk order (rcg_common.cuh em_chunk_stats), w =
// exp(t - m) * crow with crow = cnt / den, lse = m + log(den).  Every one
// is a function of the chunks' maxima, their sums and the cells, so the
// pair, spread and owned builds take every chunk's max first and keep the
// bits: where M_c is already the row's max m, the sum's exps are the
// weights' exps, and a chunk takes its second exp only where a later chunk
// raises the max.  Five builds, each at two CTAs an SM or (the strided
// build's float32 rows of 17 to 32 chunks, float64 of 19 to 24 and 27 to
// 32) one CTA of more warps, which in float64, and in float32 at 17 and 18
// chunks, walks two row ranges in turn, so that K5 and K6's wide build
// share 2 x SMs row ranges at G > 512 in both types (ops/em_kernels.py
// ranges), chosen by G and the type (em_plan; mirrored by
// ops/em_kernels.py em_build), each timed against the others with
// msweep_tpu_torch/time_em_step.py (PERF.md section 6):
// - pair (em_step_pair_kernel, G <= 2 CHUNK): the one-chunk build's layout
//   with the row's two chunks in registers, 32 cells a lane, a warp a row:
//   one read a cell, the weights through a tile in shared memory.
// - spread (em_step_spread_kernel, 3 to SPREAD_MAX_CHUNKS chunks): a row
//   over a group of NC warps, warp c its chunk c in registers (16 cells a
//   lane, as the one-chunk build holds its row), a CTA of SPREAD_WARPS
//   warps taking SPREAD_WARPS / NC rows at once; the chunk maxima meet in
//   shared memory behind one named barrier of the group's warps a row,
//   the chunk sums and exp(t - m) go to a tile in shared memory, one
//   thread a row then replays the merge, and phase B adds the weights
//   into column partials it keeps in registers across the range.  One
//   read and one exp a cell (a second only before the chunk that holds
//   the max), none for the 128-column groups of a ragged last chunk that
//   lie wholly beyond G.
// - owned (em_step_owned_kernel, OWNED_MIN_CHUNKS to WARPS chunks): the
//   CTA takes one row at a time, warp c its chunk c in registers, each
//   lane its own cells of the next rows copied ahead into its warp's ring
//   (cp.async), so each cell is read once from device memory, and the
//   lane keeps its 16 columns' partials in registers across the range
//   (rows in order, written once).  Two barriers a row: after the chunks'
//   maxima, and after their exp sums; every warp then replays the merge.
// - strided (em_step_strided_kernel, WARPS + 1 to STRIDED_MAX_CHUNKS
//   chunks, in float32 STRIDED_WIDE_MIN_CHUNKS to twice that at one CTA
//   an SM, and the walking layout's rows at one CTA an SM that walks
//   STRIDED_WALK ranges: float32 17 and 18 chunks and float64 19 to 24 at
//   a warp a chunk, float64 27 to 32 at a warp two): the owned build's row
//   a step with more chunks than warps: warp w of NW holds chunks w, w +
//   NW, ... of the row in registers, the CTA's float64 column partials lie
//   in shared memory, each lane's own slots (no atomics, rows in order),
//   logtheta is read from L1 (at a warp a chunk on the walking layout from
//   shared memory, where its partials leave L1 too small) and the row
//   through L2 (in float32 the CTA prefetches its next row there while it
//   works on this one).  One read of each cell from device memory and one
//   exp (a second only before the chunk that holds the max); two barriers
//   a row.
// - direct (em_step_kernel<..., false>, the other rows wider than WARPS
//   chunks: beyond 32 chunks, whose partials do not fit in shared memory,
//   and float64 of 17, 18, 25 and 26, where no one-read layout measured
//   was faster on both fresh and late-fit inputs): a warp a row; phase A
//   merges a row's chunks into its max and exp sum;
//   then, a slab of columns at a time (as many chunks as 8 rows of weights
//   fit in the CTA's shared memory), each warp reads its row's chunks in
//   the slab again and takes w with a second exp (em_chunk_w) into the
//   slab's tile, and phase B adds the slab's columns in row order into the
//   CTA's partials in device memory.  Two reads and two exps a cell.
// The weights, and the order of the adds into each column, depend on
// neither the build nor its tile.
// No atomics: the second stage sums the partials in CTA order, so a rerun
// gives the same bits.  Padding: NEG cells (and NEG + NEG = -2e8 where
// theta = 0, finite in float32) get weight exactly 0; count-0 rows add 0.
// The done flag comes by device pointer: when *done is set every CTA
// writes zeros (its rows of lse, its partials) and returns without reading
// logL, so a converged state inside a chunk of inference/em.py costs
// launches, not passes.
#include "rcg_common.cuh"

namespace rcg {

// CTAs an SM: three for rows of one chunk (at most 85 registers a thread,
// so that one CTA's FP64 exps overlap the others' phase B and loads), two
// for wider rows in every build, whose passes need more registers.
template <bool ONE_CHUNK>
constexpr int EM_CTAS = ONE_CHUNK ? 3 : 2;
constexpr int EM_WIDE_CTAS = EM_CTAS<false>;

// The builds (em_plan), numbered as em_step_*_info reports them.
enum EmBuild {
  EM_ONE_CHUNK = 0, EM_PAIR = 1, EM_OWNED = 2, EM_DIRECT = 3, EM_SPREAD = 4, EM_STRIDED = 5
};
// The owned build runs rows of OWNED_MIN_CHUNKS to WARPS chunks: with
// fewer, most of its warps idle and the direct build was faster
// (PERF.md section 6).  OWNED_STAGES: the most rows in flight.
constexpr int OWNED_MIN_CHUNKS = 5;
constexpr int OWNED_STAGES = 4;
// The spread build runs rows of 3 to SPREAD_MAX_CHUNKS chunks, each over
// a group of as many warps as it has chunks, as many rows at once as its
// CTA of SPREAD_WARPS warps holds groups: 24 warps an SM at two CTAs, as
// many as the one-chunk build's three CTAs hold, at 80 registers a thread
// (PERF.md section 6: eight warps with the next row loaded ahead, at 128
// registers, were slower in float64 at every width; sixteen spilled; the
// tile's rows staged by cp.async were slower in both types).
constexpr int SPREAD_MAX_CHUNKS = 4;
constexpr int SPREAD_WARPS = 12;
constexpr int SPREAD_THREADS = SPREAD_WARPS * 32;
static_assert(SPREAD_WARPS % 3 == 0 && SPREAD_WARPS % 4 == 0, "every warp in a group");
// The strided build takes rows of WARPS + 1 to STRIDED_MAX_CHUNKS chunks
// (4,097 to 8,192 columns) at two CTAs an SM of STRIDED_WARPS_F32 /
// STRIDED_WARPS_F64 warps, each holding STRIDED_MAX_CHUNKS / warps chunks;
// and float32 rows of STRIDED_WIDE_MIN_CHUNKS to twice
// STRIDED_MAX_CHUNKS chunks (9,217 to 16,384 columns) at one CTA an SM of
// STRIDED_WIDE_WARPS warps, whose partials (up to 128 KB) do not fit
// beside a second CTA (at 17 and 18 chunks, where one or two warps hold
// two chunks to the others' one, it lost to direct, and the walking
// layout takes them: PERF.md section 6).
// The walking layout: one CTA an SM that walks STRIDED_WALK row ranges in
// turn, so that K5 keeps two ranges an SM beside K6's one float64 CTA an
// SM (ops/em_kernels.py ranges): rows of STRIDED_WALK_MIN_CHUNKS_F64
// (float64: 9,217 to 12,288 columns) or STRIDED_WALK_MIN_CHUNKS_F32
// (float32: 8,193 to 9,216, below STRIDED_WIDE_MIN_CHUNKS) to
// STRIDED_WALK_WARPS chunks at STRIDED_WALK_WARPS warps of one chunk, and
// float64 rows of STRIDED_WALK_PAIR_MIN_CHUNKS to twice STRIDED_MAX_CHUNKS
// chunks (13,313 to 16,384 columns) at STRIDED_WIDE_WARPS warps of two
// (the float32 one-CTA layout; 32 warps of one chunk, at 64 registers a
// thread, were slower than direct).  Float64 rows of 17, 18, 25 and 26
// chunks stay direct: no layout measured was faster on both fresh and
// late-fit inputs there (PERF.md section 6).
constexpr int STRIDED_MAX_CHUNKS = 16;
constexpr int STRIDED_WARPS_F32 = 8;
constexpr int STRIDED_WARPS_F64 = 16;
constexpr int STRIDED_WIDE_MIN_CHUNKS = 19;
constexpr int STRIDED_WIDE_WARPS = 16;
constexpr int STRIDED_WALK_MIN_CHUNKS_F64 = 19;
constexpr int STRIDED_WALK_MIN_CHUNKS_F32 = 17;
constexpr int STRIDED_WALK_WARPS = 24;
constexpr int STRIDED_WALK_PAIR_MIN_CHUNKS = 27;
constexpr int STRIDED_WALK = 2;
// CTAs an SM of the strided build whose CTA holds `chunks` chunks of a row.
__host__ __device__ constexpr int strided_ctas(int chunks) {
  return chunks <= STRIDED_MAX_CHUNKS ? 2 : 1;
}

// ONE_CHUNK: G <= CHUNK, so the row functions are compiled for one chunk.
// A tile is `tile` rows of `slab` columns of weights in shared memory: the
// whole row for one chunk, a slab of whole chunks for the direct build.
template <typename LT, typename CT, bool ONE_CHUNK>
__global__ void __launch_bounds__(THREADS, EM_CTAS<ONE_CHUNK>)
em_step_kernel(const LT* __restrict__ logL, const LT* __restrict__ counts,
               const CT* __restrict__ lse_prev, const CT* __restrict__ logtheta,
               const bool* __restrict__ done, int64_t E, int64_t G, bool vec,
               int64_t tq, int64_t tr, int64_t n_ranges, int tile, int64_t slab,
               CT* __restrict__ lse_out, double* __restrict__ part_scalar,
               double* __restrict__ part_cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  CT* __restrict__ wt = reinterpret_cast<CT*>(smem);  // (tile, slab) weights
  __shared__ CT rowres[TILE_ROWS], rmax[TILE_ROWS], rcrow[TILE_ROWS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nch = ONE_CHUNK ? 1 : (int)((G + CHUNK - 1) / CHUNK);
  int64_t lo, hi;
  split_rows(blockIdx.x, E, tq, tr, lo, hi);
  double* __restrict__ cols = part_cols + (int64_t)blockIdx.x * G;
  for (int64_t g = threadIdx.x; g < G; g += THREADS) cols[g] = 0.0;
  if (done != nullptr && *done) {  // the same on every thread of the CTA
    for (int64_t e = lo + threadIdx.x; e < hi; e += THREADS) lse_out[e] = 0;
    if (threadIdx.x == 0) part_scalar[blockIdx.x] = 0.0;
    return;
  }
  __syncthreads();
  LT L[NPL];
  CT w[NPL];
  double acc = 0.0;  // read by thread 0 only
  // One chunk: a thread's columns (at most CHUNK / THREADS) of the CTA's
  // partials stay in registers across tiles, written out at the end.
  constexpr int NCOL = CHUNK / THREADS;
  double cacc[NCOL];
#pragma unroll
  for (int j = 0; j < NCOL; ++j) cacc[j] = 0.0;
  for (int64_t t0 = lo; t0 < hi; t0 += tile) {
    const int nr = (int)((hi - t0 < tile) ? hi - t0 : tile);
    // Phase A: lse, the ddot term and (max, cnt / denom) of each row, one
    // warp per row; for one chunk also the tile's weights.
    for (int r = warp; r < nr; r += WARPS) {
      const int64_t e = t0 + r;
      const LT* row = logL + e * G;
      const CT cnt = (CT)counts[e];
      CT m, den;
      load_row_chunk(row, 0, G, vec, lane, L);
      em_row_stats<LT, CT>(row, G, vec, nch, lane, logtheta, L, m, den, w);
      const CT crow = cnt / den, lse = m + clog(den);
      if (ONE_CHUNK) {
#pragma unroll
        for (int i = 0; i < NPL; ++i) w[i] = w[i] * crow;
        store_row_chunk(wt + (int64_t)r * G, 0, G, lane, w);
      }
      if (lane == 0) {
        lse_out[e] = lse;
        rowres[r] = cnt * (lse - lse_prev[e]);
        rmax[r] = m;
        rcrow[r] = crow;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int r = 0; r < nr; ++r) acc += (double)rowres[r];
    }
    if (ONE_CHUNK) {
      // Phase B: column partials of the tile's w, rows in order.
      for (int r = 0; r < nr; ++r) {
#pragma unroll
        for (int j = 0; j < NCOL; ++j) {
          const int64_t g = threadIdx.x + j * THREADS;
          if (g < G) cacc[j] += (double)wt[(int64_t)r * G + g];
        }
      }
      __syncthreads();
    } else {
      // A slab of columns at a time: the tile's w on the slab's chunks, one
      // warp per row, then phase B on the slab's columns, rows in order.
      for (int64_t s0 = 0; s0 < G; s0 += slab) {
        const int64_t sw = (G - s0 < slab) ? G - s0 : slab;
        for (int r = warp; r < nr; r += WARPS) {
          const LT* row = logL + (t0 + r) * G;
          for (int64_t c0 = s0; c0 < s0 + sw; c0 += CHUNK) {
            em_chunk_w<LT, CT>(row, c0, G, vec, lane, logtheta, rmax[r], rcrow[r], w);
            store_row_chunk(wt + (int64_t)r * slab, c0 - s0, sw, lane, w);
          }
        }
        __syncthreads();
        for (int64_t g = threadIdx.x; g < sw; g += THREADS) {
          double s = cols[s0 + g];
          for (int r = 0; r < nr; ++r) s += (double)wt[(int64_t)r * slab + g];
          cols[s0 + g] = s;
        }
        __syncthreads();
      }
    }
  }
  if (ONE_CHUNK) {
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      const int64_t g = threadIdx.x + j * THREADS;
      if (g < G) cols[g] = cacc[j];
    }
  }
  if (threadIdx.x == 0) part_scalar[blockIdx.x] = acc;
}

// The owned build's dynamic shared memory at G columns and `stages` rows
// in flight: logtheta (NC chunks, in the chunks' layout), three pairs of
// (WARPS,) chunk scalars (the chunk maxima, the exp sums at M_c and
// exp(M_{c-1} - M_c), by the parity of the row), then each warp's ring of
// `stages` copies of its chunk (ops/em_kernels.py owned_bytes mirrors it).
__host__ __device__ inline int64_t align16(int64_t bytes) { return (bytes + 15) / 16 * 16; }
__host__ __device__ inline int64_t owned_bytes(int64_t G, int64_t size, int stages) {
  const int64_t chunk_bytes = (G + CHUNK - 1) / CHUNK * CHUNK * size;
  return chunk_bytes + align16(6 * WARPS * size) + (int64_t)stages * chunk_bytes;
}
// Rows in flight of the owned build: as many as fit, at most OWNED_STAGES;
// 0 where G has fewer chunks than OWNED_MIN_CHUNKS or more than WARPS, or
// two rows do not fit.
inline int owned_stages(int64_t G, int64_t size, int64_t budget) {
  const int64_t nc = (G + CHUNK - 1) / CHUNK;
  if (nc < OWNED_MIN_CHUNKS || nc > WARPS) return 0;
  int s = OWNED_STAGES;
  while (s >= 2 && owned_bytes(G, size, s) > budget) --s;
  return s >= 2 ? s : 0;
}

// The lane's cells of a chunk in shared memory whose first n cells hold
// values (in load_row_chunk's slots, `fill` beyond n): 16-byte loads where
// n % 4 == 0, one cell a load otherwise.  A float64 lane reads its four
// cells of a 128-cell group as two 16-byte halves, lanes 4-7 of each eight
// the second half first, so that each load of eight lanes covers 128
// bytes once (no bank conflict).
template <typename T>
__device__ __forceinline__ void load_chunk_shared(const T* chunk, int64_t n, int lane, T fill,
                                                  T (&x)[NPL]) {
#pragma unroll
  for (int j = 0; j < NPL / 4; ++j) {
    const int64_t g = 128 * j + 4 * lane;
    if (n % 4 == 0) {
      if (g < n) {
        if constexpr (sizeof(T) == 4) {
          const float4 q = *reinterpret_cast<const float4*>(chunk + g);
          x[4 * j] = q.x; x[4 * j + 1] = q.y; x[4 * j + 2] = q.z; x[4 * j + 3] = q.w;
        } else {
          const int h = (lane >> 2) & 1;
          const double2 a = reinterpret_cast<const double2*>(chunk + g)[h];
          const double2 b = reinterpret_cast<const double2*>(chunk + g)[h ^ 1];
          x[4 * j] = h ? b.x : a.x; x[4 * j + 1] = h ? b.y : a.y;
          x[4 * j + 2] = h ? a.x : b.x; x[4 * j + 3] = h ? a.y : b.y;
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) x[4 * j + k] = fill;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) x[4 * j + k] = (g + k < n) ? chunk[g + k] : fill;
    }
  }
}

// All CHUNK of the lane's cells of a chunk in shared memory, in
// load_chunk_shared's order of float64 halves.
template <typename T>
__device__ __forceinline__ void store_chunk_shared(T* chunk, int lane, const T (&x)[NPL]) {
#pragma unroll
  for (int j = 0; j < NPL / 4; ++j) {
    T* p = chunk + 128 * j + 4 * lane;
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2],
                                                  x[4 * j + 3]);
    } else {
      const int h = (lane >> 2) & 1;
      const double2 lo = make_double2(x[4 * j], x[4 * j + 1]);
      const double2 hi = make_double2(x[4 * j + 2], x[4 * j + 3]);
      reinterpret_cast<double2*>(p)[h] = h ? hi : lo;
      reinterpret_cast<double2*>(p)[h ^ 1] = h ? lo : hi;
    }
  }
}

// Start copying the lane's cells of the chunk at c0 of a row (its slots,
// as load_row_chunk reads them) to the same offsets of dst in shared
// memory: 16 bytes a copy where vec, one cell a copy otherwise; cells at
// or beyond G are not copied.  Only the lane reads them back.
template <typename LT>
__device__ __forceinline__ void stage_lane_chunk(LT* dst, const LT* __restrict__ row, int64_t c0,
                                                 int64_t G, bool vec, int lane) {
#pragma unroll
  for (int j = 0; j < NPL / 4; ++j) {
    const int64_t o = 128 * j + 4 * lane, g = c0 + o;
    if (vec && g < G) {
#pragma unroll
      for (int k = 0; k < 4; k += 16 / (int)sizeof(LT)) cp_async<16>(dst + o + k, row + g + k);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (g + k < G) cp_async<(int)sizeof(LT)>(dst + o + k, row + g + k);
    }
  }
}

// The owned build (rows of OWNED_MIN_CHUNKS to WARPS chunks): the CTA
// takes its rows one at a time, warp c the row's chunk c in registers, so
// lane l keeps its 16 columns' partials in registers across the range,
// rows in order, and no weight leaves the registers.  Each lane copies its
// own cells of the next rows into its warp's ring (cp.async), so it waits
// on its own copies only.  Per row: t and the chunk's max, a barrier, the
// chunk's exps at M_c and their sum (and exp(t - m) where M_c < m), a
// barrier, the merge replayed by every warp, then w = exp(t - m) * crow
// into the partials.
template <typename LT, typename CT>
__global__ void __launch_bounds__(THREADS, EM_WIDE_CTAS)
em_step_owned_kernel(const LT* __restrict__ logL, const LT* __restrict__ counts,
                     const CT* __restrict__ lse_prev, const CT* __restrict__ logtheta,
                     const bool* __restrict__ done, int64_t E, int64_t G, bool vec,
                     int64_t tq, int64_t tr, int64_t n_ranges, int tile, int64_t slab,
                     CT* __restrict__ lse_out, double* __restrict__ part_scalar,
                     double* __restrict__ part_cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nc = (int)((G + CHUNK - 1) / CHUNK);
  const int64_t chunk_cells = (int64_t)nc * CHUNK;
  CT* lt_sh = reinterpret_cast<CT*>(smem);
  CT* sc = reinterpret_cast<CT*>(smem + chunk_cells * sizeof(CT));  // scalars
  LT* ring = reinterpret_cast<LT*>(smem + chunk_cells * sizeof(CT) +
                                   align16(6 * WARPS * sizeof(CT)));
  const int stages = tile;
  int64_t lo, hi;
  split_rows(blockIdx.x, E, tq, tr, lo, hi);
  double* __restrict__ cols = part_cols + (int64_t)blockIdx.x * G;
  if (done != nullptr && *done) {
    for (int64_t g = threadIdx.x; g < G; g += THREADS) cols[g] = 0.0;
    for (int64_t e = lo + threadIdx.x; e < hi; e += THREADS) lse_out[e] = 0;
    if (threadIdx.x == 0) part_scalar[blockIdx.x] = 0.0;
    return;
  }
  const bool own = warp < nc;  // warp c < NC owns chunk c
  const int64_t c0 = (int64_t)warp * CHUNK;
  LT* my_ring = ring + c0;  // stage s at my_ring + s * chunk_cells
  if (own) {
    CT lt[NPL];
    load_cols(logtheta, c0, G, lane, lt);
    store_chunk_shared(lt_sh + c0, lane, lt);
    for (int s = 0; s < stages - 1; ++s) {
      if (lo + s < hi) stage_lane_chunk(my_ring + s * chunk_cells, logL + (lo + s) * G, c0, G,
                                        vec, lane);
      cp_async_commit();
    }
  }
  double cacc[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) cacc[i] = 0.0;
  double acc = 0.0;  // thread 0's
  int par = 0;
  for (int64_t e = lo; e < hi; ++e, par ^= 1) {
    CT* cmax_sh = sc + par * WARPS;
    CT* csum_sh = sc + (2 + par) * WARPS;
    CT* step_sh = sc + (4 + par) * WARPS;
    const CT cnt = (CT)counts[e];
    const CT lp = threadIdx.x == 0 ? lse_prev[e] : (CT)0;
    CT x[NPL];
    if (own) {
      const int64_t nx = e + stages - 1;
      if (nx < hi)
        stage_lane_chunk(my_ring + (nx - lo) % stages * chunk_cells, logL + nx * G, c0, G, vec,
                         lane);
      cp_async_commit();
      // This row's copies: stages - 1 groups were committed after them.
      if (stages == 2) cp_async_wait<1>();
      else if (stages == 3) cp_async_wait<2>();
      else cp_async_wait<OWNED_STAGES - 1>();
      // Step 1: t and the chunk's max.
      const LT* cells = my_ring + (e - lo) % stages * chunk_cells;
      CT lt[NPL];
      load_chunk_shared(cells, G - c0, lane, neg_inf<LT>(), x);
      load_chunk_shared(lt_sh + c0, CHUNK, lane, (CT)0, lt);
#pragma unroll
      for (int i = 0; i < NPL; ++i) x[i] = x[i] + lt[i];
      CT cm = x[0];
#pragma unroll
      for (int i = 1; i < NPL; ++i) cm = cmax(cm, x[i]);
      cm = warp_max(cm);
      if (lane == 0) cmax_sh[warp] = cm;
    }
    __syncthreads();
    CT m = neg_inf<CT>();
    if (own) {
      // Step 2: the chunk's exps at M_c and their sum; exp(t - m) in x.
      CT Mc = 0, Mp = 0;
      for (int j = 0; j < nc; ++j) {
        if (j == warp) Mp = m;
        m = cmax(m, cmax_sh[j]);
        if (j == warp) Mc = m;
      }
      CT cs = 0;
      if (Mc == m) {
#pragma unroll
        for (int i = 0; i < NPL; ++i) x[i] = x[i] - Mc;
        row_exps(x);
#pragma unroll
        for (int i = 0; i < NPL; ++i) cs += x[i];
      } else {
#pragma unroll
        for (int i = 0; i < NPL; ++i) cs += em_exp(x[i] - Mc);
#pragma unroll
        for (int i = 0; i < NPL; ++i) x[i] = x[i] - m;
        row_exps(x);
      }
      cs = warp_sum(cs);
      if (lane == 0) {
        csum_sh[warp] = cs;
        step_sh[warp] = warp > 0 ? cexp(Mp - Mc) : (CT)0;
      }
    }
    __syncthreads();
    // Step 3: the merge in chunk order (the running max from the maxima).
    CT mp = neg_inf<CT>(), den = 0;
    for (int j = 0; j < nc; ++j) {
      den = (mp == neg_inf<CT>()) ? csum_sh[j] : den * step_sh[j] + csum_sh[j];
      mp = cmax(mp, cmax_sh[j]);
    }
    const CT crow = cnt / den;
    if (threadIdx.x == 0) {
      const CT lse = mp + clog(den);
      lse_out[e] = lse;
      acc += (double)(cnt * (lse - lp));
    }
    // Step 4: the weights into the lane's columns.
    if (own) {
#pragma unroll
      for (int i = 0; i < NPL; ++i) cacc[i] += (double)(x[i] * crow);
    }
  }
  if (own) {
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int64_t g = slot_col(c0, i, lane);
      if (g < G) cols[g] = cacc[i];
    }
  }
  if (threadIdx.x == 0) part_scalar[blockIdx.x] = acc;
}

// The pair build (CHUNK < G <= 2 CHUNK): the one-chunk build's layout with
// the row's two chunks in registers, 32 cells a lane, a warp a row, and a
// tile of weights in shared memory for phase B.
template <typename LT, typename CT>
__global__ void __launch_bounds__(THREADS, EM_WIDE_CTAS)
em_step_pair_kernel(const LT* __restrict__ logL, const LT* __restrict__ counts,
                    const CT* __restrict__ lse_prev, const CT* __restrict__ logtheta,
                    const bool* __restrict__ done, int64_t E, int64_t G, bool vec,
                    int64_t tq, int64_t tr, int64_t n_ranges, int tile, int64_t slab,
                    CT* __restrict__ lse_out, double* __restrict__ part_scalar,
                    double* __restrict__ part_cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  CT* __restrict__ wt = reinterpret_cast<CT*>(smem);  // (tile, G) weights
  __shared__ CT rowres[TILE_ROWS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int64_t lo, hi;
  split_rows(blockIdx.x, E, tq, tr, lo, hi);
  double* __restrict__ cols = part_cols + (int64_t)blockIdx.x * G;
  if (done != nullptr && *done) {
    for (int64_t g = threadIdx.x; g < G; g += THREADS) cols[g] = 0.0;
    for (int64_t e = lo + threadIdx.x; e < hi; e += THREADS) lse_out[e] = 0;
    if (threadIdx.x == 0) part_scalar[blockIdx.x] = 0.0;
    return;
  }
  double acc = 0.0;  // read by thread 0 only
  constexpr int NCOL = 2 * CHUNK / THREADS;
  double cacc[NCOL];
#pragma unroll
  for (int j = 0; j < NCOL; ++j) cacc[j] = 0.0;
  for (int64_t t0 = lo; t0 < hi; t0 += tile) {
    const int nr = (int)((hi - t0 < tile) ? hi - t0 : tile);
    for (int r = warp; r < nr; r += WARPS) {
      const int64_t e = t0 + r;
      const LT* row = logL + e * G;
      const CT cnt = (CT)counts[e];
      CT x0[NPL], x1[NPL];
      {
        LT L0[NPL], L1[NPL];
        CT lt[NPL];
        load_row_chunk(row, 0, G, vec, lane, L0);
        load_row_chunk(row, CHUNK, G, vec, lane, L1);
        load_cols(logtheta, 0, G, lane, lt);
#pragma unroll
        for (int i = 0; i < NPL; ++i) x0[i] = (CT)L0[i] + lt[i];
        load_cols(logtheta, CHUNK, G, lane, lt);
#pragma unroll
        for (int i = 0; i < NPL; ++i) x1[i] = (CT)L1[i] + lt[i];
      }
      CT mx[2] = {x0[0], x1[0]};
#pragma unroll
      for (int i = 1; i < NPL; ++i) {
        mx[0] = cmax(mx[0], x0[i]);
        mx[1] = cmax(mx[1], x1[i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const CT a = __shfl_xor_sync(0xffffffffu, mx[0], o);
        const CT b = __shfl_xor_sync(0xffffffffu, mx[1], o);
        mx[0] = cmax(mx[0], a);
        mx[1] = cmax(mx[1], b);
      }
      const CT M0 = cmax(neg_inf<CT>(), mx[0]), m = cmax(M0, mx[1]);
      CT cs[2] = {0, 0};
      if (M0 == m) {
#pragma unroll
        for (int i = 0; i < NPL; ++i) x0[i] = x0[i] - M0;
        row_exps(x0);
#pragma unroll
        for (int i = 0; i < NPL; ++i) cs[0] += x0[i];
      } else {  // chunk 0's sum at M0, its weights' exps at m
#pragma unroll
        for (int i = 0; i < NPL; ++i) cs[0] += em_exp(x0[i] - M0);
#pragma unroll
        for (int i = 0; i < NPL; ++i) x0[i] = x0[i] - m;
        row_exps(x0);
      }
#pragma unroll
      for (int i = 0; i < NPL; ++i) x1[i] = x1[i] - m;
      row_exps(x1);
#pragma unroll
      for (int i = 0; i < NPL; ++i) cs[1] += x1[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const CT a = __shfl_xor_sync(0xffffffffu, cs[0], o);
        const CT b = __shfl_xor_sync(0xffffffffu, cs[1], o);
        cs[0] += a;
        cs[1] += b;
      }
      const CT den = (M0 == neg_inf<CT>()) ? cs[1] : cs[0] * cexp(M0 - m) + cs[1];
      const CT crow = cnt / den, lse = m + clog(den);
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        x0[i] = x0[i] * crow;
        x1[i] = x1[i] * crow;
      }
      store_row_chunk(wt + (int64_t)r * G, 0, G, lane, x0);
      store_row_chunk(wt + (int64_t)r * G, CHUNK, G, lane, x1);
      if (lane == 0) {
        lse_out[e] = lse;
        rowres[r] = cnt * (lse - lse_prev[e]);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int r = 0; r < nr; ++r) acc += (double)rowres[r];
    }
    for (int r = 0; r < nr; ++r) {
#pragma unroll
      for (int j = 0; j < NCOL; ++j) {
        const int64_t g = threadIdx.x + j * THREADS;
        if (g < G) cacc[j] += (double)wt[(int64_t)r * G + g];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < NCOL; ++j) {
    const int64_t g = threadIdx.x + j * THREADS;
    if (g < G) cols[g] = cacc[j];
  }
  if (threadIdx.x == 0) part_scalar[blockIdx.x] = acc;
}

// The spread build's dynamic shared memory at G columns and `tile` rows:
// logtheta (NC chunks, in the chunks' layout), the tile of exps, whose
// rows are spread_stride(G) cells apart (16-byte aligned), then the
// tile's row scalars: the chunk maxima, the exp sums at M_c and exp(M_{c-1}
// - M_c) (SPREAD_MAX_CHUNKS each), cnt / den and the ddot term
// (ops/em_kernels.py spread_bytes mirrors it).
constexpr int SPREAD_ROW_SCALARS = 3 * SPREAD_MAX_CHUNKS + 2;
__host__ __device__ inline int64_t spread_stride(int64_t G) { return (G + 3) / 4 * 4; }
__host__ __device__ inline int64_t spread_bytes(int64_t G, int64_t size, int tile) {
  return ((G + CHUNK - 1) / CHUNK * CHUNK + (int64_t)tile * (spread_stride(G) + SPREAD_ROW_SCALARS)) *
         size;
}
// Rows of the spread build's tile: as many as fit in `budget`, at most
// TILE_ROWS, a multiple of the groups (so a group's rows are every
// groups-th of its range); 0 where one row a group does not fit.
inline int spread_tile(int64_t G, int64_t size, int64_t budget) {
  const int groups = SPREAD_WARPS / (int)((G + CHUNK - 1) / CHUNK);
  const int64_t r = (budget - spread_bytes(G, size, 0)) / (spread_bytes(G, size, 1) -
                                                          spread_bytes(G, size, 0));
  const int t = r < TILE_ROWS ? (int)r : TILE_ROWS;
  return t >= groups ? t - t % groups : 0;
}

// bar.sync on barrier `id` (1 to 15; 0 is __syncthreads's) for the
// `threads` threads (whole warps) that name it.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// f(i) for the lane's slots i of a chunk whose first `groups` 128-column
// groups hold a column below G (uniform across the warp): all 16 slots
// in one unrolled run where the chunk is whole, only the live groups of a
// ragged last chunk, whose other cells are -inf and are never used.
template <typename F>
__device__ __forceinline__ void live_slots(int groups, F f) {
  if (groups >= NPL / 4) {
#pragma unroll
    for (int i = 0; i < NPL; ++i) f(i);
  } else {
#pragma unroll
    for (int j = 0; j < NPL / 4; ++j)
      if (j < groups) {
#pragma unroll
        for (int k = 0; k < 4; ++k) f(4 * j + k);
      }
  }
}

// The spread build (rows of 3 to SPREAD_MAX_CHUNKS chunks): group q of
// the CTA's NG = warps / NC groups of NC warps takes rows lo + q, lo + q +
// NG, ... of the range, warp c of the group the row's chunk c in
// registers.  Per row, one barrier of the group's warps: t and the
// chunk's max, the barrier, then the chunk's exps at M_c and their sum
// (and exp(t - m) where M_c < m) and exp(t - m) into the tile.  Per tile,
// one thread a row replays the merge in chunk order (lse, cnt / den, the
// ddot term), then phase B, one thread a column, adds the tile's weights
// exp(t - m) * cnt / den in row order into the column partials it keeps
// in registers across the range, written once at the end.
template <typename LT, typename CT>
__global__ void __launch_bounds__(SPREAD_THREADS, EM_WIDE_CTAS)
em_step_spread_kernel(const LT* __restrict__ logL, const LT* __restrict__ counts,
                      const CT* __restrict__ lse_prev, const CT* __restrict__ logtheta,
                      const bool* __restrict__ done, int64_t E, int64_t G, bool vec,
                      int64_t tq, int64_t tr, int64_t n_ranges, int tile, int64_t slab,
                      CT* __restrict__ lse_out, double* __restrict__ part_scalar,
                      double* __restrict__ part_cols) {
  constexpr int NT = SPREAD_THREADS, MC = SPREAD_MAX_CHUNKS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nc = (int)((G + CHUNK - 1) / CHUNK), ng = SPREAD_WARPS / nc;
  const int64_t stride = spread_stride(G);
  CT* lt_sh = reinterpret_cast<CT*>(smem);
  CT* wt = lt_sh + (int64_t)nc * CHUNK;  // (tile, stride) exps
  CT* cmax_sh = wt + (int64_t)tile * stride;  // (tile, MC) each
  CT* csum_sh = cmax_sh + tile * MC;
  CT* step_sh = csum_sh + tile * MC;
  CT* crow_sh = step_sh + tile * MC;  // (tile,) each
  CT* rowres = crow_sh + tile;
  int64_t lo, hi;
  split_rows(blockIdx.x, E, tq, tr, lo, hi);
  double* __restrict__ cols = part_cols + (int64_t)blockIdx.x * G;
  if (done != nullptr && *done) {
    for (int64_t g = threadIdx.x; g < G; g += NT) cols[g] = 0.0;
    for (int64_t e = lo + threadIdx.x; e < hi; e += NT) lse_out[e] = 0;
    if (threadIdx.x == 0) part_scalar[blockIdx.x] = 0.0;
    return;
  }
  const int grp = warp / nc, c = warp - grp * nc;
  const int64_t c0 = (int64_t)c * CHUNK;
  const int groups = (int)((G - c0 + 127) / 128);  // live 128-column groups of the chunk
  const int bar_id = 1 + grp, bar_threads = nc * 32;
  if (grp == 0) {
    CT lt[NPL];
    load_cols(logtheta, c0, G, lane, lt);
    store_chunk_shared(lt_sh + c0, lane, lt);
  }
  __syncthreads();
  constexpr int NCOL = (MC * CHUNK + NT - 1) / NT;
  double cacc[NCOL];
#pragma unroll
  for (int j = 0; j < NCOL; ++j) cacc[j] = 0.0;
  double acc = 0.0;  // thread 0's
  for (int64_t t0 = lo; t0 < hi; t0 += tile) {
    const int nr = (int)((hi - t0 < tile) ? hi - t0 : tile);
    for (int r = grp; r < nr; r += ng) {
      const int64_t e = t0 + r;
      // t and the chunk's max.
      CT x[NPL];
      {
        LT L[NPL];
        CT lt[NPL];
        load_row_chunk(logL + e * G, c0, G, vec, lane, L);
        load_chunk_shared(lt_sh + c0, CHUNK, lane, (CT)0, lt);
#pragma unroll
        for (int i = 0; i < NPL; ++i) x[i] = (CT)L[i] + lt[i];
      }
      CT cm = x[0];
#pragma unroll
      for (int i = 1; i < NPL; ++i) cm = cmax(cm, x[i]);
      cm = warp_max(cm);
      if (lane == 0) cmax_sh[r * MC + c] = cm;
      bar_sync(bar_id, bar_threads);
      // The chunk's exps at M_c and their sum; exp(t - m) into the tile.
      CT m = neg_inf<CT>(), Mc = 0, Mp = 0;
      for (int j = 0; j < nc; ++j) {
        if (j == c) Mp = m;
        m = cmax(m, cmax_sh[r * MC + j]);
        if (j == c) Mc = m;
      }
      CT cs = 0;
      if (Mc == m) {
        live_slots(groups, [&](int i) { x[i] = em_exp(x[i] - Mc); });
        live_slots(groups, [&](int i) { cs += x[i]; });
      } else {
        live_slots(groups, [&](int i) { cs += em_exp(x[i] - Mc); });
        live_slots(groups, [&](int i) { x[i] = em_exp(x[i] - m); });
      }
      cs = warp_sum(cs);
      if (lane == 0) {
        csum_sh[r * MC + c] = cs;
        step_sh[r * MC + c] = c > 0 ? cexp(Mp - Mc) : (CT)0;
      }
      // Whole 4-cell groups: a tile row holds `stride` cells, the cells
      // beyond G (exp(-inf) = 0) land in its padding.
      store_row_chunk(wt + (int64_t)r * stride, c0, stride, lane, x);
    }
    __syncthreads();
    // The merge in chunk order, one thread a row: lse, cnt / den, the ddot term.
    if (threadIdx.x < nr) {
      const int r = threadIdx.x;
      const int64_t e = t0 + r;
      CT mp = neg_inf<CT>(), den = 0;
      for (int j = 0; j < nc; ++j) {
        den = (mp == neg_inf<CT>()) ? csum_sh[r * MC + j]
                                    : den * step_sh[r * MC + j] + csum_sh[r * MC + j];
        mp = cmax(mp, cmax_sh[r * MC + j]);
      }
      const CT cnt = (CT)counts[e], lse = mp + clog(den);
      crow_sh[r] = cnt / den;
      lse_out[e] = lse;
      rowres[r] = cnt * (lse - lse_prev[e]);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int r = 0; r < nr; ++r) acc += (double)rowres[r];
    }
    // Phase B: the tile's weights into the thread's columns, rows in order.
    for (int r = 0; r < nr; ++r) {
      const CT* w = wt + (int64_t)r * stride;
      const CT crow = crow_sh[r];
#pragma unroll
      for (int j = 0; j < NCOL; ++j) {
        const int64_t g = threadIdx.x + j * NT;
        if (g < G) cacc[j] += (double)(w[g] * crow);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < NCOL; ++j) {
    const int64_t g = threadIdx.x + j * NT;
    if (g < G) cols[g] = cacc[j];
  }
  if (threadIdx.x == 0) part_scalar[blockIdx.x] = acc;
}

// The strided build's dynamic shared memory at G columns: the CTA's
// float64 column partials, chunk c's at c CHUNK, the lane's slot i at i 32
// + lane (a warp's read-modify-write of one slot covers 256 consecutive
// bytes, no bank conflict), then three pairs of (NC,) chunk scalars (the
// chunk maxima, the exp sums at M_c and exp(M_{c-1} - M_c)) by the parity
// of the row (ops/em_kernels.py strided_bytes mirrors it).
__host__ __device__ inline int64_t strided_bytes(int64_t G, int64_t size) {
  const int64_t nc = (G + CHUNK - 1) / CHUNK;
  return nc * CHUNK * (int64_t)sizeof(double) + align16(6 * nc * size);
}

// load_row_chunk with loads cached in L2 only (ld.global.cg), so that the
// row does not evict logtheta from L1.
__device__ __forceinline__ void load4_l2(const float* p, float* out) {
  const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
  out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
}
__device__ __forceinline__ void load4_l2(const double* p, double* out) {
  const double2 a = __ldcg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldcg(reinterpret_cast<const double2*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
template <typename LT>
__device__ __forceinline__ void load_row_chunk_l2(const LT* __restrict__ row, int64_t c0,
                                                  int64_t G, bool vec, int lane, LT (&L)[NPL]) {
#pragma unroll
  for (int j = 0; j < NPL / 4; ++j) {
    const int64_t g = c0 + 128 * j + 4 * lane;
    if (vec && g < G) {
      load4_l2(row + g, &L[4 * j]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) L[4 * j + k] = (g + k < G) ? __ldcg(row + g + k) : neg_inf<LT>();
    }
  }
}

// load_cols in 16-byte loads where vec (G % 4 == 0 and x 16-byte aligned).
template <typename CT>
__device__ __forceinline__ void load_cols_vec(const CT* __restrict__ x, int64_t c0, int64_t G,
                                              bool vec, int lane, CT (&out)[NPL]) {
  if (!vec) {
    load_cols(x, c0, G, lane, out);
    return;
  }
#pragma unroll
  for (int j = 0; j < NPL / 4; ++j) {
    const int64_t g = c0 + 128 * j + 4 * lane;
    if (g < G) {
      load4(x + g, &out[4 * j]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) out[4 * j + k] = 0;
    }
  }
}

// Ask L2 for the `bytes` at p, one 128-byte line a thread at a time over
// the `threads` threads of the CTA; nothing waits for it.
__device__ __forceinline__ void prefetch_l2(const void* p, int64_t bytes, int threads) {
  const char* b = static_cast<const char*>(p);
  const char* line = b - ((uintptr_t)b & 127);
  for (const char* q = line + (int64_t)threadIdx.x * 128; q < b + bytes;
       q += (int64_t)threads * 128)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(q));
}

// The strided build (rows of more chunks than warps): the CTA takes its
// rows one at a time, warp w of NW the row's chunks w + k NW (k < K) in
// registers, lane l its 16 cells of each, so every cell of the row is
// read once, through L2 (in float32 prefetched there while the CTA worked
// on the row before).  Per row: t and each chunk's max, a barrier, every warp
// takes the running maxima from the chunk maxima, then each chunk's exps
// at M_c and their sum (and exp(t - m) where M_c < m) and exp(M_{c-1} -
// M_c), a barrier, the merge in chunk order replayed by every warp, and w
// = exp(t - m) * cnt / den added into the lane's own float64 partials in
// shared memory, rows in order.  CTA b walks the R row ranges b R to b R +
// R - 1 of the n_ranges in turn (the last CTA those that are left): for
// each, its partials start at zero and are written to that range's slot
// at its end, so each range's sums are those of a CTA of its own.  The
// walking layout (K = 1 at one CTA an SM) reads logtheta from shared
// memory, the chunks of as many warps as the rest of it holds (all on an
// H100), each lane its own cells, copied once.
template <typename LT, typename CT, int NW, int K, int R>
__global__ void __launch_bounds__(NW * 32, strided_ctas(NW * K))
em_step_strided_kernel(const LT* __restrict__ logL, const LT* __restrict__ counts,
                       const CT* __restrict__ lse_prev, const CT* __restrict__ logtheta,
                       const bool* __restrict__ done, int64_t E, int64_t G, bool vec,
                       int64_t tq, int64_t tr, int64_t n_ranges, int tile, int64_t slab,
                       CT* __restrict__ lse_out, double* __restrict__ part_scalar,
                       double* __restrict__ part_cols) {
  static_assert(sizeof(LT) == sizeof(CT), "the row is loaded in the compute type");
  constexpr int NT = NW * 32;
  // The next row is prefetched into L2 in float32 only: it gained 1-2%
  // there and lost 2-6% in float64 (PERF.md section 6).
  constexpr bool prefetch = sizeof(CT) == 4;
  // The walking layout (one CTA an SM, a chunk a warp), whose partials
  // leave L1 too little room for logtheta, keeps the chunks of logtheta of
  // its first `held` warps in shared memory, each lane its own cells.
  constexpr bool hold = K == 1 && strided_ctas(NW * K) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nc = (int)((G + CHUNK - 1) / CHUNK);
  double* part = reinterpret_cast<double*>(smem);
  CT* sc = reinterpret_cast<CT*>(smem + (int64_t)nc * CHUNK * sizeof(double));  // scalars
  const int64_t fixed = strided_bytes(G, (int64_t)sizeof(CT));
  CT* lt_slot = reinterpret_cast<CT*>(smem + fixed) + (int64_t)warp * CHUNK;
  int held = 0;  // the rest of the dynamic shared memory, in chunks of logtheta
  if (hold) {
    unsigned dyn;
    asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
    held = (int)(((int64_t)dyn - fixed) / (CHUNK * (int64_t)sizeof(CT)));
  }
  const int64_t b0 = (int64_t)blockIdx.x * R;
  const int nb = (int)(n_ranges - b0 < R ? n_ranges - b0 : R);  // this CTA's ranges
  if (done != nullptr && *done) {
    for (int q = 0; q < nb; ++q) {
      int64_t lo, hi;
      split_rows(b0 + q, E, tq, tr, lo, hi);
      double* __restrict__ cols = part_cols + (b0 + q) * G;
      for (int64_t g = threadIdx.x; g < G; g += NT) cols[g] = 0.0;
      for (int64_t e = lo + threadIdx.x; e < hi; e += NT) lse_out[e] = 0;
      if (threadIdx.x == 0) part_scalar[b0 + q] = 0.0;
    }
    return;
  }
  const bool lt_vec = G % 4 == 0 && ((uintptr_t)logtheta % 16) == 0;
  int ch[K];  // the warp's chunks (none in slot k where ch[k] >= nc)
  bool live[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    ch[k] = warp + k * NW;
    live[k] = ch[k] < nc;
  }
  const bool lt_held = hold && live[0] && warp < held;
  if (lt_held) {
    CT lt[NPL];
    load_cols_vec(logtheta, (int64_t)warp * CHUNK, G, lt_vec, lane, lt);
    store_chunk_shared(lt_slot, lane, lt);
  }
  int par = 0;  // runs on across ranges: the scalars' buffer of the row
  for (int q = 0; q < nb; ++q) {
    const int64_t b = b0 + q;
    int64_t lo, hi;
    split_rows(b, E, tq, tr, lo, hi);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (live[k]) {
#pragma unroll
        for (int i = 0; i < NPL; ++i) part[ch[k] * CHUNK + i * 32 + lane] = 0.0;
      }
    double acc = 0.0;  // thread 0's
    for (int64_t e = lo; e < hi; ++e, par ^= 1) {
      CT* cmax_sh = sc + par * nc;
      CT* csum_sh = sc + (2 + par) * nc;
      CT* step_sh = sc + (4 + par) * nc;
      const LT* row = logL + e * G;
      if (prefetch && e + 1 < hi) prefetch_l2(row + G, G * (int64_t)sizeof(LT), NT);
      const CT cnt = (CT)counts[e];
      const CT lp = threadIdx.x == 0 ? lse_prev[e] : (CT)0;
      // t and each chunk's max.
      CT x[K][NPL], cm[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (live[k]) load_row_chunk_l2(row, (int64_t)ch[k] * CHUNK, G, vec, lane, x[k]);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        cm[k] = neg_inf<CT>();
        if (live[k]) {
          CT lt[NPL];
          if (lt_held) load_chunk_shared(lt_slot, CHUNK, lane, (CT)0, lt);
          else load_cols_vec(logtheta, (int64_t)ch[k] * CHUNK, G, lt_vec, lane, lt);
#pragma unroll
          for (int i = 0; i < NPL; ++i) x[k][i] = x[k][i] + lt[i];
          cm[k] = x[k][0];
#pragma unroll
          for (int i = 1; i < NPL; ++i) cm[k] = cmax(cm[k], x[k][i]);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int k = 0; k < K; ++k) cm[k] = cmax(cm[k], __shfl_xor_sync(0xffffffffu, cm[k], o));
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (live[k]) cmax_sh[ch[k]] = cm[k];
      }
      __syncthreads();
      // The running maxima M_{c-1}, M_c of the warp's chunks and the row's m.
      CT m = neg_inf<CT>(), Mp[K], Mc[K];
#pragma unroll
      for (int k = 0; k < K; ++k) Mp[k] = Mc[k] = 0;
      for (int j = 0; j < nc; ++j) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (j == ch[k]) Mp[k] = m;
        m = cmax(m, cmax_sh[j]);
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (j == ch[k]) Mc[k] = m;
      }
      // Each chunk's exps at M_c and their sum; exp(t - m) in x.
      CT cs[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        cs[k] = 0;
        if (!live[k]) continue;
        if (Mc[k] == m) {
#pragma unroll
          for (int i = 0; i < NPL; ++i) x[k][i] = x[k][i] - Mc[k];
          row_exps(x[k]);
#pragma unroll
          for (int i = 0; i < NPL; ++i) cs[k] += x[k][i];
        } else {
#pragma unroll
          for (int i = 0; i < NPL; ++i) cs[k] += em_exp(x[k][i] - Mc[k]);
#pragma unroll
          for (int i = 0; i < NPL; ++i) x[k][i] = x[k][i] - m;
          row_exps(x[k]);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int k = 0; k < K; ++k) cs[k] += __shfl_xor_sync(0xffffffffu, cs[k], o);
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (live[k]) {
            csum_sh[ch[k]] = cs[k];
            step_sh[ch[k]] = ch[k] > 0 ? cexp(Mp[k] - Mc[k]) : (CT)0;
          }
      }
      __syncthreads();
      // The merge in chunk order (the running max from the maxima).
      CT mp = neg_inf<CT>(), den = 0;
      for (int j = 0; j < nc; ++j) {
        den = (mp == neg_inf<CT>()) ? csum_sh[j] : den * step_sh[j] + csum_sh[j];
        mp = cmax(mp, cmax_sh[j]);
      }
      const CT crow = cnt / den;
      if (threadIdx.x == 0) {
        const CT lse = mp + clog(den);
        lse_out[e] = lse;
        acc += (double)(cnt * (lse - lp));
      }
      // The weights into the lane's partials.
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (live[k]) {
#pragma unroll
          for (int i = 0; i < NPL; ++i)
            part[ch[k] * CHUNK + i * 32 + lane] += (double)(x[k][i] * crow);
        }
    }
    double* __restrict__ cols = part_cols + b * G;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (live[k]) {
#pragma unroll
        for (int i = 0; i < NPL; ++i) {
          const int64_t g = slot_col((int64_t)ch[k] * CHUNK, i, lane);
          if (g < G) cols[g] = part[ch[k] * CHUNK + i * 32 + lane];
        }
      }
    if (threadIdx.x == 0) part_scalar[b] = acc;
  }
}

// What G columns run: the build (EmBuild), its kernel, its tile (rows of
// weights, or the owned build's rows in flight), its columns (the direct
// build's slab, else G), the dynamic shared memory, each tile sized to
// the kernel's shared-memory budget (read from the runtime once per
// device), and the row ranges a CTA walks.
struct EmPlan {
  int build = EM_ONE_CHUNK;
  const void* kernel = nullptr;
  int threads = THREADS;
  int tile = 0;
  int64_t slab = 0;
  size_t smem = 0;
  int ranges = 1;
};

// The one-chunk and direct builds.  The direct build's slab is the row's
// chunks, at most as many as WARPS rows of weights fit in the budget.
template <typename LT, typename CT, bool ONE_CHUNK>
static cudaError_t em_plan_one(int64_t G, EmPlan& p) {
  static WtileBudget cache;
  int64_t budget = 0;
  p.build = ONE_CHUNK ? EM_ONE_CHUNK : EM_DIRECT;
  p.kernel = (const void*)em_step_kernel<LT, CT, ONE_CHUNK>;
  cudaError_t err = wtile_budget(p.kernel, EM_CTAS<ONE_CHUNK>, cache, budget);
  if (ONE_CHUNK) {
    p.slab = G > 0 ? G : 1;
  } else {
    const int64_t nch = (G + CHUNK - 1) / CHUNK;
    const int64_t fit = budget / ((int64_t)WARPS * CHUNK * (int64_t)sizeof(CT));
    p.slab = (nch < fit ? nch : fit) * CHUNK;
  }
  const int64_t row_bytes = p.slab * (int64_t)sizeof(CT);
  p.tile = row_bytes > 0 ? wtile_rows(budget, row_bytes) : 0;
  p.smem = (size_t)p.tile * row_bytes;
  // No tile of weights fits (not so on an H100).
  if (err == cudaSuccess && p.tile == 0) err = cudaErrorInvalidConfiguration;
  return err;
}

// The strided build at NW warps of K chunks each, each CTA walking R row
// ranges, where its partials fit in the budget of its CTAs an SM (not so:
// direct).  At two CTAs an SM it asks for more than a third of the SM's
// shared memory (two thirds of that budget), so that no third CTA fits:
// K5's CTAs an SM and ranges a CTA set the row ranges it shares with K6
// (ops/em_kernels.py ranges).
template <typename LT, typename CT, int NW, int K, int R = 1>
static cudaError_t em_plan_strided(int64_t G, EmPlan& p) {
  static WtileBudget cache;
  int64_t budget = 0;
  const void* kernel = (const void*)em_step_strided_kernel<LT, CT, NW, K, R>;
  const cudaError_t err = wtile_budget(kernel, strided_ctas(NW * K), cache, budget);
  if (err != cudaSuccess) return err;
  const int64_t need = strided_bytes(G, (int64_t)sizeof(CT));
  if (need > budget) return em_plan_one<LT, CT, false>(G, p);
  p.build = EM_STRIDED;
  p.kernel = kernel;
  p.threads = NW * 32;
  p.tile = 1;
  p.slab = G;
  p.ranges = R;
  const int64_t least = strided_ctas(NW * K) == 2 ? budget * 2 / 3 + 16 : 0;
  p.smem = (size_t)(need > least ? need : least);
  if (K == 1 && strided_ctas(NW * K) == 1) {  // the walking layout's chunks of logtheta
    const int64_t chunk = CHUNK * (int64_t)sizeof(CT), nc = (G + CHUNK - 1) / CHUNK;
    const int64_t fit = (budget - need) / chunk;
    p.smem = (size_t)(need + (fit < nc ? fit : nc) * chunk);
  }
  return cudaSuccess;
}

// G <= CHUNK: one chunk; else the pair build (G <= 2 CHUNK), else the
// spread build (G <= SPREAD_MAX_CHUNKS CHUNK), else the owned build where
// it takes G and two rows fit, else the strided build (rows of more
// chunks than warps, at most STRIDED_MAX_CHUNKS, or in float32
// STRIDED_WIDE_MIN_CHUNKS to twice that, or the walking layout's rows),
// else direct.
template <typename LT, typename CT>
static cudaError_t em_plan(int64_t G, EmPlan& p) {
  if (G <= CHUNK) return em_plan_one<LT, CT, true>(G, p);
  const int64_t nc = (G + CHUNK - 1) / CHUNK;
  if (nc > WARPS) {
    constexpr int NW = sizeof(CT) == 4 ? STRIDED_WARPS_F32 : STRIDED_WARPS_F64;
    if (nc <= STRIDED_MAX_CHUNKS)
      return em_plan_strided<LT, CT, NW, STRIDED_MAX_CHUNKS / NW>(G, p);
    if constexpr (sizeof(CT) == 4) {
      if (nc >= STRIDED_WIDE_MIN_CHUNKS && nc <= 2 * STRIDED_MAX_CHUNKS)
        return em_plan_strided<LT, CT, STRIDED_WIDE_WARPS,
                               2 * STRIDED_MAX_CHUNKS / STRIDED_WIDE_WARPS>(G, p);
    }
    constexpr int walk_min =
        sizeof(CT) == 4 ? STRIDED_WALK_MIN_CHUNKS_F32 : STRIDED_WALK_MIN_CHUNKS_F64;
    if (nc >= walk_min && nc <= STRIDED_WALK_WARPS)
      return em_plan_strided<LT, CT, STRIDED_WALK_WARPS, 1, STRIDED_WALK>(G, p);
    if constexpr (sizeof(CT) == 8) {
      if (nc >= STRIDED_WALK_PAIR_MIN_CHUNKS && nc <= 2 * STRIDED_MAX_CHUNKS)
        return em_plan_strided<LT, CT, STRIDED_WIDE_WARPS,
                               2 * STRIDED_MAX_CHUNKS / STRIDED_WIDE_WARPS, STRIDED_WALK>(G, p);
    }
    return em_plan_one<LT, CT, false>(G, p);
  }
  int64_t budget = 0;
  cudaError_t err = cudaSuccess;
  if (G <= 2 * CHUNK) {
    static WtileBudget pair_cache;
    p.build = EM_PAIR;
    p.kernel = (const void*)em_step_pair_kernel<LT, CT>;
    err = wtile_budget(p.kernel, EM_WIDE_CTAS, pair_cache, budget);
    p.slab = G;
    p.tile = wtile_rows(budget, G * (int64_t)sizeof(CT));
    p.smem = (size_t)p.tile * G * sizeof(CT);
    if (err == cudaSuccess && p.tile == 0) err = cudaErrorInvalidConfiguration;
    return err;
  }
  if (G <= SPREAD_MAX_CHUNKS * CHUNK) {
    static WtileBudget spread_cache;
    p.build = EM_SPREAD;
    p.kernel = (const void*)em_step_spread_kernel<LT, CT>;
    p.threads = SPREAD_THREADS;
    err = wtile_budget(p.kernel, EM_WIDE_CTAS, spread_cache, budget);
    p.slab = G;
    p.tile = spread_tile(G, (int64_t)sizeof(CT), budget);
    p.smem = (size_t)spread_bytes(G, (int64_t)sizeof(CT), p.tile);
    if (err == cudaSuccess && p.tile == 0) err = cudaErrorInvalidConfiguration;
    return err;
  }
  static WtileBudget owned_cache;
  const void* owned = (const void*)em_step_owned_kernel<LT, CT>;
  err = wtile_budget(owned, EM_WIDE_CTAS, owned_cache, budget);
  if (err != cudaSuccess) return err;
  const int stages = owned_stages(G, (int64_t)sizeof(CT), budget);
  if (stages == 0) return em_plan_one<LT, CT, false>(G, p);
  p.build = EM_OWNED;
  p.kernel = owned;
  p.tile = stages;
  p.slab = G;
  p.smem = (size_t)owned_bytes(G, (int64_t)sizeof(CT), stages);
  return cudaSuccess;
}

template <typename LT, typename CT>
static int launch_em_step(const void* logL, const void* counts, const void* lse_prev,
                          const void* logtheta, const void* done, int64_t E, int64_t G,
                          int64_t n_cta, void* lse_out, void* part_scalar, void* part_cols,
                          void* out_scalar, void* out_cols, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  EmPlan plan;
  cudaError_t err = em_plan<LT, CT>(G, plan);
  if (err != cudaSuccess) return (int)err;
  bool vec = vector_rows(logL, G);
  int64_t tq = 0, tr = 0;
  split_plan(E, n_cta, tq, tr);
  void* args[] = {&logL, &counts, &lse_prev, &logtheta, &done, &E, &G, &vec, &tq, &tr, &n_cta,
                  &plan.tile, &plan.slab, &lse_out, &part_scalar, &part_cols};
  const int64_t ctas = (n_cta + plan.ranges - 1) / plan.ranges;
  err = cudaLaunchKernel(plan.kernel, dim3((unsigned)ctas), dim3(plan.threads), args, plan.smem,
                         s);
  if (err != cudaSuccess) return (int)err;
  rcg_reduce_scalar<<<1, 32, 0, s>>>((const double*)part_scalar, n_cta, (double*)out_scalar);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (G + 255) / 256;
  rcg_reduce_cols<<<(unsigned)(blocks > 0 ? blocks : 1), 256, 0, s>>>(
      (const double*)part_cols, n_cta, G, (double*)out_cols);
  return (int)cudaGetLastError();
}

// out = {registers a thread, local (spilled) bytes a thread, rows and
// columns of the tile at G columns, CTAs resident an SM at that tile, the
// build (EmBuild), the row ranges a CTA walks}, for the kernel that G
// columns run, on the current device.
template <typename LT, typename CT>
static int info_em_step(int64_t G, int* out) {
  EmPlan plan;
  cudaError_t err = em_plan<LT, CT>(G, plan);
  cudaFuncAttributes attr;
  int ctas = 0;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, plan.kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, plan.kernel, plan.threads,
                                                        plan.smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = plan.tile;
  out[3] = (int)plan.slab;
  out[4] = ctas;
  out[5] = plan.build;
  out[6] = plan.ranges;
  return 0;
}

// The EM passes' exp (rcg_common.cuh exp_sel) against CUDA's exp, bit for
// bit (two NaNs count as equal), over n arguments: a third spread evenly
// over [-760, 760], a third drawn over exp's slow range [-746.5, -707.5],
// a third any 64 bits (hashed from the index).  *bad counts those that
// differ; first holds the first one met, exp_sel's value and exp's.
__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  return x ^ (x >> 33);
}
__global__ void exp_sel_check(int64_t n, unsigned long long* bad, double* first) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    double a;
    if (i % 3 == 0) a = -760.0 + 1520.0 * ((double)(i / 3) / (double)(n / 3 + 1));
    else if (i % 3 == 1) a = -746.5 + 39.0 * ((double)(mix64(i) >> 11) * 0x1.0p-53);
    else a = __longlong_as_double((long long)mix64(i));
    const double x = exp_sel(a), y = exp(a);
    if (__double_as_longlong(x) != __double_as_longlong(y) && !(x != x && y != y) &&
        atomicAdd(bad, 1ULL) == 0) {
      first[0] = a;
      first[1] = x;
      first[2] = y;
    }
  }
}

}  // namespace rcg

// bad: one zeroed unsigned 64-bit count, first: three doubles, on the
// device (rcg::exp_sel_check).  Returns a CUDA error.
extern "C" int em_exp_check(int64_t n, void* bad, void* first, void* stream) {
  rcg::exp_sel_check<<<2048, 256, 0, (cudaStream_t)stream>>>(n, (unsigned long long*)bad,
                                                            (double*)first);
  return (int)cudaGetLastError();
}

// Plain C entry points, one per instantiation (matrix type _ compute type).
// counts is (E,) in the matrix type; lse_prev, lse_out (E,) and logtheta
// (G,) in the compute type; done is one bool or null (never done).
// n_cta is the number of row ranges (rcg_common.cuh split_plan), the
// build's ranges a CTA each (the seventh int of its info).  part_scalar is
// scratch of n_cta doubles, part_cols of n_cta * G (a slot a range);
// out_scalar is one double (ddot), out_cols G doubles (colsum); all on the
// device.  em_step_info_* fills seven ints (rcg::info_em_step).  Both
// return a CUDA error.
#define EM_STEP_ENTRY(NAME, LT, CT)                                                          \
  extern "C" int NAME(const void* logL, const void* counts, const void* lse_prev,            \
                      const void* logtheta, const void* done, int64_t E, int64_t G,          \
                      int64_t n_cta, void* lse_out, void* part_scalar, void* part_cols,      \
                      void* out_scalar, void* out_cols, void* stream) {                      \
    return rcg::launch_em_step<LT, CT>(logL, counts, lse_prev, logtheta, done, E, G, n_cta,  \
                                       lse_out, part_scalar, part_cols, out_scalar, out_cols, \
                                       stream);                                              \
  }                                                                                          \
  extern "C" int NAME##_info(int64_t G, int* out) { return rcg::info_em_step<LT, CT>(G, out); }

EM_STEP_ENTRY(em_step_f32_f32, float, float)
EM_STEP_ENTRY(em_step_f64_f64, double, double)
