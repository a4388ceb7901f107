// K6: one EM iteration for B bootstrap replicates in one pass over logL.
//
// The JAX package has no kernel for this: its fit_em_batch
// (msweep_tpu/inference/em.py) vmaps the XLA branch of the EM step over
// the (B, E) counts.  For each replicate b (counts = column b of the
// (E, B) countsT, lse_prev column b, logtheta row b) K6 returns what K5
// (em_step.cu, the port of msweep_tpu/ops/em_pallas.py em_step) returns
// for that replicate alone, with t_b = logL + logtheta_b:
//
//     lse_eb    = logsumexp_g t_beg                                  (E, B)
//     colsum_bg = sum_e c_eb * exp(t_beg - lse_eb)                   (B, G)
//     ddot_b    = sum_e c_eb * (lse_eb - lse_prev_eb)                (B,)
//
// taken as K5 takes them: c / den once a row, exp(t - max) once a cell
// (rcg_common.cuh em_chunk_stats / em_row_stats, em_chunk_w), the row
// terms in the compute type, the sums across rows in float64 in row
// order.  K6 runs on the row ranges K5 runs on (split_rows; their count
// is lcm(K5's CTAs an SM, K6's) x SMs, ops/em_kernels.py ranges), so
// replicate b gives K5's bits on column b.  A replicate flagged in done[]
// does no row work and returns zeros.
//
// Bound by compute: logL is read from device memory once a pass for all
// B replicates, but each replicate has its own theta, so each cell takes
// one exp a replicate.  Rows of one chunk (G <= 512) run K4's layout: CTA
// (x, y) stages range y's rows tile by tile in shared memory (cp.async,
// walk_staged_tiles), each row CHUNK cells apart with -inf beyond G, and
// warp w walks every row for replicate 8x + w, two rows at once.  Its
// design, each step timed with msweep_tpu_torch/time_batch_kernels.py
// --em at 2,301,952 x 512, B = 8, on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md section 6; float64 / float32 ms a pass):
// - First: no branch around the exp (a select instead), the column sums
//   in the lane's own slice of shared memory, three CTAs an SM in float32
//   and two in float64, a row's count read ahead: 54.3 -> 35.1 / 12.1 ->
//   10.5.
// - Row ranges in whole waves: K5's 396 ranges were one and a half waves of
//   K6's two float64 CTAs an SM; 792 are three (35.1 -> 30.2, the first
//   kernel on them).
// - A row's loads from shared memory without a test of G (the pad cells),
//   and a max by one compare and a select (vmax): fmax in float64 is a
//   compare, two selects and a NaN fix-up (-> 26.4 at one row at once).
// - The float64 exp with no branch: CUDA's exp branches to a slow path for
//   |x| >= 708.4, and the branch serialises a row's 16 exps; its fast path
//   alone, with exp itself out of line for the rare cells beyond it, let
//   the 16 interleave (-> 23.1).
// - Two rows at once: their maxes, exps, sums across the warp and
//   divisions interleave, and both rows' weights are added into each
//   column sum in one read and write of it; the row's log and ddot term
//   are taken once a row in groups of 32 (-> 22.5 / 9.4).
// - The exp shared with K5 (rcg_common.cuh row_exps): every branch of
//   CUDA's exp as a select, so no cell takes a slow path.  A long EM fit
//   drives its vanishing groups into exp's slow range, where the
//   out-of-line exp cost 31.9 ms a pass, and K5 twice its time; this one
//   takes 26.5 there and on fresh inputs alike.
// Wider rows (G > 512) run the same layout chunk column by chunk column:
// NC = ceil(G / 512) chunk columns, and three passes over a grid of (NC x
// ceil(B / 8), ranges) CTAs, CTA (c, x, y) staging columns [512c, 512c +
// 512) of range y's rows (-inf beyond G) for replicates 8x ... 8x + 7, a
// warp each, two rows at once, rows in groups of 32.  K5's general build
// merges a row's chunks online (rcg_common.cuh em_chunk_stats: chunk c's
// exps at the running max M_c = cmax(M_{c-1}, max of chunk c), den = den
// * exp(M_{c-1} - M_c) + the chunk's sum) and then takes the weights with
// a second exp a cell (em_chunk_w).  Every value there is a function of
// the chunks' maxima, their sums and the cells, so the passes take them
// apart and keep K5's operations and their order:
// 1. each chunk's max of t = logL + logtheta, into an (NC, B, E) scratch;
// 2. each chunk's exp sum at its M_c, from pass 1's maxima, into a second;
// 3. lane j of a group of 32 rows replays the merge for its row from the
//    two, takes crow = cnt / den, and each chunk column adds w = exp(t -
//    m) * crow into its lanes' column sums and writes them to its slice
//    of the (ranges, B, G) partials; chunk column 0 writes lse = m +
//    log(den) and adds the ddot terms in row order.
// So logL is read from device memory three times a pass, each replicate
// reads it from shared memory, the replicates' warps run in parallel,
// and no CTA reads and writes device memory in its loop but for the
// per-row scalars; each cell takes two exps a replicate, K5's two.  The
// CTAs an SM (WideBuild) divide K5's general build's two, so K5's ranges
// at G > 512 are what they were.  No atomics: the second
// stage sums the partials in CTA order, as K5's does.  Any E >= 0, G >=
// 1, B >= 1.
#include <type_traits>

#include "rcg_common.cuh"

namespace rcg {

// The one-chunk build's settings by compute type, each timed with
// msweep_tpu_torch/time_batch_kernels.py --em (PERF.md section 6): CTAs an
// SM, rows a warp takes at once, and whether the replicate's logtheta row
// lives in the lane's slice of shared memory (float64, where its 32
// registers a thread would spill) or in registers.
template <typename CT>
struct RepBuild {
  static constexpr int ctas = sizeof(CT) == 4 ? 3 : 2;
  static constexpr int rows = 2;
  static constexpr bool lt_shared = sizeof(CT) == 8;
};
// Shared memory ahead of the staged rows: the lanes' float64 column sums,
// then (lt_shared) their logtheta; slot i of lane l of warp w at (w * NPL
// + i) * 32 + l, a slice no other lane touches.
constexpr int64_t REP_COLS_BYTES = (int64_t)WARPS * CHUNK * (int64_t)sizeof(double);
template <typename CT>
__host__ __device__ constexpr int64_t rep_fixed_bytes() {
  return REP_COLS_BYTES +
         (RepBuild<CT>::lt_shared ? (int64_t)WARPS * CHUNK * (int64_t)sizeof(CT) : 0);
}

// A max with fmax's value on numbers (the sign of a zero aside, which no
// output of the pass sees): one compare and a select, where fmax in
// float64 takes a compare, two selects and a NaN fix-up.
template <typename T>
__device__ __forceinline__ T vmax(T a, T b) {
  return a > b ? a : b;
}

// The max across the warp and the sum across the warp of R rows at once:
// warp_max's and warp_sum's butterflies, the rows' shuffles interleaved.
template <int R, typename T>
__device__ __forceinline__ void warp_max_rows(T (&x)[R]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    T y[R];
#pragma unroll
    for (int k = 0; k < R; ++k) y[k] = __shfl_xor_sync(0xffffffffu, x[k], o);
#pragma unroll
    for (int k = 0; k < R; ++k) x[k] = vmax(x[k], y[k]);
  }
}
template <int R, typename T>
__device__ __forceinline__ void warp_sum_rows(T (&x)[R]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    T y[R];
#pragma unroll
    for (int k = 0; k < R; ++k) y[k] = __shfl_xor_sync(0xffffffffu, x[k], o);
#pragma unroll
    for (int k = 0; k < R; ++k) x[k] += y[k];
  }
}

// The max of a lane's NPL cells, as a tree.
template <typename CT>
__device__ __forceinline__ CT lane_max(const CT (&x)[NPL]) {
  CT a[NPL / 2];
#pragma unroll
  for (int i = 0; i < NPL / 2; ++i) a[i] = vmax(x[2 * i], x[2 * i + 1]);
#pragma unroll
  for (int n = NPL / 4; n > 0; n >>= 1) {
#pragma unroll
    for (int i = 0; i < n; ++i) a[i] = vmax(a[2 * i], a[2 * i + 1]);
  }
  return a[0];
}

// The lane's NPL cells of a staged row whose cells beyond G hold -inf in
// shared memory (rows CHUNK cells apart): load_row_chunk's slots, in
// 16-byte loads with no test of G.
template <typename LT>
__device__ __forceinline__ void load_row_padded(const LT* row, int lane, LT (&L)[NPL]) {
#pragma unroll
  for (int j = 0; j < NPL / 4; ++j) {
    const LT* p = row + 128 * j + 4 * lane;
    if constexpr (sizeof(LT) == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      L[4 * j] = q.x; L[4 * j + 1] = q.y; L[4 * j + 2] = q.z; L[4 * j + 3] = q.w;
    } else {
      const double2 a = reinterpret_cast<const double2*>(p)[0];
      const double2 b = reinterpret_cast<const double2*>(p)[1];
      L[4 * j] = a.x; L[4 * j + 1] = a.y; L[4 * j + 2] = b.x; L[4 * j + 3] = b.y;
    }
  }
}

// Rows of one chunk: warp w of CTA (x, y) is replicate 8x + w over row
// range y.  The warp takes RepBuild::rows rows at once, each with K5's
// values (em_row_stats at nch = 1: t = logL + logtheta, its max, exp(t -
// max) and their sum in slot order, then across the warp by warp_sum's
// butterfly; crow = cnt / den; w = e * crow), so the rows' serial steps
// (the max and the sum across the warp, the division) overlap one
// another, and adds both rows' weights into each column sum, in row
// order, in one read and write of it.  Rows go in
// groups of 32 from the range's start: lane j holds row g0 + j's count
// and lse_prev, read when the group starts (the rows take their count
// from it by a shuffle), and keeps its max and exp sum once the row has
// passed; at the group's end each lane takes its row's log and writes its
// lse, and the group's ddot terms are added in row order.  So the log is
// taken once a row, off the rows' chain, and the values and the order of
// every sum are K5's.
template <typename LT, typename CT>
__global__ void __launch_bounds__(THREADS, RepBuild<CT>::ctas)
em_step_batch_rep_kernel(const LT* __restrict__ logL, const LT* __restrict__ countsT,
                         const CT* __restrict__ lse_prev, const CT* __restrict__ logtheta,
                         const bool* __restrict__ done, int64_t E, int64_t G, int64_t B,
                         bool vec, int64_t tq, int64_t tr, int tile, CT* __restrict__ lse_out,
                         double* __restrict__ part_scalar, double* __restrict__ part_cols) {
  using Build = RepBuild<CT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  double* __restrict__ cs = reinterpret_cast<double*>(smem) + warp * NPL * 32 + lane;
  CT* __restrict__ lt_sh = reinterpret_cast<CT*>(smem + REP_COLS_BYTES) + warp * NPL * 32 + lane;
  // Staged rows of logL, CHUNK cells apart, -inf beyond G.
  LT* ring = reinterpret_cast<LT*>(smem + rep_fixed_bytes<CT>());
  for (int64_t i = threadIdx.x; i < 2 * tile * (CHUNK - G); i += THREADS)
    ring[i / (CHUNK - G) * CHUNK + G + i % (CHUNK - G)] = neg_inf<LT>();
  const int64_t b = (int64_t)blockIdx.x * WARPS + warp;
  const bool live = b < B && !(done != nullptr && done[b]);
  int64_t lo, hi;
  split_rows(blockIdx.y, E, tq, tr, lo, hi);
  if (b < B && !live) {  // a done replicate: zeros in its column of lse
    for (int64_t e = lo + lane; e < hi; e += 32) lse_out[e * B + b] = 0;
  }
  double acc = 0.0;  // the replicate's ddot partial, the same on every lane
#pragma unroll
  for (int i = 0; i < NPL; ++i) cs[i * 32] = 0.0;
  if (__syncthreads_or(live)) {
    CT lt[NPL];
    // Lane j's row of the group [g0, g0 + 32): count, lse_prev, max, exp sum.
    int64_t g0 = lo;
    CT cnt_g = 0, lp_g = 0, m_g = 0, den_g = 1;
    auto start_group = [&]() {
      const int64_t e = g0 + lane;
      cnt_g = e < hi ? (CT)countsT[e * B + b] : (CT)0;
      lp_g = e < hi ? lse_prev[e * B + b] : (CT)0;
    };
    auto end_group = [&](int n) {
      const CT lse = m_g + clog(den_g);
      double term = 0.0;
      if (lane < n) {
        lse_out[(g0 + lane) * B + b] = lse;
        term = (double)(cnt_g * (lse - lp_g));
      }
      // Lane 0's order; a lane past n adds +0, which leaves acc (never -0).
#pragma unroll
      for (int j = 0; j < 32; ++j) acc += __shfl_sync(0xffffffffu, term, j);
      g0 += 32;
      start_group();
    };
    if (live) {
      load_cols(logtheta + b * G, 0, G, lane, lt);
      if (Build::lt_shared) {
#pragma unroll
        for (int i = 0; i < NPL; ++i) lt_sh[i * 32] = lt[i];
      }
      start_group();
    }
    // R rows from row e0 at `rows` (shared memory), all in the group.
    auto take_rows = [&](auto r_const, int64_t e0, const LT* rows) {
      constexpr int R = decltype(r_const)::value;
      CT x[R][NPL], m[R], den[R], crow[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        LT L[NPL];
        load_row_padded(rows + (int64_t)k * CHUNK, lane, L);
#pragma unroll
        for (int i = 0; i < NPL; ++i)
          x[k][i] = (CT)L[i] + (Build::lt_shared ? lt_sh[i * 32] : lt[i]);
        m[k] = lane_max(x[k]);
      }
      warp_max_rows<R>(m);
#pragma unroll
      for (int k = 0; k < R; ++k) {
#pragma unroll
        for (int i = 0; i < NPL; ++i) x[k][i] = x[k][i] - m[k];
        row_exps(x[k]);
        den[k] = 0;
#pragma unroll
        for (int i = 0; i < NPL; ++i) den[k] += x[k][i];
      }
      warp_sum_rows<R>(den);
      const int slot = (int)(e0 - g0);
#pragma unroll
      for (int k = 0; k < R; ++k) {
        crow[k] = __shfl_sync(0xffffffffu, cnt_g, slot + k) / den[k];
        if (lane == slot + k) {
          m_g = m[k];
          den_g = den[k];
        }
      }
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        double s = cs[i * 32];
#pragma unroll
        for (int k = 0; k < R; ++k) s += (double)(x[k][i] * crow[k]);
        cs[i * 32] = s;
      }
    };
    walk_staged_tiles(ring, logL, G, G, (int64_t)CHUNK, vec, lo, hi, tile, live,
                      [&](int64_t t0, int nr, const LT* rows) {
      int r = 0;
      while (r < nr) {
        const int end = (int)(g0 + 32 - t0 < nr ? g0 + 32 - t0 : nr);  // the group's rows here
        for (; r + Build::rows <= end; r += Build::rows)
          take_rows(std::integral_constant<int, Build::rows>{}, t0 + r,
                    rows + (int64_t)r * CHUNK);
        for (; r < end; ++r)
          take_rows(std::integral_constant<int, 1>{}, t0 + r, rows + (int64_t)r * CHUNK);
        if (t0 + r == g0 + 32 || t0 + r == hi) end_group((int)(t0 + r - g0));
      }
    });
  }
  if (b < B) {
    double* __restrict__ cols = part_cols + ((int64_t)blockIdx.y * B + b) * G;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int64_t g = slot_col(0, i, lane);
      if (g < G) cols[g] = cs[i * 32];
    }
    if (lane == 0) part_scalar[(int64_t)blockIdx.y * B + b] = acc;
  }
}

// The wide build's settings, each timed with time_batch_kernels.py --em
// --passes at 1,150,976 x 1,024 (PERF.md section 6): CTAs an SM, two in
// float32 and one in float64 (divisors of K5's general build's two, so
// that the ranges the two share at G > 512 stay 2 x SMs; float64 passes 2
// and 3 spill 200 / 108 B at two, 128 registers, and take 24 ms each,
// 21-22 at one with 254 registers and none spilled), rows a warp takes at
// once, and whether float64 logtheta lives in the lane's slice of shared
// memory, as RepBuild's.
template <typename CT>
struct WideBuild {
  static constexpr int ctas = sizeof(CT) == 4 ? 2 : 1;
  static constexpr int rows = 2;
  static constexpr bool lt_shared = sizeof(CT) == 8;
};
// Shared memory ahead of pass PASS's staged rows: the lanes' float64 column
// sums (pass 3 only), then (lt_shared) their logtheta, in the one-chunk
// build's slices.
template <typename CT, int PASS>
__host__ __device__ constexpr int64_t wide_fixed_bytes() {
  return (PASS == 3 ? REP_COLS_BYTES : 0) +
         (WideBuild<CT>::lt_shared ? (int64_t)WARPS * CHUNK * (int64_t)sizeof(CT) : 0);
}

// Pass PASS (1, 2, 3: the header's) of the wide build.  CTA (c, x, y) =
// (blockIdx.x / nbx, blockIdx.x % nbx, blockIdx.y), nbx = ceil(B / 8):
// warp w is replicate 8x + w over row range y, on chunk c's cells staged
// CHUNK apart with -inf beyond G.  chunk_max and chunk_sum are (NC, B, E)
// in the compute type.  Rows go in groups of 32 from the range's start,
// lane j holding row g0 + j's scalars, which the rows take by shuffle:
// pass 1 the chunk's max, kept once the row has passed and written at the
// group's end; pass 2 M_c, read when the group starts, and the chunk's
// exp sum, kept and written likewise; pass 3 the row's m and crow,
// replayed when the group starts from both scratches, where chunk column
// 0 also writes the row's lse and adds the group's ddot terms in row
// order.  The operations and their order are em_chunk_stats's and
// em_chunk_w's, so every replicate gives K5's bits.
template <typename LT, typename CT, int PASS>
__global__ void __launch_bounds__(THREADS, WideBuild<CT>::ctas)
em_step_batch_wide_kernel(const LT* __restrict__ logL, const LT* __restrict__ countsT,
                          const CT* __restrict__ lse_prev, const CT* __restrict__ logtheta,
                          const bool* __restrict__ done, int64_t E, int64_t G, int64_t B,
                          bool vec, int64_t tq, int64_t tr, int tile,
                          CT* __restrict__ chunk_max, CT* __restrict__ chunk_sum,
                          CT* __restrict__ lse_out, double* __restrict__ part_scalar,
                          double* __restrict__ part_cols) {
  using Build = WideBuild<CT>;
  constexpr int64_t COLS = PASS == 3 ? REP_COLS_BYTES : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  double* __restrict__ cs = reinterpret_cast<double*>(smem) + warp * NPL * 32 + lane;
  CT* __restrict__ lt_sh = reinterpret_cast<CT*>(smem + COLS) + warp * NPL * 32 + lane;
  LT* ring = reinterpret_cast<LT*>(smem + wide_fixed_bytes<CT, PASS>());
  const int64_t nbx = (B + WARPS - 1) / WARPS;
  const int c = (int)(blockIdx.x / nbx), nc = (int)((G + CHUNK - 1) / CHUNK);
  const int64_t c0 = (int64_t)c * CHUNK, cw = G - c0 < CHUNK ? G - c0 : CHUNK;
  for (int64_t i = threadIdx.x; i < 2 * tile * (CHUNK - cw); i += THREADS)
    ring[i / (CHUNK - cw) * CHUNK + cw + i % (CHUNK - cw)] = neg_inf<LT>();
  const int64_t b = (blockIdx.x - (int64_t)c * nbx) * WARPS + warp;
  const bool live = b < B && !(done != nullptr && done[b]);
  int64_t lo, hi;
  split_rows(blockIdx.y, E, tq, tr, lo, hi);
  const int64_t chunk = B * E;  // one chunk's (B, E) of scratch
  if (PASS == 3 && c == 0 && b < B && !live) {  // a done replicate: zeros in its lse
    for (int64_t e = lo + lane; e < hi; e += 32) lse_out[e * B + b] = 0;
  }
  double acc = 0.0;  // pass 3, chunk column 0: the replicate's ddot partial, on every lane
  if (PASS == 3) {
#pragma unroll
    for (int i = 0; i < NPL; ++i) cs[i * 32] = 0.0;
  }
  if (__syncthreads_or(live)) {
    CT lt[NPL];
    int64_t g0 = lo;
    CT m_g = 0, s_g = 0, crow_g = 0;  // lane j's row of the group [g0, g0 + 32)
    auto start_group = [&]() {
      const int64_t e = g0 + lane;
      double term = 0.0;
      if (PASS == 2 && e < hi) {  // em_chunk_stats's running max at chunk c
        CT M = neg_inf<CT>();
        for (int k = 0; k <= c; ++k) M = cmax(M, chunk_max[k * chunk + b * E + e]);
        m_g = M;
      }
      if (PASS == 3 && e < hi) {  // em_chunk_stats's merge of the row's chunks
        CT m = neg_inf<CT>(), den = 0;
        for (int k = 0; k < nc; ++k) {
          const CT M = cmax(m, chunk_max[k * chunk + b * E + e]);
          const CT sum = chunk_sum[k * chunk + b * E + e];
          den = (m == neg_inf<CT>()) ? sum : den * cexp(m - M) + sum;
          m = M;
        }
        const CT cnt = (CT)countsT[e * B + b];
        m_g = m;
        crow_g = cnt / den;
        if (c == 0) {
          const CT lse = m + clog(den);
          lse_out[e * B + b] = lse;
          term = (double)(cnt * (lse - lse_prev[e * B + b]));
        }
      }
      if (PASS == 3 && c == 0) {
        // Lane 0's order; a lane past hi adds +0, which leaves acc (never -0).
#pragma unroll
        for (int j = 0; j < 32; ++j) acc += __shfl_sync(0xffffffffu, term, j);
      }
    };
    auto end_group = [&](int n) {
      if (PASS == 1 && lane < n) chunk_max[c * chunk + b * E + g0 + lane] = m_g;
      if (PASS == 2 && lane < n) chunk_sum[c * chunk + b * E + g0 + lane] = s_g;
      g0 += 32;
      start_group();
    };
    if (live) {
      load_cols(logtheta + b * G, c0, G, lane, lt);
      if (Build::lt_shared) {
#pragma unroll
        for (int i = 0; i < NPL; ++i) lt_sh[i * 32] = lt[i];
      }
      start_group();
    }
    // R rows from row e0 at `rows` (shared memory), all in the group.
    auto take_rows = [&](auto r_const, int64_t e0, const LT* rows) {
      constexpr int R = decltype(r_const)::value;
      CT x[R][NPL], v[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        LT L[NPL];
        load_row_padded(rows + (int64_t)k * CHUNK, lane, L);
#pragma unroll
        for (int i = 0; i < NPL; ++i)
          x[k][i] = (CT)L[i] + (Build::lt_shared ? lt_sh[i * 32] : lt[i]);
      }
      const int slot = (int)(e0 - g0);
      if constexpr (PASS == 1) {
#pragma unroll
        for (int k = 0; k < R; ++k) v[k] = lane_max(x[k]);
        warp_max_rows<R>(v);
#pragma unroll
        for (int k = 0; k < R; ++k)
          if (lane == slot + k) m_g = v[k];
      } else {
        [[maybe_unused]] CT crow[R];  // pass 3's
#pragma unroll
        for (int k = 0; k < R; ++k) {
          v[k] = __shfl_sync(0xffffffffu, m_g, slot + k);  // M_c, or the row's max
          if constexpr (PASS == 3) crow[k] = __shfl_sync(0xffffffffu, crow_g, slot + k);
        }
#pragma unroll
        for (int k = 0; k < R; ++k) {
#pragma unroll
          for (int i = 0; i < NPL; ++i) x[k][i] = x[k][i] - v[k];
          row_exps(x[k]);
        }
        if constexpr (PASS == 2) {
#pragma unroll
          for (int k = 0; k < R; ++k) {
            v[k] = 0;
#pragma unroll
            for (int i = 0; i < NPL; ++i) v[k] += x[k][i];
          }
          warp_sum_rows<R>(v);
#pragma unroll
          for (int k = 0; k < R; ++k)
            if (lane == slot + k) s_g = v[k];
        } else {
#pragma unroll
          for (int i = 0; i < NPL; ++i) {
            double s = cs[i * 32];
#pragma unroll
            for (int k = 0; k < R; ++k) s += (double)(x[k][i] * crow[k]);
            cs[i * 32] = s;
          }
        }
      }
    };
    walk_staged_tiles(ring, logL + c0, cw, G, (int64_t)CHUNK, vec, lo, hi, tile, live,
                      [&](int64_t t0, int nr, const LT* rows) {
      int r = 0;
      while (r < nr) {
        const int end = (int)(g0 + 32 - t0 < nr ? g0 + 32 - t0 : nr);  // the group's rows here
        for (; r + Build::rows <= end; r += Build::rows)
          take_rows(std::integral_constant<int, Build::rows>{}, t0 + r,
                    rows + (int64_t)r * CHUNK);
        for (; r < end; ++r)
          take_rows(std::integral_constant<int, 1>{}, t0 + r, rows + (int64_t)r * CHUNK);
        if (t0 + r == g0 + 32 || t0 + r == hi) end_group((int)(t0 + r - g0));
      }
    });
  }
  if (PASS == 3 && b < B) {  // chunk c's columns of the partials; zeros for a done replicate
    double* __restrict__ cols = part_cols + ((int64_t)blockIdx.y * B + b) * G;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int64_t g = slot_col(c0, i, lane);
      if (g < G) cols[g] = cs[i * 32];
    }
    if (c == 0 && lane == 0) part_scalar[(int64_t)blockIdx.y * B + b] = acc;
  }
}

// Rows of a ring of two tiles of staged rows (CHUNK cells a row) beside
// `fixed` bytes, in the kernel's share of the SM at `ctas` CTAs an SM
// (wtile_budget), at most TILE_ROWS, and the dynamic shared memory that
// takes.
template <typename LT>
static cudaError_t staged_plan(const void* kernel, int ctas, int64_t fixed, WtileBudget& cache,
                               int& tile, size_t& smem) {
  int64_t budget = 0;
  cudaError_t err = wtile_budget(kernel, ctas, cache, budget);
  const int64_t buf = 2 * CHUNK * (int64_t)sizeof(LT);
  const int64_t t = (budget - fixed) / buf;
  tile = (int)(t < TILE_ROWS ? t : TILE_ROWS);
  smem = (size_t)(fixed + (tile > 0 ? tile : 0) * buf);
  if (err == cudaSuccess && tile < 1) err = cudaErrorInvalidConfiguration;
  return err;
}

// The launches G columns take before the second stage: the one-chunk
// build (n = 1), or the wide build's three passes, each with its kernel,
// tile rows and dynamic shared memory.
struct BatchPlan {
  int n = 0;
  const void* kernel[3] = {};
  int tile[3] = {};
  size_t smem[3] = {};
};

template <typename LT, typename CT, int PASS>
static cudaError_t wide_plan(BatchPlan& p) {
  static WtileBudget cache;
  const void* kernel = (const void*)em_step_batch_wide_kernel<LT, CT, PASS>;
  p.kernel[PASS - 1] = kernel;
  return staged_plan<LT>(kernel, WideBuild<CT>::ctas, wide_fixed_bytes<CT, PASS>(), cache,
                         p.tile[PASS - 1], p.smem[PASS - 1]);
}

template <typename LT, typename CT>
static cudaError_t em_batch_plan(int64_t G, BatchPlan& p) {
  if (G <= CHUNK) {
    static WtileBudget cache;
    p.n = 1;
    p.kernel[0] = (const void*)em_step_batch_rep_kernel<LT, CT>;
    return staged_plan<LT>(p.kernel[0], RepBuild<CT>::ctas, rep_fixed_bytes<CT>(), cache,
                           p.tile[0], p.smem[0]);
  }
  p.n = 3;
  cudaError_t err = wide_plan<LT, CT, 1>(p);
  if (err == cudaSuccess) err = wide_plan<LT, CT, 2>(p);
  if (err == cudaSuccess) err = wide_plan<LT, CT, 3>(p);
  return err;
}

template <typename LT, typename CT>
static int launch_em_step_batch(const void* logL, const void* countsT, const void* lse_prev,
                                const void* logtheta, const void* done, int64_t E, int64_t G,
                                int64_t B, int64_t n_cta, void* lse_out, void* part_scalar,
                                void* part_cols, void* scratch, void* out_scalar, void* out_cols,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  BatchPlan plan;
  cudaError_t err = em_batch_plan<LT, CT>(G, plan);
  if (err != cudaSuccess) return (int)err;
  bool vec = vector_rows(logL, G);
  int64_t tq = 0, tr = 0;
  split_plan(E, n_cta, tq, tr);
  const int64_t nbx = (B + WARPS - 1) / WARPS;
  int tile = plan.tile[0];
  if (plan.n == 1) {
    void* args[] = {&logL, &countsT, &lse_prev, &logtheta, &done, &E, &G, &B, &vec,
                    &tq, &tr, &tile, &lse_out, &part_scalar, &part_cols};
    err = cudaLaunchKernel(plan.kernel[0], dim3((unsigned)nbx, (unsigned)n_cta), dim3(THREADS),
                           args, plan.smem[0], s);
  } else {
    const int64_t nc = (G + CHUNK - 1) / CHUNK;
    CT* chunk_max = (CT*)scratch;
    CT* chunk_sum = chunk_max + nc * B * E;
    void* args[] = {&logL, &countsT, &lse_prev, &logtheta, &done, &E, &G, &B, &vec,
                    &tq, &tr, &tile, &chunk_max, &chunk_sum, &lse_out, &part_scalar,
                    &part_cols};
    for (int k = 0; k < plan.n && err == cudaSuccess; ++k) {
      tile = plan.tile[k];  // read at the launch
      err = cudaLaunchKernel(plan.kernel[k], dim3((unsigned)(nc * nbx), (unsigned)n_cta),
                             dim3(THREADS), args, plan.smem[k], s);
    }
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

// out = the build G columns run: kernel_info's registers a thread, local
// (spilled) bytes a thread, tile rows (staged rows of logL) and CTAs an
// SM (for the wide build the most registers and spilled bytes, and the
// fewest tile rows and CTAs, of its three passes), then the rows a warp
// takes at once and the chunk columns of the wide build's grid, NC (0 for
// rows of one chunk, which take no scratch).
template <typename LT, typename CT>
static int info_em_step_batch(int64_t G, int* out) {
  BatchPlan plan;
  cudaError_t err = em_batch_plan<LT, CT>(G, plan);
  for (int k = 0; k < plan.n && err == cudaSuccess; ++k) {
    int one[4];
    err = kernel_info(plan.kernel[k], plan.tile[k], plan.smem[k], one);
    for (int j = 0; j < 4; ++j) {
      const bool most = j < 2;
      if (k == 0 || (most ? one[j] > out[j] : one[j] < out[j])) out[j] = one[j];
    }
  }
  if (err != cudaSuccess) return (int)err;
  out[4] = G <= CHUNK ? RepBuild<CT>::rows : WideBuild<CT>::rows;
  out[5] = G <= CHUNK ? 0 : (int)((G + CHUNK - 1) / CHUNK);
  return 0;
}

}  // namespace rcg

// Plain C entry points, one per instantiation (matrix type _ compute type).
// countsT is (E, B) in the matrix type; lse_prev and lse_out (E, B) and
// logtheta (B, G) in the compute type; done is (B,) bool or null (no
// replicate done).  n_cta is the number of row ranges (rcg_common.cuh
// split_plan).  part_scalar is scratch of n_cta * B doubles, part_cols of
// n_cta * B * G; scratch holds 2 * NC * B * E values of the compute type
// for the wide build (NC = the info's sixth int; null where that is 0);
// out_scalar is B doubles (ddot), out_cols B * G (colsum); all on the
// device.  *_info fills six ints (rcg::info_em_step_batch).  Both return
// a CUDA error.
#define EM_STEP_BATCH_ENTRY(NAME, LT, CT)                                                       \
  extern "C" int NAME(const void* logL, const void* countsT, const void* lse_prev,             \
                      const void* logtheta, const void* done, int64_t E, int64_t G, int64_t B, \
                      int64_t n_cta, void* lse_out, void* part_scalar, void* part_cols,         \
                      void* scratch, void* out_scalar, void* out_cols, void* stream) {          \
    return rcg::launch_em_step_batch<LT, CT>(logL, countsT, lse_prev, logtheta, done, E, G, B, \
                                             n_cta, lse_out, part_scalar, part_cols, scratch,  \
                                             out_scalar, out_cols, stream);                    \
  }                                                                                             \
  extern "C" int NAME##_info(int64_t G, int* out) {                                             \
    return rcg::info_em_step_batch<LT, CT>(G, out);                                             \
  }

EM_STEP_BATCH_ENTRY(em_step_batch_f32_f32, float, float)
EM_STEP_BATCH_ENTRY(em_step_batch_f64_f64, double, double)
