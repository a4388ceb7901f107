// T1-T3: the profiler's sweeps over a float32 (E, G) matrix x, one result
// per row, chained through a scalar s read by device pointer.
//
// Replace the TPU microbenchmarks of tools/prof_kernels.py:
//
//   T1 prof_read  (_read_kernel):  out[e] = sum_g (x[e,g] + s * 1e-30)
//   T2 prof_exp   (_exp_kernel):   out[e] = lse_g(x[e,g] + s * 1e-30)
//   T3 prof_exp2  (_exp2_kernel):  out[e] = lse_g(x + s * 1e-30) + lse_g(0.5 x + 2 s)
//
// They keep K5's layout: one warp per row, 32-wide strides over G, a
// fixed grid of a few CTAs per SM over contiguous whole tiles of rows.  T1
// reads each cell once and adds it, T2 walks the row twice (max, then exp
// and sum; the second walk hits L1), T3 does T2's walks for two
// logsumexps at once.  So T1 is the read rate of the layout (bound by
// memory: 4 B/cell), and T2/T3 add one and two exps per cell; set against
// K1, K2 and K5 (two exps per cell each) they say how far those are from
// a read with the same exps.  chip_smoke.py phase 3 times each beside its
// bound and beside torch.sum / torch.logsumexp over the rows of the same
// matrix (T1 / T2 up to the fold); PERF.md keeps the numbers.
// The fold s * 1e-30 is inside the kernel so that each rep depends on the
// previous rep's out[0] (tools/prof_kernels.py: 139-143).  Each writes
// its own (E,) output: no atomics, no partials.
#include "rcg_common.cuh"

namespace rcg {

enum ProfOp { PROF_READ = 0, PROF_EXP = 1, PROF_EXP2 = 2 };

template <int OP>
__global__ void __launch_bounds__(THREADS)
prof_sweep_kernel(const float* __restrict__ x, const float* __restrict__ s, int64_t E,
                  int64_t G, int64_t rows_per_cta, float* __restrict__ out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float sv = *s;
  const float fold = sv * 1e-30f;
  const float shift2 = sv * 2.0f;
  int64_t lo, hi;
  cta_rows(E, rows_per_cta, lo, hi);
  for (int64_t t0 = lo; t0 < hi; t0 += TILE_ROWS) {
    for (int k = 0; k < ROWS_PER_WARP; ++k) {
      const int64_t e = t0 + warp * ROWS_PER_WARP + k;
      if (e >= hi) continue;  // warp-uniform
      const float* __restrict__ row = x + e * G;
      float res;
      if (OP == PROF_READ) {
        float acc = 0.0f;
#pragma unroll 4
        for (int64_t g = lane; g < G; g += 32) acc += row[g] + fold;
        res = warp_sum(acc);
      } else {
        float m1 = -INFINITY, m2 = -INFINITY;
#pragma unroll 4
        for (int64_t g = lane; g < G; g += 32) {
          const float xv = row[g];
          m1 = fmaxf(m1, xv + fold);
          if (OP == PROF_EXP2) m2 = fmaxf(m2, 0.5f * xv + shift2);
        }
        m1 = warp_max(m1);
        if (OP == PROF_EXP2) m2 = warp_max(m2);
        float s1 = 0.0f, s2 = 0.0f;
#pragma unroll 4
        for (int64_t g = lane; g < G; g += 32) {
          const float xv = row[g];
          s1 += expf((xv + fold) - m1);
          if (OP == PROF_EXP2) s2 += expf((0.5f * xv + shift2) - m2);
        }
        res = m1 + logf(warp_sum(s1));
        if (OP == PROF_EXP2) res += m2 + logf(warp_sum(s2));
      }
      if (lane == 0) out[e] = res;
    }
  }
}

template <int OP>
static int launch_sweep(const void* x, const void* s, int64_t E, int64_t G,
                        int64_t rows_per_cta, int64_t n_cta, void* out, void* stream) {
  prof_sweep_kernel<OP><<<(unsigned)n_cta, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)s, E, G, rows_per_cta, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace rcg

// Plain C entry points: x (E, G) float32, s one float32, out (E,) float32,
// all on the device.
#define PROF_ENTRY(NAME, OP)                                                            \
  extern "C" int NAME(const void* x, const void* s, int64_t E, int64_t G,             \
                      int64_t rows_per_cta, int64_t n_cta, void* out, void* stream) {  \
    return rcg::launch_sweep<OP>(x, s, E, G, rows_per_cta, n_cta, out, stream);         \
  }

PROF_ENTRY(prof_read_f32, rcg::PROF_READ)
PROF_ENTRY(prof_exp_f32, rcg::PROF_EXP)
PROF_ENTRY(prof_exp2_f32, rcg::PROF_EXP2)
