// T1-T3: the profiler's sweeps over a float32 (E, G) matrix x, one result
// per row, chained through a scalar s read by device pointer.
//
// Replace the TPU microbenchmarks of tools/prof_kernels.py:
//
//   T1 prof_read  (_read_kernel):  out[e] = sum_g (x[e,g] + s * 1e-30)
//   T2 prof_exp   (_exp_kernel):   out[e] = lse_g(x[e,g] + s * 1e-30)
//   T3 prof_exp2  (_exp2_kernel):  out[e] = lse_g(x + s * 1e-30) + lse_g(0.5 x + 2 s)
//
// T1 is the read ceiling the streaming kernels are set against, so it
// reads the way K1, K2 and K5 read (rcg_common.cuh load_row_chunk: 16
// cells a lane, 16-byte loads where G % 4 == 0, chunks of 512 columns)
// on a fixed grid of a few CTAs per SM, one chunk in flight a warp: 16-byte
// loads of 16 cells a lane at 32 warps an SM already read at torch.sum's
// rate on an H100, with no prefetch of the next chunk.  Bound by memory:
// 4 B/cell, one add per cell.  A lane adds its cells in slot order and a
// warp its lanes by a fixed butterfly, so the bits do not depend on the
// grid.
//
// T2/T3 walk a row with one warp in 32-wide strides over G, on a
// fixed grid of a few CTAs per SM over contiguous whole tiles of rows; T2
// walks the row twice (max, then exp and sum; the second walk hits L1),
// T3 does T2's walks for two logsumexps at once.  So T2/T3 add one and two
// exps per cell to a read.  chip_smoke.py phase 3 times each beside its
// bound and beside torch.sum / torch.logsumexp over the rows of the same
// matrix (T1 / T2 up to the fold); PERF.md keeps the numbers.
// The fold s * 1e-30 is inside the kernel so that each rep depends on the
// previous rep's out[0] (tools/prof_kernels.py: 139-143).  Each writes
// its own (E,) output: no atomics, no partials.
#include "rcg_common.cuh"

namespace rcg {

enum ProfOp { PROF_EXP = 1, PROF_EXP2 = 2 };

// T1.  A warp takes the CTA's rows lo + warp, lo + warp + WARPS, ... and
// each row's chunks in order, one chunk in registers at a time.
__global__ void __launch_bounds__(THREADS)
prof_read_kernel(const float* __restrict__ x, const float* __restrict__ s, int64_t E, int64_t G,
                 bool vec, int64_t rows_per_cta, float* __restrict__ out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float fold = *s * 1e-30f;
  int64_t lo, hi;
  cta_rows(E, rows_per_cta, lo, hi);
  float v[NPL];
  for (int64_t e = lo + warp; e < hi; e += WARPS) {
    float acc = 0.0f;
    for (int64_t c0 = 0; c0 < G; c0 += CHUNK) {
      load_row_chunk(x + e * G, c0, G, vec, lane, v);
      if (c0 + CHUNK <= G) {
#pragma unroll
        for (int i = 0; i < NPL; ++i) acc += v[i] + fold;
      } else {  // the row's ragged last chunk
#pragma unroll
        for (int i = 0; i < NPL; ++i)
          if (slot_col(c0, i, lane) < G) acc += v[i] + fold;
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) out[e] = acc;
  }
}

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
      float res = m1 + logf(warp_sum(s1));
      if (OP == PROF_EXP2) res += m2 + logf(warp_sum(s2));
      if (lane == 0) out[e] = res;
    }
  }
}

static int launch_read(const void* x, const void* s, int64_t E, int64_t G, int64_t rows_per_cta,
                       int64_t n_cta, void* out, void* stream) {
  prof_read_kernel<<<(unsigned)n_cta, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)s, E, G, vector_rows(x, G), rows_per_cta, (float*)out);
  return (int)cudaGetLastError();
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
// all on the device.  Return a CUDA error.
extern "C" int prof_read_f32(const void* x, const void* s, int64_t E, int64_t G,
                             int64_t rows_per_cta, int64_t n_cta, void* out, void* stream) {
  return rcg::launch_read(x, s, E, G, rows_per_cta, n_cta, out, stream);
}

#define PROF_ENTRY(NAME, OP)                                                            \
  extern "C" int NAME(const void* x, const void* s, int64_t E, int64_t G,             \
                      int64_t rows_per_cta, int64_t n_cta, void* out, void* stream) {  \
    return rcg::launch_sweep<OP>(x, s, E, G, rows_per_cta, n_cta, out, stream);         \
  }

PROF_ENTRY(prof_exp_f32, rcg::PROF_EXP)
PROF_ENTRY(prof_exp2_f32, rcg::PROF_EXP2)
