"""One EM iteration for B bootstrap replicates that share one logL, in one
streaming pass: kernel K6 and its plain version.

Replicate b has the counts countsT[:, b], the lse of its previous pass
lse_prev[:, b] and its own logtheta[b].  The pass returns, per replicate,
what K5 (ops/em_kernels.py em_step) returns for that replicate alone:

- lse (E, B): the row logsumexps of t_b = logL + logtheta_b, in logL's
  dtype (the next pass's lse_prev);
- colsum (B, G) float64: sum_e counts_eb * exp(t_beg - lse_eb), the
  M-step statistic;
- ddot (B,) float64: sum_e counts_eb * (lse_eb - lse_prev_eb), the
  deferred change of the objective's data term.

The JAX package runs this as the vmapped XLA branch of its EM step
(msweep_tpu/inference/em.py fit_em_batch), with no kernel of its own; the
kernel reads logL once for all B replicates (three times, a pass each, for
rows wider than 512 groups) where B serial K5 passes read it B times.  It
runs on K5's row ranges (em_kernels.ranges) with K5's row arithmetic, so
replicate b gives K5's bits on column b (chip_smoke.py phase 3 holds it to
that).

``done`` (an optional (B,) bool tensor on logL's device) marks replicates
that have stopped: the kernel does no row work for them, and every output
of theirs is 0.  It is read on the device, so a chunk of batched
iterations is enqueued with no host read (inference/em.py).

Dispatch and launch counts as in ops/rcg_kernels.py: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel
(msweep_tpu_torch/csrc/em_step_batch.cu) or raises.
"""

from __future__ import annotations

import torch

from . import em_kernels
from .rcg_kernels import F64, _on_cpu, _raise_on

# matrix dtype (= compute dtype) -> suffix of the C entry points: K5's.
INSTANTIATIONS = em_kernels.INSTANTIATIONS

# Cap on the (n_cta, B, G) float64 column partials: past it the grid
# shrinks below K5's (at B * G beyond PART_BYTES / (8 x K5's ranges): ~170k
# at 792 ranges, ~508k at the 264 of G > 512 on an H100, so G beyond
# ~63,500 at B = 8), and the replicates' sums then leave K5's row ranges:
# the same values within float64 round-off, no longer K5's bits.
PART_BYTES = 1 << 30


def em_step_batch_plain(logL, countsT, lse_prev, logtheta, done=None):
    """Plain K6: K5's plain arithmetic (em_kernels.em_pass_plain) on each
    replicate's column, so replicate b has plain K5's bits on it.  It
    computes every replicate and zeroes those flagged in done, with no
    host read."""
    em_step_batch_plain.launches += 1
    B = countsT.shape[1]
    outs = [em_kernels.em_pass_plain(logL, countsT[:, b], lse_prev[:, b], logtheta[b])
            for b in range(B)]
    lse = torch.stack([o[0] for o in outs], dim=1)
    colsum = torch.stack([o[1] for o in outs])
    ddot = torch.stack([o[2] for o in outs])
    if done is not None:
        done = done.to(device=logL.device, dtype=torch.bool)
        lse, colsum = lse.masked_fill(done[None, :], 0), colsum.masked_fill(done[:, None], 0)
        ddot = ddot.masked_fill(done, 0)
    return lse, colsum, ddot


em_step_batch_plain.launches = 0


def _check_inputs(logL, countsT, lse_prev, logtheta, done):
    """The C suffix, then countsT, lse_prev (E, B) and logtheta (B, G) as
    contiguous tensors in logL's dtype, and done as a contiguous bool
    tensor (or None), all checked against logL."""
    if logL.dtype not in INSTANTIATIONS:
        raise TypeError(f"no batched EM kernel for matrix {logL.dtype}")
    if logL.dim() != 2 or not logL.is_contiguous():
        raise ValueError("logL must be a contiguous (E, G) matrix")
    E, G = logL.shape
    if (countsT.dim() != 2 or countsT.shape[0] != E or countsT.shape[1] < 1
            or countsT.dtype != logL.dtype or countsT.device != logL.device):
        raise ValueError(f"countsT must be ({E}, B >= 1) {logL.dtype} on {logL.device}")
    B = countsT.shape[1]
    for x, shape in ((lse_prev, (E, B)), (logtheta, (B, G))):
        if tuple(x.shape) != shape or x.device != logL.device:
            raise ValueError(f"lse_prev must be ({E}, {B}) and logtheta ({B}, {G}) on "
                             f"{logL.device}")
    if done is not None:
        if tuple(done.shape) != (B,) or done.device != logL.device:
            raise ValueError(f"done must be ({B},) on {logL.device}")
        done = done.to(torch.bool).contiguous()
    return (INSTANTIATIONS[logL.dtype], countsT.contiguous(),
            lse_prev.to(logL.dtype).contiguous(), logtheta.to(logL.dtype).contiguous(), done)


# K6's build at G columns on a card (registers, spills, tile rows, CTAs an
# SM, rows a warp takes at once, chunk columns), from the runtime.
kernel_info = em_kernels.batch_info


def em_step_batch_kernel(logL, countsT, lse_prev, logtheta, done=None):
    """K6 on the card (msweep_tpu_torch/csrc/em_step_batch.cu), on the row
    ranges K5 takes at G columns (em_kernels.ranges), fewer where the
    partials would pass PART_BYTES.  The wide build (G > 512) takes a
    scratch of its chunk columns' maxima and exp sums, two (NC, B, E)
    tensors in logL's dtype, allocated here beside the partials."""
    from ._build import load

    suffix, countsT, lse_prev, logtheta, done = _check_inputs(logL, countsT, lse_prev,
                                                              logtheta, done)
    E, G = logL.shape
    B = countsT.shape[1]
    dev = logL.device
    n_cta = em_kernels.ranges(suffix, E, G, dev, max_ranges=PART_BYTES // (8 * B * G))
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    nc = em_kernels.batch_info(suffix, G, index)["chunk_columns"]
    lse = torch.empty((E, B), dtype=logL.dtype, device=dev)
    part_s = torch.empty((n_cta, B), dtype=F64, device=dev)
    part_c = torch.empty((n_cta, B, G), dtype=F64, device=dev)
    scratch = torch.empty((2, nc, B, E), dtype=logL.dtype, device=dev) if nc else None
    out_s = torch.empty((B,), dtype=F64, device=dev)
    out_c = torch.empty((B, G), dtype=F64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(load(), f"em_step_batch_{suffix}")(
            logL.data_ptr(), countsT.data_ptr(), lse_prev.data_ptr(), logtheta.data_ptr(),
            None if done is None else done.data_ptr(), E, G, B, n_cta, lse.data_ptr(),
            part_s.data_ptr(), part_c.data_ptr(), None if scratch is None else scratch.data_ptr(),
            out_s.data_ptr(), out_c.data_ptr(), stream,
        )
    _raise_on(rc, "em_step_batch")
    em_step_batch_kernel.launches += 1
    return lse, out_c, out_s


em_step_batch_kernel.launches = 0


def em_step_batch(logL, countsT, lse_prev, logtheta, done=None):
    """One EM pass for B replicates: (lse (E, B) in logL's dtype, colsum
    (B, G) float64, ddot (B,) float64).  logL (E, G); countsT (E, B) in
    logL's dtype; lse_prev (E, B) and logtheta (B, G) are rounded to
    logL's dtype; done None or (B,) bool."""
    if _on_cpu(logL):
        return em_step_batch_plain(logL, countsT, lse_prev, logtheta, done)
    return em_step_batch_kernel(logL, countsT, lse_prev, logtheta, done)
