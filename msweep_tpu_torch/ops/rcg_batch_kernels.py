"""The two streaming passes of one implicit rcg iteration for B bootstrap
replicates that share one logL: kernels K3/K4 and their plain versions.

Replicate b has the counts countsT[:, b] and its own (psi_b, c_b, v_b).
Each pass returns, per replicate, what the single pass of
ops/rcg_kernels.py returns for that replicate alone:

- K3 ``rcg_norm_batch``: the Fletcher-Reeves norms, (B,);
- K4 ``rcg_update_batch``: colsum (B, G) and the ELBO data-term change
  (B,).  Its absolute mode (c_old None) returns the data term itself; at
  (c, v) = (0, 0) that is the batched init (msweep_tpu/inference/rcg.py
  _rcg_init_implicit_batch).

c is a (B,) tensor on logL's device, read by the kernels through a
pointer, so a batched iteration is enqueued without a host sync.  The
passes compute in logL's dtype, float32 or float64: the batch has no
precision escalation, as in the JAX package.  Outputs are float64.

Dispatch, launch counts and padding as in ops/rcg_kernels.py: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel
(msweep_tpu_torch/csrc/rcg_{norm,update}_batch.cu) or raises.
"""

from __future__ import annotations

import torch

from .rcg_kernels import F64, _block_rows, _grid, _on_cpu, _raise_on, masked_softmax

# matrix dtype (= compute dtype) -> suffix of the C entry points.
INSTANTIATIONS = {torch.float32: "f32_f32", torch.float64: "f64_f64"}

# Cap on the (n_cta, B, G) float64 column partials of K4: past it the grid
# shrinks (only at B * G beyond ~250k at the usual grid).
PART_BYTES = 1 << 30


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the reference for the kernels)
# ---------------------------------------------------------------------------


def _replicate_operands(logL, mats, scalars):
    """(B, 1, G) matrices and (B, 1, 1) scalars in logL's dtype, for
    broadcasting against (rows, G) blocks."""
    cd = logL.dtype
    return ([m.to(cd)[:, None, :] for m in mats],
            [s.to(cd)[:, None, None] for s in scalars])


def rcg_norm_batch_plain(logL, countsT, psi, c, v):
    """Plain K3: the (B,) float64 norms at gamma_b = (c_b, v_b)."""
    rcg_norm_batch_plain.launches += 1
    E, G = logL.shape
    B = countsT.shape[1]
    (psi, v), (c,) = _replicate_operands(logL, (psi, v), (c,))
    total = torch.zeros((B,), dtype=F64, device=logL.device)
    rows = _block_rows(B * G)
    for lo in range(0, E, rows):
        L = logL[lo:lo + rows]
        cnt = countsT[lo:lo + rows].T[:, :, None]  # (B, rows, 1)
        t = L + psi
        m1 = t.amax(dim=-1, keepdim=True)
        lse1 = m1 + torch.log(torch.exp(t - m1).sum(dim=-1, keepdim=True))
        gamma, num, denom = masked_softmax(L, L, c, v)
        w = cnt * (num / denom)
        s = (t - lse1) - gamma
        total = total + (w * s * s).sum(dim=-1).to(F64).sum(dim=-1)
    return total


rcg_norm_batch_plain.launches = 0


def rcg_update_batch_plain(logL, countsT, c_old, v_old, c_new, v_new):
    """Plain K4: (colsum (B, G), scalar (B,)), both float64; the scalar is
    sum_e (row_new - row_old), or sum_e row_new with c_old None."""
    rcg_update_batch_plain.launches += 1
    E, G = logL.shape
    B = countsT.shape[1]
    absolute = c_old is None
    (v_new,), (c_new,) = _replicate_operands(logL, (v_new,), (c_new,))
    if not absolute:
        (v_old,), (c_old,) = _replicate_operands(logL, (v_old,), (c_old,))
    colsum = torch.zeros((B, G), dtype=F64, device=logL.device)
    total = torch.zeros((B,), dtype=F64, device=logL.device)
    rows = _block_rows(B * G)
    for lo in range(0, E, rows):
        L = logL[lo:lo + rows]
        cnt = countsT[lo:lo + rows].T[:, :, None]
        g_new, num, denom = masked_softmax(L, L, c_new, v_new)
        w_new = cnt * (num / denom)
        row = (w_new * (L - g_new)).sum(dim=-1)
        if not absolute:
            g_old, num_o, den_o = masked_softmax(L, L, c_old, v_old)
            row = row - (cnt * (num_o / den_o) * (L - g_old)).sum(dim=-1)
        colsum = colsum + w_new.to(F64).sum(dim=1)
        total = total + row.to(F64).sum(dim=-1)
    return colsum, total


rcg_update_batch_plain.launches = 0


# ---------------------------------------------------------------------------
# Kernel launches (CUDA tensors)
# ---------------------------------------------------------------------------


def _check_batch_inputs(logL, countsT, mats, scalars):
    if logL.dtype not in INSTANTIATIONS:
        raise TypeError(f"no batched rcg kernel for matrix {logL.dtype}")
    if logL.dim() != 2 or not logL.is_contiguous():
        raise ValueError("logL must be a contiguous (E, G) matrix")
    E, G = logL.shape
    if (countsT.dim() != 2 or countsT.shape[0] != E or countsT.shape[1] < 1
            or countsT.dtype != logL.dtype or countsT.device != logL.device):
        raise ValueError(f"countsT must be ({E}, B >= 1) {logL.dtype} on {logL.device}")
    B = countsT.shape[1]
    out = [countsT.contiguous()]
    for x, shape in [(m, (B, G)) for m in mats] + [(s, (B,)) for s in scalars]:
        if tuple(x.shape) != shape or x.device != logL.device:
            raise ValueError(f"replicate operands must be {shape} on {logL.device}")
        out.append(x.to(logL.dtype).contiguous())
    return INSTANTIATIONS[logL.dtype], out


def rcg_norm_batch_kernel(logL, countsT, psi, c, v):
    """K3 on the card (msweep_tpu_torch/csrc/rcg_norm_batch.cu)."""
    from ._build import load

    suffix, (countsT, psi, v, c) = _check_batch_inputs(logL, countsT, (psi, v), (c,))
    E, G = logL.shape
    B = countsT.shape[1]
    dev = logL.device
    rows_per_cta, n_cta = _grid(E, dev)
    part = torch.empty((n_cta, B), dtype=F64, device=dev)
    out = torch.empty((B,), dtype=F64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(load(), f"rcg_norm_batch_{suffix}")(
            logL.data_ptr(), countsT.data_ptr(), psi.data_ptr(), c.data_ptr(), v.data_ptr(),
            E, G, B, rows_per_cta, n_cta, part.data_ptr(), out.data_ptr(), stream,
        )
    _raise_on(rc, "rcg_norm_batch")
    rcg_norm_batch_kernel.launches += 1
    return out


rcg_norm_batch_kernel.launches = 0


def rcg_update_batch_kernel(logL, countsT, c_old, v_old, c_new, v_new):
    """K4 on the card (msweep_tpu_torch/csrc/rcg_update_batch.cu); c_old
    None selects the absolute mode."""
    from ._build import load

    absolute = c_old is None
    if absolute:
        c_old, v_old = c_new, v_new  # not read by the kernel
    suffix, (countsT, v_old, v_new, c_old, c_new) = _check_batch_inputs(
        logL, countsT, (v_old, v_new), (c_old, c_new)
    )
    E, G = logL.shape
    B = countsT.shape[1]
    dev = logL.device
    rows_per_cta, n_cta = _grid(E, dev, max_cta=max(1, PART_BYTES // (8 * B * G)))
    part_s = torch.empty((n_cta, B), dtype=F64, device=dev)
    part_c = torch.empty((n_cta, B, G), dtype=F64, device=dev)
    out_s = torch.empty((B,), dtype=F64, device=dev)
    out_c = torch.empty((B, G), dtype=F64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(load(), f"rcg_update_batch_{suffix}")(
            logL.data_ptr(), countsT.data_ptr(), c_old.data_ptr(), v_old.data_ptr(),
            c_new.data_ptr(), v_new.data_ptr(), int(absolute), E, G, B, rows_per_cta, n_cta,
            part_s.data_ptr(), part_c.data_ptr(), out_s.data_ptr(), out_c.data_ptr(), stream,
        )
    _raise_on(rc, "rcg_update_batch")
    rcg_update_batch_kernel.launches += 1
    return out_c, out_s


rcg_update_batch_kernel.launches = 0


# ---------------------------------------------------------------------------
# The passes the batched optimizer calls
# ---------------------------------------------------------------------------


def rcg_norm_batch(logL, countsT, psi, c, v):
    """Batched pass 1: the (B,) float64 norms.  logL (E, G); countsT
    (E, B) in logL's dtype; psi and v (B, G); c (B,) tensor."""
    if _on_cpu(logL):
        return rcg_norm_batch_plain(logL, countsT, psi, c, v)
    return rcg_norm_batch_kernel(logL, countsT, psi, c, v)


def rcg_update_batch(logL, countsT, c_old, v_old, c_new, v_new):
    """Batched pass 2: (colsum (B, G), ELBO data-term change (B,)),
    float64; c_old None gives the data term itself (absolute mode)."""
    if _on_cpu(logL):
        return rcg_update_batch_plain(logL, countsT, c_old, v_old, c_new, v_new)
    return rcg_update_batch_kernel(logL, countsT, c_old, v_old, c_new, v_new)
