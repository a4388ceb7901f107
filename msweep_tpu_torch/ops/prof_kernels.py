"""The profiler's three sweeps T1-T3: kernels and plain versions.

On a float32 (E, G) matrix x and a scalar s (a one-element float32 tensor
on x's device, which the kernels read by pointer), each returns one
float32 value per row (msweep_tpu_torch/csrc/prof_sweeps.cu):

- T1 ``prof_read``: sum_g (x + s * 1e-30), the read ceiling;
- T2 ``prof_exp``: logsumexp_g (x + s * 1e-30), one exp sweep;
- T3 ``prof_exp2``: T2 plus logsumexp_g (0.5 x + 2 s), two exp sweeps.

They replace tools/prof_kernels.py _read_kernel, _exp_kernel and
_exp2_kernel, and keep K5's layout (one warp per row in 32-wide strides,
a fixed grid of CTAS_PER_SM CTAs per SM), so that their times against
K1's, K2's and K5's say how far those are from a read with one or two exps
per cell.  Passing a rep's out[:1] as the next rep's s chains the reps
through the device.

Dispatch as in ops/rcg_kernels.py: a CPU tensor takes the plain version,
a CUDA tensor launches the kernel or raises.  Both count their launches in
``launches``.
"""

from __future__ import annotations

import torch

from .rcg_kernels import _grid, _on_cpu, _raise_on

F32 = torch.float32


def prof_read_plain(x, s):
    """Plain T1: (x + s * 1e-30).sum(1)."""
    prof_read_plain.launches += 1
    return (x + s * 1e-30).sum(dim=1)


def prof_exp_plain(x, s):
    """Plain T2: logsumexp over each row of x + s * 1e-30."""
    prof_exp_plain.launches += 1
    return torch.logsumexp(x + s * 1e-30, dim=1)


def prof_exp2_plain(x, s):
    """Plain T3: T2 plus logsumexp over each row of 0.5 x + 2 s."""
    prof_exp2_plain.launches += 1
    return torch.logsumexp(x + s * 1e-30, dim=1) + torch.logsumexp(0.5 * x + s * 2.0, dim=1)


def _launch(name: str, x, s):
    from ._build import load

    if x.dtype != F32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (E, G) float32 matrix")
    if s.numel() != 1 or s.dtype != F32 or s.device != x.device:
        raise ValueError(f"s must be one float32 on {x.device}")
    E, G = x.shape
    rows_per_cta, n_cta = _grid(E, x.device)
    out = torch.empty((E,), dtype=F32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(load(), f"{name}_f32")(x.data_ptr(), s.data_ptr(), E, G, rows_per_cta,
                                           n_cta, out.data_ptr(), stream)
    _raise_on(rc, name)
    return out


def prof_read_kernel(x, s):
    """T1 on the card."""
    out = _launch("prof_read", x, s)
    prof_read_kernel.launches += 1
    return out


def prof_exp_kernel(x, s):
    """T2 on the card."""
    out = _launch("prof_exp", x, s)
    prof_exp_kernel.launches += 1
    return out


def prof_exp2_kernel(x, s):
    """T3 on the card."""
    out = _launch("prof_exp2", x, s)
    prof_exp2_kernel.launches += 1
    return out


for _fn in (prof_read_plain, prof_exp_plain, prof_exp2_plain, prof_read_kernel,
            prof_exp_kernel, prof_exp2_kernel):
    _fn.launches = 0


def prof_read(x, s):
    """T1: (E,) float32 row sums of x + s * 1e-30."""
    return prof_read_plain(x, s) if _on_cpu(x) else prof_read_kernel(x, s)


def prof_exp(x, s):
    """T2: (E,) float32 row logsumexps of x + s * 1e-30."""
    return prof_exp_plain(x, s) if _on_cpu(x) else prof_exp_kernel(x, s)


def prof_exp2(x, s):
    """T3: (E,) float32, T2 plus the row logsumexps of 0.5 x + 2 s."""
    return prof_exp2_plain(x, s) if _on_cpu(x) else prof_exp2_kernel(x, s)
