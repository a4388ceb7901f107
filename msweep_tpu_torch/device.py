"""The torch.device a run asks for with --backend, or a library caller
with pack_problem's `device`."""

from __future__ import annotations

import torch


def resolve_device(backend: str | torch.device | None) -> torch.device:
    """"cuda" (the default, also "gpu" and "cuda:N") or "cpu".

    Raises when a GPU is asked for and none is present: a run never moves
    to the CPU on its own."""
    name, _, index = str(backend or "cuda").lower().partition(":")
    if name in ("cuda", "gpu"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--backend {name} needs a CUDA device, and none is available; "
                "pass --backend cpu to run on the CPU"
            )
        return torch.device("cuda", int(index)) if index else torch.device("cuda")
    if name == "cpu" and not index:
        return torch.device("cpu")
    raise ValueError(f"unknown --backend {backend!r}: expected cuda, gpu or cpu")
