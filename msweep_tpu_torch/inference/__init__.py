"""Inference engine of the port: the rcg optimizer on torch tensors
(counterpart of msweep_tpu/inference/__init__.py)."""

from .mixture import bound_const, mixture_components
from .pack import DeviceProblem, pack_problem, problem_from_numpy
from .rcg import fit_rcg_result
from .result import FitResult

__all__ = [
    "DeviceProblem",
    "FitResult",
    "bound_const",
    "fit_rcg_result",
    "fit_result",
    "mixture_components",
    "pack_problem",
    "pick_impl",
    "problem_from_numpy",
]

_ALGORITHMS = {"rcg": "rcg", "rcgcpu": "rcg", "rcggpu": "rcg", "emgpu": "em"}


def pick_impl(problem: DeviceProblem) -> str:
    """"cuda" (the hand-written kernels) when logL is on a CUDA device,
    "torch" (the plain PyTorch passes) on the CPU."""
    return "cuda" if problem.logL.is_cuda else "torch"


def fit_result(problem: DeviceProblem, algorithm: str = "rcg", *, tol: float = 1e-6,
               max_iters: int = 5000, verbose: bool = False, log=None,
               refine: bool = True) -> FitResult:
    """Dispatch like the reference's rcg_optl wrapper: rcgcpu and rcggpu
    are both the rcg optimizer on the problem's device.  `refine` controls
    the precision escalation past the float32 floor.  `log`, if given,
    receives one line naming the implementation."""
    name = _ALGORITHMS.get(algorithm)
    if name is None:
        raise ValueError(f"unknown algorithm {algorithm}")
    if name == "em":
        raise NotImplementedError(
            f"--algorithm {algorithm} is not yet ported to PyTorch/CUDA, see ROADMAP.md"
        )
    if log is not None:
        log(f"  {name} optimizer: impl={pick_impl(problem)} dtype={problem.logL.dtype}")
    return fit_rcg_result(problem, tol=tol, max_iters=max_iters, verbose=verbose,
                          refine=refine)
