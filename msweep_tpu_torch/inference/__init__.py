"""Inference engine of the port: the rcg and EM optimizers, the bootstrap
batches and RATE on torch tensors (counterpart of
msweep_tpu/inference/__init__.py)."""

from .em import fit_em, fit_em_batch, fit_em_result
from .mixture import bound_const, mixture_components
from .pack import DeviceProblem, pack_problem, problem_from_numpy
from .rate import dirichlet_kld, dirichlet_kld_from_pseudocounts, rates_from_log_kld
from .rcg import fit_rcg, fit_rcg_batch, fit_rcg_result
from .result import BatchStats, FitResult, FitStats

__all__ = [
    "BatchStats",
    "DeviceProblem",
    "FitResult",
    "FitStats",
    "bound_const",
    "dirichlet_kld",
    "dirichlet_kld_from_pseudocounts",
    "fit",
    "fit_em",
    "fit_em_batch",
    "fit_em_result",
    "fit_rcg",
    "fit_rcg_batch",
    "fit_rcg_result",
    "fit_result",
    "mixture_components",
    "pack_problem",
    "pick_impl",
    "problem_from_numpy",
    "rates_from_log_kld",
]

_ALGORITHMS = {"rcg": "rcg", "rcgcpu": "rcg", "rcggpu": "rcg", "em": "em", "emgpu": "em"}


def algorithm_family(algorithm: str) -> str:
    """"rcg" for rcg, rcgcpu and rcggpu; "em" for em and emgpu."""
    name = _ALGORITHMS.get(algorithm)
    if name is None:
        raise ValueError(f"unknown algorithm {algorithm}")
    return name


def pick_impl(problem: DeviceProblem) -> str:
    """"cuda" (the hand-written kernels) when logL is on a CUDA device,
    "torch" (the plain PyTorch passes) on the CPU."""
    return "cuda" if problem.device.type == "cuda" else "torch"


def fit(problem: DeviceProblem, algorithm: str = "rcg", *, tol: float = 1e-6,
        max_iters: int = 5000, verbose: bool = False, log=None):
    """Dispatch like the reference's rcg_optl wrapper: rcgcpu and rcggpu
    are both the rcg optimizer on the problem's device, emgpu is EM.
    Returns (gamma (E, G) of this process's rows, iterations, objective).
    `log`, if given, receives one line naming the implementation."""
    res = fit_result(problem, algorithm, tol=tol, max_iters=max_iters, verbose=verbose, log=log)
    return res.gamma(), res.n_iters, res.objective


def fit_result(problem: DeviceProblem, algorithm: str = "rcg", *, tol: float = 1e-6,
               max_iters: int = 5000, verbose: bool = False, log=None,
               refine: bool | str = True) -> FitResult:
    """Like fit, but returns a FitResult: theta from the optimizer state,
    gamma built only by .gamma().  `refine` controls rcg's precision
    escalation past the float32 floor (True: blind float32 windows then a
    float64 polish; "exact": the float64 tail alone)."""
    name = algorithm_family(algorithm)
    if log is not None:
        log(f"  {name} optimizer: impl={pick_impl(problem)} dtype={problem.dtype} "
            f"ec_shards={problem.ec_shards}")
    if name == "em":
        return fit_em_result(problem, tol=tol, max_iters=max_iters, verbose=verbose)
    return fit_rcg_result(problem, tol=tol, max_iters=max_iters, verbose=verbose,
                          refine=refine)
