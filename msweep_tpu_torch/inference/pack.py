"""Device packing: put the likelihood problem on the device
(counterpart of msweep_tpu/inference/pack.py).

The matrix keeps its logical (E, G) shape: the kernels handle a ragged E
and any G, so there is no lane or sublane padding and no shape bucketing.
Problems padded the JAX package's way are still handled (the parity tests
feed them): cells with logL <= PAD_THRESHOLD keep logL in every pass, so
their weight is 0; padded rows carry count 0; padded alpha 1 adds
lgamma(1) = 0 to the bound.

EC-axis sharding: the rows are cut into contiguous ranges, one per shard,
as even as E allows (the first E % n ranges get one row more; with fewer
rows than shards the last ranges are empty, and their passes add zero
partials, so any E fits on any number of devices or processes).  In a
distributed run (a torch.distributed process group is up) process r of R
takes the r-th of R ranges and cuts it again over its own devices.  A
pass runs its kernel on every shard of the process and sums the O(G)
partials with DeviceProblem.reduce; the O(G) state is replicated on every
process, the per-row state (EM's lse, the bootstrap's counts) stays with
its shard.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..core.likelihood import Likelihood
from ..device import resolve_device
from ..parallel.mesh import all_reduce_sum, process_group_up, rank_and_size
from ..utils import PAD_THRESHOLD
from .mixture import bound_const as _bound_const


@dataclass
class DeviceProblem:
    """Device-resident inference inputs: this process's rows of the
    (E, G) problem, as one shard or several."""

    shards: list  # [(logL (E_s, G), counts (E_s,) in logL's dtype)], in row order
    rows: list  # [(lo, hi)]: each shard's rows in the global row numbering
    alpha: torch.Tensor  # (G,) Dirichlet prior counts, float64, on the first shard's device
    valid: torch.Tensor  # (G,) bool: real groups, read off global row 0 (padded columns are NEG)
    n_ecs: int  # global logical E
    n_groups: int  # logical G
    bound_const: float  # constant ELBO terms (see mixture.bound_const)
    distributed: bool = False  # reduce() all-reduces over the process group
    ec_shards: int = 1  # shards over every process

    @property
    def device(self) -> torch.device:
        return self.shards[0][0].device

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0][0].dtype

    @property
    def logL(self) -> torch.Tensor:
        """The (E, G) matrix of an unsharded problem."""
        return self._single()[0]

    @property
    def counts(self) -> torch.Tensor:
        """The (E,) counts of an unsharded problem."""
        return self._single()[1]

    def _single(self):
        if len(self.shards) != 1:
            raise ValueError(f"this problem has {len(self.shards)} shards; use .shards")
        return self.shards[0]

    def split(self, x) -> list:
        """This process's shards of a global row vector or batch: the
        slices of x's last axis (E) for each shard, on its device, in its
        dtype."""
        x = torch.as_tensor(x)
        if x.shape[-1] != self.n_ecs:
            raise ValueError(f"expected {self.n_ecs} rows on the last axis, got {x.shape[-1]}")
        return [x[..., lo:hi].to(device=L.device, dtype=L.dtype)
                for (lo, hi), (L, _) in zip(self.rows, self.shards)]

    def with_counts(self, counts) -> DeviceProblem:
        """The problem over another (E,) count vector, e.g. a bootstrap
        replicate: views of the same logL, each shard with its rows of
        `counts`.  bound_const is kept, as the JAX package's fits keep
        problem.bound_const whatever their counts; None returns self."""
        if counts is None:
            return self
        return replace(self, shards=[(L, c) for (L, _), c in zip(self.shards, self.split(counts))])

    def reduce(self, parts: list) -> list:
        """Sums of per-shard partials: parts holds, for each shard, a tuple
        of float64 tensors (scalars, (G,) or (B, G) sums over its rows).
        They are added in shard order on the first shard's device, then
        all-reduced across the processes of a distributed run, so every
        process reads the same values."""
        dev = self.device
        total = [t.to(dev) for t in parts[0]]
        for part in parts[1:]:
            total = [a + b.to(dev) for a, b in zip(total, part)]
        return all_reduce_sum(total) if self.distributed else total

    def row_sum(self, parts: list) -> torch.Tensor:
        """The float64 sum over every row of the problem of per-shard
        (E_s, ...) tensors, e.g. the counts, or each replicate's counts."""
        return self.reduce([(p.to(torch.float64).sum(dim=0),) for p in parts])[0]

    def cat(self, parts: list) -> torch.Tensor:
        """Per-shard row blocks as one tensor of this process's rows, on
        the first shard's device."""
        if len(parts) == 1:
            return parts[0]
        return torch.cat([p.to(self.device) for p in parts])


def split_rows(E: int, n: int) -> list:
    """n contiguous ranges [lo, hi) covering range(E), the first E % n one
    row longer than the others (empty ones when E < n)."""
    q, r = divmod(E, n)
    bounds = np.cumsum([0] + [q + (i < r) for i in range(n)]).tolist()
    return list(zip(bounds[:-1], bounds[1:]))


def _place(logL: np.ndarray, counts: np.ndarray, alpha: np.ndarray, bc: float,
           devices) -> DeviceProblem:
    """This process's rows of a host problem onto `devices`, one shard per
    entry (an entry may repeat: shards on one device are views of one
    copy, so sharding there costs no memory)."""
    E, G = logL.shape
    devices = [torch.device(d) for d in devices]
    rank, world = rank_and_size()
    lo, hi = split_rows(E, world)[rank]
    rows = [(lo + a, lo + b) for a, b in split_rows(hi - lo, len(devices))]
    if all(d == devices[0] for d in devices):
        L = torch.from_numpy(logL[lo:hi]).to(devices[0])
        c = torch.from_numpy(counts[lo:hi]).to(devices[0])
        shards = [(L.narrow(0, a - lo, b - a), c.narrow(0, a - lo, b - a)) for a, b in rows]
    else:
        shards = [(torch.from_numpy(logL[a:b]).to(d), torch.from_numpy(counts[a:b]).to(d))
                  for (a, b), d in zip(rows, devices)]
    valid = logL[0] > PAD_THRESHOLD if E else np.ones(G, dtype=bool)
    distributed = process_group_up()
    n_shards = len(devices)
    if distributed:
        n_shards = all_reduce_sum([torch.tensor([n_shards], dtype=torch.float64,
                                                device=devices[0])])[0]
    return DeviceProblem(
        shards=shards, rows=rows,
        alpha=torch.from_numpy(alpha).to(devices[0]),
        valid=torch.from_numpy(valid).to(devices[0]),
        n_ecs=E, n_groups=G, bound_const=float(bc), distributed=distributed,
        ec_shards=int(n_shards),
    )


def pack_problem(
    lik: Likelihood,
    alpha: np.ndarray | None = None,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str | None = None,
    devices=None,
    counts: np.ndarray | None = None,
) -> DeviceProblem:
    """Copy a host Likelihood to `device`, or shard its rows over
    `devices` (a list that may name one device several times).

    `device` is the card unless the caller names the CPU ("cpu"); with no
    GPU present the default raises, as --backend cuda does.  `alpha` is the
    --alphas prior (default all 1.0).  `counts` overrides the EC counts
    (a bootstrap replicate), and bound_const is then theirs.  The dense
    matrix is built once on the host in `dtype` (whole, in every process of
    a distributed run), and each process copies its own rows to the device
    once."""
    E, G = lik.n_ecs, lik.n_groups
    if alpha is None:
        alpha = np.ones(G, dtype=np.float64)
    alpha = np.asarray(alpha, dtype=np.float64)
    if len(alpha) != G:
        raise ValueError("--alphas must have the same number of values as there are groups")
    counts = np.asarray(lik.ec_counts if counts is None else counts, dtype=np.float64)
    if len(counts) != E:
        raise ValueError(f"counts has {len(counts)} values for {E} equivalence classes")

    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    return _place(lik.dense(dtype=np_dtype), counts.astype(np_dtype), alpha,
                  _bound_const(counts, alpha), devices or [resolve_device(device)])


def problem_from_numpy(logL, counts, alpha, bc: float, device) -> DeviceProblem:
    """A DeviceProblem from numpy arrays as given (e.g. a JAX-padded
    problem): logL keeps its dtype, counts take logL's dtype, alpha is
    float64."""
    logL = np.ascontiguousarray(logL)
    return _place(logL, np.asarray(counts, dtype=logL.dtype).copy(),
                  np.asarray(alpha, dtype=np.float64).copy(), bc, [device])


def auto_chunk(problem: DeviceProblem) -> int:
    """Iterations between host convergence checks: 16 for small problems
    (limits overshoot past convergence), 64 once the global matrix is
    large.  The chunk also sets the escalation tail's supervision windows,
    and with them the iteration counts, so the rule is the JAX package's
    and reads the global E, never a shard's."""
    return 64 if problem.n_ecs * problem.n_groups >= (1 << 27) else 16
