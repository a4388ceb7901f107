"""The benchmark's frozen community generator, in PyTorch on the device.

A copy of the law of ``msweep_tpu_torch.synth.make_community`` and of the
dense zero-inflated beta-binomial likelihood build
(``core/likelihood.py``), rewritten to draw and build on the card from a
``torch.Generator`` in a few large calls.  It is frozen here so that a
change to the program cannot move the benchmark's inputs.

Only the (EC, group, k) hit counts reach the likelihood, so the
generator draws them directly: each EC's source group from a heavy-tailed
mixture over a few present lineages, Binomial hits on its own group and
on each sibling of its cluster (probability ``hit_rate * similarity``),
one thinly hit background group outside the cluster now and then, and a
Zipf-tailed read count.

The community itself is drawn from the configuration's own seed, so every
run of a cell fits the same problem.  Where the configuration's
``order`` is "permuted", the run's ``--seed`` permutes its rows (ECs) and
columns (groups): the inputs differ from seed to seed in order only.
Where it is "fixed", every seed gives the problem in one order: a fit
whose iteration count follows the rounding of its sums (the rcg
optimizer's float32 floor) would otherwise take other work at each seed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

F64 = torch.float64


@dataclass
class Community:
    """The dense problem: logL (E, G) in the configuration's dtype and the
    EC read counts (E,) as float64."""

    logL: torch.Tensor
    counts: torch.Tensor


def _lbeta(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.lgamma(x) + torch.lgamma(y) - torch.lgamma(x + y)


def likelihood_table(group_sizes: torch.Tensor, q: float, e: float,
                     zero_inflation: float) -> torch.Tensor:
    """(G, max size + 1) float64 log-likelihood of k hits in each group:
    column 0 log(zero_inflation), column k the scaled beta-binomial
    log pmf plus log1p(-zero_inflation) (mSWEEP's WOR21 model,
    include/Likelihood.hpp:48-60, 98-104, 198-207).  Entries past a
    group's size are never gathered."""
    n = group_sizes.to(F64)
    mu = n * q
    denom = n - mu + e
    a = (mu / denom)[:, None]
    b = ((n - mu) / denom)[:, None]
    n = n[:, None]
    k = torch.arange(int(group_sizes.max()) + 1, dtype=F64, device=n.device)[None, :]
    log_choose = torch.lgamma(n + 1) - torch.lgamma(k + 1) - torch.lgamma(n - k + 1)
    table = log_choose + _lbeta(k + a, n - k + b) - _lbeta(n + a, b)
    table = table + math.log1p(-zero_inflation)
    table[:, 0] = math.log(zero_inflation)
    return table


def dense_loglik(n_ecs: int, group_sizes: torch.Tensor, trip_e: torch.Tensor,
                 trip_g: torch.Tensor, trip_k: torch.Tensor, *, dtype: torch.dtype,
                 q: float = 0.65, e: float = 0.01, zero_inflation: float = 0.01,
                 row_of=None, col_of=None) -> torch.Tensor:
    """The dense (E, G) matrix in `dtype` from hit-count triplets (k >= 1):
    log(zero_inflation) everywhere, the table's value at each (e, g, k).
    `row_of` and `col_of` (permutations) place EC e in row row_of[e] and
    group g in column col_of[g]."""
    G = len(group_sizes)
    table = likelihood_table(group_sizes, q, e, zero_inflation)
    out = torch.full((n_ecs, G), math.log(zero_inflation), dtype=dtype,
                     device=group_sizes.device)
    rows = trip_e if row_of is None else row_of[trip_e]
    cols = trip_g if col_of is None else col_of[trip_g]
    out.view(-1)[rows * G + cols] = table[trip_g, trip_k].to(dtype)
    return out


def draw_hits(E: int, G: int, gen: torch.Generator, *, cluster_size: int,
              mean_group_size: float, hit_rate: float, similarity: float,
              background_rate: float, count_tail: float, present_frac: float,
              max_count: int):
    """The community's random draws (synth.make_community's law): returns
    (group sizes (G,), triplets (e, g, k) with k >= 1, counts (E,) float64)."""
    if G % cluster_size:
        raise ValueError("G must be a multiple of cluster_size")
    dev = gen.device

    def rand(*shape):
        return torch.rand(shape, generator=gen, dtype=F64, device=dev)

    normal = torch.randn((G,), generator=gen, dtype=F64, device=dev)
    sizes = torch.clamp(torch.exp(math.log(mean_group_size) + 0.6 * normal), min=2.0).long()

    theta = torch._standard_gamma(torch.full((G,), 0.2, dtype=F64, device=dev), generator=gen)
    if present_frac < 1.0:
        n_present = max(2, int(round(G * present_frac)))
        present = torch.randperm(G, generator=gen, device=dev)[:n_present]
        mask = torch.zeros(G, dtype=F64, device=dev)
        mask[present] = 1.0
        theta = theta * mask
    theta = theta / theta.sum()

    src = torch.multinomial(theta, E, replacement=True, generator=gen)
    cluster_of = torch.arange(G, device=dev) // cluster_size
    sib = (cluster_of[src] * cluster_size)[:, None] + torch.arange(cluster_size, device=dev)
    own = sib == src[:, None]
    p = torch.where(own, hit_rate, hit_rate * similarity).to(F64)
    k_sib = torch.binomial(sizes[sib].to(F64), p, generator=gen).long()
    # A read hits its own lineage at least once.
    k_sib = torch.where(own & (k_sib == 0), 1, k_sib)

    bg = torch.randint(G, (E,), generator=gen, device=dev)
    bg_hit = (rand(E) < background_rate) & (cluster_of[bg] != cluster_of[src])
    k_bg = torch.binomial(sizes[bg].to(F64), torch.full((E,), 0.3, dtype=F64, device=dev),
                          generator=gen).long()
    k_bg = torch.where(bg_hit, torch.minimum(k_bg + 1, sizes[bg]), 0)

    # Zipf-tailed read counts: 1 + floor(Lomax(count_tail)).
    lomax = torch.expm1(-torch.log1p(-rand(E)) / count_tail)
    counts = torch.clamp(1.0 + torch.floor(lomax), max=float(max_count))

    ecs = torch.arange(E, device=dev)
    trip_e = torch.cat([ecs.repeat_interleave(cluster_size), ecs])
    trip_g = torch.cat([sib.reshape(-1), bg])
    trip_k = torch.cat([k_sib.reshape(-1), k_bg])
    keep = trip_k > 0
    return sizes, trip_e[keep], trip_g[keep], trip_k[keep], counts


def make_community(config: dict, seed: int, device, permute: bool | None = None) -> Community:
    """The configuration's community on `device`, in its order for
    `seed`: drawn from config["community"]["seed"], then, where
    config["order"] is "permuted" (or `permute` is set), rows and columns
    permuted by a generator seeded with `seed`."""
    law = dict(config["community"])
    E, G = config["n_ecs"], config["n_groups"]
    dtype = {"float32": torch.float32, "float64": torch.float64}[config["matrix_dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(law.pop("seed")))
    sizes, te, tg, tk, counts = draw_hits(E, G, gen, **law)
    if permute is None:
        permute = {"permuted": True, "fixed": False}[config["order"]]
    row_of = col_of = None
    if permute:
        order = torch.Generator(device=device)
        order.manual_seed(int(seed) % (1 << 63))
        row_of = torch.randperm(E, generator=order, device=device)
        col_of = torch.randperm(G, generator=order, device=device)
    lik = config["likelihood"]
    logL = dense_loglik(E, sizes, te, tg, tk, dtype=dtype, q=lik["q"], e=lik["e"],
                        zero_inflation=lik["zero_inflation"], row_of=row_of, col_of=col_of)
    if permute:
        placed = torch.empty_like(counts)
        placed[row_of] = counts
        counts = placed
    return Community(logL=logL, counts=counts)
