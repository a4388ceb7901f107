"""Native array checkpoint of the built likelihood problem.

The reference's only "checkpoint" is the likelihood TSV
(--write-likelihood + --read-likelihood, src/mSWEEP.cpp:356-380); we
keep that format for interop (core/likelihood.py) and add this compact
npz checkpoint (SURVEY.md section 7) holding the dense matrix, EC counts,
group metadata and the --min-hits mask — resuming from it skips
alignment ingestion AND the likelihood build, and unlike the TSV it
round-trips at full float precision.

CLI: `--write-checkpoint x.npz` / `--read-checkpoint x.npz`
(msweep-tpu extensions).
"""

from __future__ import annotations

import numpy as np

FORMAT_VERSION = 1


def save_checkpoint(path: str, lik, group_names: list[str]) -> None:
    from ..core.likelihood import Likelihood

    assert isinstance(lik, Likelihood)
    np.savez_compressed(
        path,
        format_version=np.int64(FORMAT_VERSION),
        dense=lik.dense(np.float64),
        ec_counts=lik.ec_counts,
        groups_mask=lik.groups_mask,
        group_sizes=lik.group_sizes,
        n_groups_total=np.int64(lik.n_groups_total),
        zero_inflation=np.float64(lik.zero_inflation),
        group_names=np.array(group_names, dtype=object),
    )


def load_checkpoint(path: str):
    """Returns (Likelihood, group_names)."""
    from ..core.likelihood import Likelihood

    with np.load(path, allow_pickle=True) as z:
        ver = int(z["format_version"])
        if ver > FORMAT_VERSION:
            raise ValueError(f"checkpoint format {ver} is newer than supported {FORMAT_VERSION}")
        dense = z["dense"]
        lik = Likelihood(
            n_ecs=dense.shape[0],
            n_groups_total=int(z["n_groups_total"]),
            groups_mask=z["groups_mask"],
            group_sizes=z["group_sizes"],
            ec_counts=z["ec_counts"],
            zero_inflation=float(z["zero_inflation"]),
            _dense=dense,
        )
        names = [str(s) for s in z["group_names"]]
    return lik, names
