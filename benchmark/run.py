"""One run of one benchmark cell on the card.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The last line of standard output is one
JSON object (correct, attempted, failed, metrics, device; with --trace 1
also breakdown; then checks, each number compared beside its limit), and
the last lines of standard error give the same numbers and limits.  The
run exits with 1 and prints no result where CUDA is not available or
has fewer devices than the cell asks for, and where JAX or the JAX
package is loaded in this process once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "msweep_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from .harness import run_cell
    from .spec import Benchmark

    bench = Benchmark()
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA device(s); found {found}",
              file=sys.stderr)
        return 1
    result, checks = run_cell(bench, args.workload, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace), device="cuda", t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 1
    result["device"]["power_limit_w"] = power_limit()
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(result_line(result, checks))
    return 0


def result_line(result: dict, checks) -> str:
    """The run's last line: the result's keys, then `checks` (each number
    compared with its limit) last."""
    line = dict(result)
    line["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return json.dumps(line)


def power_limit():
    """The card's power limit in W from nvidia-smi, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


if __name__ == "__main__":
    sys.exit(main())
