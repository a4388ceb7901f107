"""Per-kernel timing on the card: where does the rcg iteration go?
(counterpart of tools/prof_kernels.py)

    python -m msweep_tpu_torch.prof_kernels [--backend cuda|cpu]

Environment: E (default 2^19), G (512), REPS (20) and WHICH, a
comma-separated choice of rows (default all):

  dispatch        a tiny op, synchronised after every call (ms/call)
  dispatch_async  the same, synchronised once at the end
  copy            T1, the read ceiling of the one-warp-per-row layout
  exp             T2: read + one exp sweep + row logsumexp
  exp2            T3: read + two exp sweeps
  norm            K1, rcg pass 1 (ops/rcg_kernels.rcg_norm)
  update          K2, rcg pass 2 (ops/rcg_kernels.rcg_update)
  full            implicit rcg iterations through inference/rcg._rcg_chunk:
                  one chunk of REPS iterations, enqueued with no host sync

T1-T3 (ops/prof_kernels.py) read the matrix once and do zero, one or two
exps per cell, so their times against K1's and K2's (which do two exps per
cell) say how far those kernels are from a read with the same exps.  Each row reports ms,
GB/s of the matrix (float32, `traffics` reads of it) and G cells/s, and is
flagged INVALID when the rate is above the card's HBM roofline, which is
known for the cards in ROOFLINE_GBPS; for another card the roofline is
reported unknown and nothing is flagged.

Timing on CUDA: one warm-up, then REPS launches between two CUDA events.
The T1-T3 reps are chained through the device: each reads its scalar s by
pointer from the previous rep's out[0], and the kernel folds it in
(s * 1e-30), so no rep can start before the last has finished.  K1 and K2
take their scalars by pointer (0-d tensors on the card, as the optimizer
passes them) and are timed back to back on one stream.  The `full` and
dispatch rows use the host clock, ended by a synchronise.

`--backend cpu` runs the plain PyTorch versions, with host times; it
exists so the tests can run every row without a card.  The inputs are
drawn from a seeded torch.Generator on the device.  Prints one row per
chosen row, then a `launches` line (JSON) with each kernel's and plain
version's launch count.  On the card it fails if anything imported JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .device import resolve_device
from .inference import rcg as R
from .inference.mixture import bound_const
from .inference.pack import DeviceProblem
from .ops import prof_kernels as KP
from .ops import rcg_kernels as K

ALL_ROWS = "dispatch,dispatch_async,copy,exp,exp2,norm,update,full"

# Published HBM bandwidth by torch.cuda.get_device_name() (NVIDIA's data sheets).
ROOFLINE_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}

# The line each row prints first.
ROW_LABELS = {
    "dispatch": "dispatch sync-each",
    "dispatch_async": "dispatch async-chain",
    "copy": "read (T1)",
    "exp": "exp1+lse (T2)",
    "exp2": "exp2+2lse (T3)",
    "norm": "rcg_norm (K1, pass 1)",
    "update": "rcg_update (K2, pass 2)",
    "full": "full implicit step (one chunk)",
}

COUNTERS = (KP.prof_read_kernel, KP.prof_exp_kernel, KP.prof_exp2_kernel, K.rcg_norm_kernel,
            K.rcg_update_kernel, KP.prof_read_plain, KP.prof_exp_plain, KP.prof_exp2_plain,
            K.rcg_norm_plain, K.rcg_update_plain)


class Profiler:
    def __init__(self, device: torch.device, E: int, G: int, reps: int):
        self.device, self.E, self.G, self.reps = device, E, G, reps
        self.cuda = device.type == "cuda"
        self.roofline = None
        if self.cuda:
            self.roofline = ROOFLINE_GBPS.get(torch.cuda.get_device_name(device))
        g = torch.Generator(device=device).manual_seed(0)
        self.logL = torch.log_softmax(
            torch.randn(E, G, generator=g, device=device, dtype=torch.float32) * 4.0, dim=1)
        self.counts = torch.ones(E, dtype=torch.float32, device=device)
        self.zeros = torch.zeros(G, dtype=torch.float64, device=device)
        self.half = torch.full((), 0.5, dtype=torch.float64, device=device)
        self.one = torch.ones((), dtype=torch.float64, device=device)

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def report(self, key: str, ms: float, traffics: int) -> None:
        gbps = traffics * self.logL.numel() * 4 / 1e9 / (ms / 1e3)
        flag = ""
        if self.roofline is not None and gbps > self.roofline:
            flag = "  << INVALID: above HBM roofline, instrumentation failure"
        print(f"{ROW_LABELS[key]:40s} {ms:9.4f} ms  {gbps:8.1f} GB/s   ({traffics} traffics, "
              f"{self.E * self.G / (ms / 1e3) / 1e9:.1f} G cells/s){flag}", flush=True)

    def _time(self, step, x0):
        """ms per call of x = step(x) over REPS calls after one warm-up:
        CUDA events on the card, the host clock on the CPU."""
        step(x0)
        self._sync()
        if not self.cuda:
            t = time.perf_counter()
            x = x0
            for _ in range(self.reps):
                x = step(x)
            return (time.perf_counter() - t) * 1e3 / self.reps
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        x = x0
        start.record()
        for _ in range(self.reps):
            x = step(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / self.reps

    def dispatch(self, sync_each: bool) -> None:
        x = torch.zeros((8, 128), dtype=torch.float32, device=self.device)
        x = x + 1.0
        self._sync()
        t = time.perf_counter()
        for _ in range(self.reps * 5):
            x = x + 1.0
            if sync_each:
                self._sync()
        self._sync()
        ms = (time.perf_counter() - t) * 1e3 / (self.reps * 5)
        key = "dispatch" if sync_each else "dispatch_async"
        print(f"{ROW_LABELS[key]:40s} {ms:9.4f} ms/call", flush=True)

    def sweep(self, key: str, fn) -> None:
        """T1-T3, each rep reading s from the previous rep's out[0]."""
        s0 = torch.zeros(1, dtype=torch.float32, device=self.device)
        self.report(key, self._time(lambda s: fn(self.logL, s)[:1], s0), 1)

    def norm(self) -> None:
        def step(_):
            return K.rcg_norm(self.logL, self.counts, self.zeros, self.one, self.zeros,
                              compute_dtype=torch.float32)

        self.report("norm", self._time(step, None), 1)

    def update(self) -> None:
        def step(_):
            return K.rcg_update(self.logL, self.counts, self.half, self.zeros, self.one,
                                self.zeros, compute_dtype=torch.float32)

        self.report("update", self._time(step, None), 1)

    def full(self) -> None:
        E, G = self.E, self.G
        prob = DeviceProblem(
            shards=[(self.logL, self.counts)], rows=[(0, E)],
            alpha=torch.ones(G, dtype=torch.float64, device=self.device),
            valid=torch.ones(G, dtype=torch.bool, device=self.device), n_ecs=E, n_groups=G,
            bound_const=bound_const(np.ones(E), np.ones(G)),
        )

        def run():
            st = R._rcg_init_implicit(prob)
            self._sync()
            t = time.perf_counter()
            R._rcg_chunk(st, prob, length=self.reps, tol=-1.0, compute_dtype=torch.float32)
            self._sync()
            return (time.perf_counter() - t) * 1e3 / self.reps

        run()
        self.report("full", run(), 2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m msweep_tpu_torch.prof_kernels",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu (plain versions)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.backend)
    except (RuntimeError, ValueError) as e:
        print(f"{type(e).__name__}: {e}", file=sys.stderr)
        return 1
    E = int(os.environ.get("E", 1 << 19))
    G = int(os.environ.get("G", 512))
    reps = int(os.environ.get("REPS", 20))
    which = [w for w in os.environ.get("WHICH", ALL_ROWS).split(",") if w]
    unknown = sorted(set(which) - set(ROW_LABELS))
    if unknown:
        print(f"unknown WHICH rows {unknown}; expected some of {ALL_ROWS}", file=sys.stderr)
        return 1

    prof = Profiler(device, E, G, reps)
    name = torch.cuda.get_device_name(device) if prof.cuda else "cpu (plain versions, host times)"
    roof = (f"{prof.roofline:.0f} GB/s" if prof.roofline is not None
            else "unknown (no row is flagged)")
    print(f"device={name} E={E} G={G} reps={reps} roofline={roof}", flush=True)
    for fn in COUNTERS:
        fn.launches = 0
    rows = {
        "dispatch": lambda: prof.dispatch(True),
        "dispatch_async": lambda: prof.dispatch(False),
        "copy": lambda: prof.sweep("copy", KP.prof_read),
        "exp": lambda: prof.sweep("exp", KP.prof_exp),
        "exp2": lambda: prof.sweep("exp2", KP.prof_exp2),
        "norm": prof.norm,
        "update": prof.update,
        "full": prof.full,
    }
    for key in which:
        rows[key]()
    print("launches " + json.dumps({fn.__name__: fn.launches for fn in COUNTERS}), flush=True)
    # The card's run must not have pulled JAX in; the CPU mode runs inside
    # the parity tests' processes, which import it themselves.
    if prof.cuda and "jax" in sys.modules:
        print("jax was imported", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
