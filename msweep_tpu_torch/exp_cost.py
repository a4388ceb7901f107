"""Instructions of the kernels on the card, counted in SASS by the pipe
that issues them.

`measure()` builds a probe of two kernels, y[i] = expf(x[i]) and
y[i] = exp(x[i]), with the kernels' own nvcc flags (ops/_build.py: sm_90a,
no fast math, -fmad=false) into a cubin, disassembles it with cuobjdump
-sass and counts each probe's instructions by the pipe that issues them.  Every
floating-point instruction of a probe is the exp's: the rest of it is
integer and memory work.  The count is static, so it takes both the fast
path and the branch for arguments out of range.  chip_smoke.py (phase 2)
counts one exp of a compute type as its instructions on that type's pipe
when it computes the kernels' operations bound.

`census(pattern)` counts a kernel of the built library the same way: its
whole function, and its hot loop (the innermost loop, closed by a
conditional branch back, with the most floating-point instructions), with
the shared-memory bytes that loop's loads and stores move.
`em_batch_issue_ms` turns K6's loop counts into the time each pipe needs
to issue them (chip_smoke.py phase 3): a diagnostic of how well K6 issues
its own instructions, not a bound of its function, since the count holds
the work K6's design adds (its guards, selects, shared-memory traffic).
Both need the CUDA toolkit (nvcc, cuobjdump), not a GPU.
"""

from __future__ import annotations

import os
import re
import subprocess
import tempfile

from .ops import _build

PROBE = r"""
extern "C" __global__ void exp_f32(const float* x, float* y) {
  y[threadIdx.x] = expf(x[threadIdx.x]);
}
extern "C" __global__ void exp_f64(const double* x, double* y) {
  y[threadIdx.x] = exp(x[threadIdx.x]);
}
"""

# Opcodes by issuing pipe; any other opcode counts as "other".  "mio" is
# the memory-input-output queue: shared-memory loads and stores, the copies
# into shared memory (LDGSTS, cp.async) and the warp shuffles.
PIPES = {
    "fp32": ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSET", "FSEL", "FCHK", "FRND"),
    "fp64": ("DADD", "DMUL", "DFMA", "DMNMX", "DSETP", "DSET"),
    "mufu": ("MUFU",),
    "convert": ("F2F", "F2I", "I2F", "F2FP"),
    "mio": ("LDS", "STS", "LDSM", "STSM", "LDGSTS", "SHFL", "ATOMS", "MATCH", "VOTE"),
    "int": ("IADD3", "IADD", "IMAD", "IMUL", "LEA", "LOP3", "LOP", "SHF", "SHL", "SHR", "ISETP",
            "IMNMX", "IABS", "SEL", "PRMT", "POPC", "FLO", "BREV", "BMSK", "VIADD", "VIMNMX"),
}

_FUNCTION = re.compile(r"\s*Function : (\S+)")
_INSTR = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)"
                    r"([^;]*)")
_TARGET = re.compile(r"(0x[0-9a-f]+)\s*$")


def _pipe(op: str) -> str:
    return next((p for p, ops in PIPES.items() if op in ops), "other")


def _functions(sass: str, pattern: str = "") -> dict[str, list[tuple[int, str, str, bool, str]]]:
    """{function: [(address, opcode, modifiers, predicated, operands)]} of
    `cuobjdump -sass` output, for the functions whose name holds
    `pattern`."""
    out: dict[str, list] = {}
    cur = None
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            cur = out.setdefault(m.group(1), []) if pattern in m.group(1) else None
            continue
        m = _INSTR.match(line) if cur is not None else None
        if m:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4), bool(m.group(2)),
                        m.group(5)))
    return out


def _tally(instrs) -> dict[str, int]:
    got = dict.fromkeys((*PIPES, "other"), 0)
    for ins in instrs:
        got[_pipe(ins[1])] += 1
    return got


def count(sass: str) -> dict[str, dict[str, int]]:
    """{function: {pipe: instructions}} of `cuobjdump -sass` output."""
    return {name: _tally(instrs) for name, instrs in _functions(sass).items()}


def shared_bytes(instrs) -> int:
    """Bytes a warp moves through shared memory in `instrs`: 32 lanes of
    each LDS and STS at its width (.64, .128; 4 bytes otherwise)."""
    total = 0
    for _, op, mods, _, _ in instrs:
        if op in ("LDS", "STS"):
            width = 16 if ".128" in mods else 8 if ".64" in mods else 4
            total += 32 * width
    return total


def hot_loop(instrs) -> list:
    """The instructions of the innermost loop (from a conditional branch
    back to its target) with the most floating-point instructions."""
    loops = []
    for addr, op, _, predicated, operands in instrs:
        t = _TARGET.search(operands)
        if op == "BRA" and t and int(t.group(1), 16) < addr and (predicated or "P" in operands):
            loops.append((int(t.group(1), 16), addr))
    inner = [(a, z) for a, z in loops
             if not any((a, z) != (a2, z2) and a <= a2 and z2 <= z for a2, z2 in loops)]
    if not inner:
        raise ValueError("no loop closed by a conditional branch back")

    def body(span):
        return [ins for ins in instrs if span[0] <= ins[0] <= span[1]]

    def fp(span):
        t = _tally(body(span))
        return t["fp32"] + t["fp64"]

    return body(max(inner, key=fp))


def _sass_of(library: str, pattern: str) -> str:
    """`cuobjdump -sass` of the cubins in `library` (one a source) that
    hold `pattern`, taken out with -xelf, so that the other sources'
    kernels are not disassembled; the whole library where no cubin holds
    it."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    with tempfile.TemporaryDirectory() as d:
        subprocess.run([cuobjdump, "-xelf", "all", os.path.abspath(library)], cwd=d,
                       capture_output=True)
        cubins = []
        for name in sorted(os.listdir(d)):
            with open(os.path.join(d, name), "rb") as f:
                if pattern.encode() in f.read():
                    cubins.append(os.path.join(d, name))
        return subprocess.run([cuobjdump, "-sass", *(cubins or [library])], check=True,
                              capture_output=True, text=True).stdout


def census(pattern: str, library: str | None = None) -> dict[str, dict]:
    """{function: {"all": pipes, "loop": pipes of its hot loop,
    "loop_shared_bytes": shared-memory bytes a warp moves in one trip of
    it, "loop_shfl": its shuffles}} for each function of the built kernel
    library (ops/_build.py) whose mangled name holds `pattern`."""
    sass = _sass_of(library or _build.build()[0], pattern)
    out = {}
    for name, instrs in _functions(sass, pattern).items():
        loop = hot_loop(instrs)
        out[name] = {"all": _tally(instrs), "loop": _tally(loop),
                     "loop_shared_bytes": shared_bytes(loop),
                     "loop_shfl": sum(ins[1] == "SHFL" for ins in loop)}
    if not out:
        raise ValueError(f"no function of {library} matches {pattern!r}")
    return out


# Issue rates of an H100 SM (compute capability 9.0; NVIDIA's table of
# arithmetic instruction throughput): results a clock an SM of each
# pipe, and bytes a clock an SM of shared memory.  A shuffle moves 32
# lanes of 4 bytes through the same crossbar.  The clock is the boost
# clock of the H100 SXM, 1,980 MHz.
PIPE_RATE = {"fp32": 128, "fp64": 64, "convert": 16, "mufu": 16}
SHARED_BYTES_PER_CLOCK = 128
SHFL_BYTES = 32 * 4
BOOST_HZ = 1.98e9


def em_batch_issue_ms(E: int, G: int, B: int, lsize: int, csize: int, counted: dict,
                      rows_at_once: int, sms: int, hbm_bytes_per_s: float,
                      clock_hz: float = BOOST_HZ):
    """(ms, the term that binds, {term: ms}): the time one K6 pass over an
    (E, G) matrix of `lsize`-byte cells for B replicates in `csize`-byte
    floats takes to issue its own instructions on the busiest pipe.  It
    counts what K6's SASS does, not what the function needs, so it is no
    bound of the function (chip_smoke.py's bound_ms is): a kernel near it
    issues well and can gain only by doing less.  `counted` is census's
    entry for the one-chunk build: its hot
    loop takes one trip a warp for `rows_at_once` rows of one replicate, so each
    pipe issues loop[pipe] * 32 lanes * E * B / rows_at_once results at
    PIPE_RATE a clock an SM; shared memory moves the loop's bytes and
    SHFL_BYTES a shuffle at SHARED_BYTES_PER_CLOCK, besides each staged
    row's copy in (lsize * G a row for each CTA of up to 8 replicates); and
    device memory moves each input once and each output once.  The
    row-group work outside the loop (the log, the lse and ddot terms, a
    thirty-second of the rows) is not counted."""
    trips = E * B / rows_at_once
    per_sm_clock = sms * clock_hz
    terms = {pipe: counted["loop"][pipe] * 32 * trips / (rate * per_sm_clock) * 1e3
             for pipe, rate in PIPE_RATE.items()}
    shared = (trips * (counted["loop_shared_bytes"] + SHFL_BYTES * counted["loop_shfl"])
              + E * G * lsize * -(-B // 8))
    terms["shared"] = shared / (SHARED_BYTES_PER_CLOCK * per_sm_clock) * 1e3
    moved = E * G * lsize + E * B * lsize + 2 * E * B * csize + B * G * csize + (G + 1) * B * 8 + B
    terms["bytes"] = moved / hbm_bytes_per_s * 1e3
    by = max(terms, key=terms.get)
    return terms[by], by, terms


def measure() -> dict[str, dict[str, int]]:
    """{"float32": pipes of expf, "float64": pipes of exp}, from the SASS
    of the probe built with the kernels' flags."""
    nvcc = _build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as d:
        src, cubin = os.path.join(d, "exp_probe.cu"), os.path.join(d, "exp_probe.cubin")
        with open(src, "w") as f:
            f.write(PROBE)
        subprocess.run([nvcc, *_build.COMPILE_FLAGS, "-cubin", "-o", cubin, src], check=True,
                       capture_output=True, text=True)
        sass = subprocess.run([cuobjdump, "-sass", cubin], check=True, capture_output=True,
                              text=True).stdout
    got = count(sass)
    return {"float32": got["exp_f32"], "float64": got["exp_f64"]}

