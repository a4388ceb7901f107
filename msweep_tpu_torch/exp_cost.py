"""Instructions of one correctly rounded exp on the card, counted in SASS.

`measure()` builds a probe of two kernels, y[i] = expf(x[i]) and
y[i] = exp(x[i]), with the kernels' own nvcc flags (ops/_build.py: sm_90a,
no fast math, -fmad=false) into a cubin, disassembles it with cuobjdump
-sass and counts each probe's instructions by the pipe that issues them.  Every
floating-point instruction of a probe is the exp's: the rest of it is
integer and memory work.  The count is static, so it takes both the fast
path and the branch for arguments out of range.

chip_smoke.py (phase 2) counts one exp of a compute type as its
instructions on that type's pipe when it computes the kernels' operations
bound.  Needs the CUDA toolkit (nvcc, cuobjdump), not a GPU.
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

# Opcodes by issuing pipe; any other opcode counts as "other".
PIPES = {
    "fp32": ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSET", "FSEL", "FCHK", "FRND"),
    "fp64": ("DADD", "DMUL", "DFMA", "DMNMX", "DSETP", "DSET"),
    "mufu": ("MUFU",),
    "convert": ("F2F", "F2I", "I2F", "F2FP"),
}

_FUNCTION = re.compile(r"\s*Function : (\S+)")
_INSTR = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


def count(sass: str) -> dict[str, dict[str, int]]:
    """{function: {pipe: instructions}} of `cuobjdump -sass` output."""
    out: dict[str, dict[str, int]] = {}
    cur = None
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            cur = out.setdefault(m.group(1), dict.fromkeys((*PIPES, "other"), 0))
            continue
        m = _INSTR.match(line)
        if m and cur is not None:
            op = m.group(1)
            cur[next((p for p, ops in PIPES.items() if op in ops), "other")] += 1
    return out


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

