"""The profiler's sweeps T1-T3 (msweep_tpu_torch/ops/prof_kernels.py) and
the profiler itself (msweep_tpu_torch/prof_kernels.py), on the CPU.

The plain T1-T3 are held against the JAX tool's kernel bodies
(tools/prof_kernels.py _read_kernel, _exp_kernel, _exp2_kernel), run by
pl.pallas_call in interpret mode with plain BlockSpecs, on the same seeded
numpy inputs.  Tolerance: float32, rtol 1e-6 (the summation orders
differ) with 1e-6 absolute for the logsumexps of log-probability rows,
which are ~0."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from msweep_tpu_torch import prof_kernels as P
from msweep_tpu_torch.ops import prof_kernels as KP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(64, 32), (37, 33), (129, 512), (5, 1000), (33, 1), (40, 4096)]


@pytest.fixture(scope="module")
def tool():
    """tools/prof_kernels.py, imported at a tiny size with no rows chosen
    (it runs its rows at import)."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in (("E", "64"), ("G", "32"), ("WHICH", "")):
            mp.setenv(k, v)
        spec = importlib.util.spec_from_file_location(
            "prof_kernels_tool", os.path.join(REPO, "tools", "prof_kernels.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


def _inputs(E, G, seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(E, G)) * 4.0
    x = (z - np.log(np.exp(z - z.max(1, keepdims=True)).sum(1, keepdims=True))
         - z.max(1, keepdims=True)).astype(np.float32)
    s = np.float32(rng.normal())
    return x, s


def _pallas(kernel, x, s):
    """One block over the whole (E, G) matrix, interpret mode."""
    E, G = x.shape
    out = pl.pallas_call(
        kernel, grid=(1,),
        in_specs=[pl.BlockSpec((E, G), lambda i: (0, 0)), pl.BlockSpec((1, 1), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((E, 1), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((E, 1), jnp.float32), interpret=True,
    )(jnp.asarray(x), jnp.asarray(s).reshape(1, 1))
    return np.asarray(out)[:, 0]


@pytest.mark.parametrize("E,G", SHAPES)
@pytest.mark.parametrize("name", ["read", "exp", "exp2"])
def test_plain_sweeps_match_jax_kernel_bodies(tool, name, E, G):
    x, s = _inputs(E, G, seed=E + G)
    want = _pallas(getattr(tool, f"_{name}_kernel"), x, s)
    got = getattr(KP, f"prof_{name}")(torch.from_numpy(x), torch.tensor([s]))
    assert got.dtype == torch.float32 and got.shape == (E,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_cpu_tensors_take_the_plain_sweeps():
    x, s = _inputs(16, 8, 0)
    x, s = torch.from_numpy(x), torch.tensor([s])
    before = [(getattr(KP, f"prof_{n}_plain").launches, getattr(KP, f"prof_{n}_kernel").launches)
              for n in ("read", "exp", "exp2")]
    for n in ("read", "exp", "exp2"):
        getattr(KP, f"prof_{n}")(x, s)
    after = [(getattr(KP, f"prof_{n}_plain").launches, getattr(KP, f"prof_{n}_kernel").launches)
             for n in ("read", "exp", "exp2")]
    assert after == [(p + 1, k) for p, k in before]


def test_kernel_wrappers_check_inputs():
    x = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="float32"):
        KP.prof_read_kernel(x.double(), torch.zeros(1))
    with pytest.raises(ValueError, match="one float32"):
        KP.prof_exp_kernel(x, torch.zeros(2))
    with pytest.raises(ValueError, match="cpu or cuda"):
        KP.prof_exp2(x.to("meta"), torch.zeros(1, device="meta"))


def test_profiler_cpu_rows(monkeypatch, capsys):
    """Every row of the JAX tool's WHICH prints, none is flagged, and the
    plain versions carried the rows."""
    for k, v in (("E", "256"), ("G", "64"), ("REPS", "2")):
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("WHICH", raising=False)
    assert P.main(["--backend", "cpu"]) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert "roofline=unknown" in lines[0]
    assert P.ALL_ROWS == "dispatch,dispatch_async,copy,exp,exp2,norm,update,full"
    for key in P.ALL_ROWS.split(","):
        assert sum(ln.startswith(P.ROW_LABELS[key]) for ln in lines) == 1, key
    assert "INVALID" not in out
    launches = json.loads(lines[-1].removeprefix("launches "))
    assert all(launches[f"prof_{n}_plain"] == 3 for n in ("read", "exp", "exp2"))
    assert not any(v for k, v in launches.items() if k.endswith("_kernel"))


def test_profiler_without_gpu_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert P.main([]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err


def test_roofline_flag(capsys):
    """A rate above the card's roofline is flagged INVALID."""
    prof = P.Profiler(torch.device("cpu"), 64, 32, 1)
    prof.roofline = 1.0
    prof.report("copy", 1e-6, 1)
    assert "INVALID" in capsys.readouterr().out


SASS = """
\tcode for sm_90a
\t\tFunction : exp_f64
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;      /* 0x00000a00ff017b82 */
                                                               /* 0x000fe40000000800 */
        /*0010*/                   S2R R6, SR_TID.X ;          /* 0x0000000000067919 */
        /*0020*/                   DFMA R4, R2, UR4, R4 ;      /* 0x0000000402047c2b */
        /*0030*/              @!P0 DADD R4, R2, R2 ;           /* 0x0000000002048229 */
        /*0040*/                   DSETP.GEU.AND P0, PT, |R2|, 708, PT ;
        /*0050*/                   FSETP.GEU.AND P0, PT, |R3|, 4.2275390625, PT ;
        /*0060*/                   EXIT ;
\t\tFunction : exp_f32
        /*0000*/                   FFMA.SAT R0, R2, R3, 0.5 ;
        /*0010*/                   MUFU.EX2 R5, R5 ;
        /*0020*/               @P0 FMUL R5, R0, R5 ;
        /*0030*/                   F2F.F64.F32 R6, R5 ;
        /*0040*/                   BRA 0x40;
"""


def test_exp_cost_counts_sass_by_pipe():
    """exp_cost.count reads cuobjdump -sass output: one tally per function,
    predicated and modified opcodes by their pipe, encodings skipped."""
    from msweep_tpu_torch import exp_cost

    got = exp_cost.count(SASS)
    assert got["exp_f64"] == dict(fp32=1, fp64=3, mufu=0, convert=0, mio=0, int=0, other=3)
    assert got["exp_f32"] == dict(fp32=2, fp64=0, mufu=1, convert=1, mio=0, int=0, other=1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("E,G", SHAPES + [(100_003, 1), (1_000_003, 4), (65_537, 512),
                                          (4_099, 4096)])
def test_sweep_kernels_match_plain(cuda_device, E, G):
    """T1-T3 on the card against their plain versions on the same tensors
    (rtol 1e-5 with 1e-5 absolute: float32 sums in another order), at E
    not a multiple of the tile; a rerun gives the same bits."""
    x, s = _inputs(E, G, 7)
    x, s = torch.from_numpy(x).to(cuda_device), torch.tensor([s], device=cuda_device)
    for n in ("read", "exp", "exp2"):
        got = getattr(KP, f"prof_{n}_kernel")(x, s)
        want = getattr(KP, f"prof_{n}_plain")(x, s)
        again = getattr(KP, f"prof_{n}_kernel")(x, s)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(got, again)
