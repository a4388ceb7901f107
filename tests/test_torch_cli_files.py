"""The port's CLI (msweep_tpu_torch/cli.py) against the JAX package's
(msweep_tpu.cli.main) file for file, on tests/test_cli.py's dataset, over
the flag surface tests/test_cli.py covers.

Each case runs the same command lines through both CLIs on the CPU, each
into a directory of its own, and requires both to exit 0 and to write the
same files with the same bytes: gzip files compared after decompression
(their headers carry a time stamp), npz checkpoints array by array (their
zip entries carry one too), and stdout where the output goes there.  Both
CLIs run float64 here.  The first group is every group masked by
--min-hits, where the port used to exit 1 (ROADMAP.md section 3, fault
1)."""

import gzip
import io
import os
import sys

import numpy as np
import pytest

from msweep_tpu_torch import cli

DATA = ["--themisto-1", "{data}/s1.txt", "--themisto-2", "{data}/s2.txt",
        "-i", "{data}/clustering.txt", "-o", "{out}/run"]
RESUME = ["-i", "{data}/clustering.txt", "-o", "{out}/resume"]
ALL_MASKED = ["--min-hits", "100000"]

# case -> command lines, run in order in one directory; "stdin" feeds s1.txt
# on standard input.
CASES = {
    "all-masked": [DATA + ALL_MASKED],
    "all-masked-emgpu": [DATA + ALL_MASKED + ["--algorithm", "emgpu"]],
    "all-masked-run-rate": [DATA + ALL_MASKED + ["--run-rate"]],
    "all-masked-iters": [DATA + ALL_MASKED + ["--iters", "2", "--seed", "3"]],
    "all-masked-write-probs": [DATA + ALL_MASKED + ["--write-probs"]],
    "all-masked-bin-reads": [DATA + ALL_MASKED + ["--bin-reads"]],
    "bin-reads": [DATA + ["--bin-reads"]],
    "target-groups": [DATA + ["--bin-reads", "--target-groups", "clust1,clust3"]],
    "min-abundance": [DATA + ["--bin-reads", "--min-abundance", "0.1"]],
    "min-hits-30": [DATA + ["--min-hits", "30", "--write-probs"]],
    "alphas": [DATA + ["--alphas", "1,2,0.5,1"]],
    "groupings": [[a.replace("clustering.txt", "two.txt") for a in DATA]],
    "compress": [DATA + ["--write-probs", "--compress", "z"]],
    "likelihood": [DATA + ["--write-likelihood"],
                   ["--read-likelihood", "{out}/run_likelihoods.tsv"] + RESUME],
    "likelihood-bitseq": [DATA + ["--write-likelihood-bitseq"]],
    "checkpoint": [DATA + ["--write-checkpoint", "{out}/ck.npz"],
                   ["--read-checkpoint", "{out}/ck.npz"] + RESUME],
    "samples-manifest": [["--samples-manifest", "{out}/manifest.tsv", "-i",
                          "{data}/clustering.txt"]],
    "packed": [[a.replace(".txt", ".aln") if "/s" in a else a for a in DATA]],
    "stdin-stdout": [["stdin", "-i", "{data}/clustering.txt", "-o", ""]],
    "no-fit-model": [DATA + ["--no-fit-model", "--write-likelihood"]],
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """tests/test_cli.py's dataset (12 references in 4 clusters, 600
    paired reads), its two-grouping file and its packed alignments."""
    from msweep_tpu_torch.io.packed import pack_pairs
    from msweep_tpu_torch.io.themisto import parse_plaintext_pairs

    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(123)
    clusters = ["clust1"] * 4 + ["clust2"] * 3 + ["clust3"] * 3 + ["clust4"] * 2
    (d / "clustering.txt").write_text("\n".join(clusters) + "\n")
    coarse = {"clust1": "A", "clust2": "A", "clust3": "B", "clust4": "B"}
    (d / "two.txt").write_text("\n".join(f"{c}\t{coarse[c]}" for c in clusters) + "\n")
    members = {0: range(0, 4), 1: range(4, 7), 2: range(7, 10), 3: range(10, 12)}
    fwd, rev = [], []
    for rid in range(600):
        lin = rng.choice(4, p=[0.5, 0.3, 0.15, 0.05])
        tg = sorted({t for t in members[lin] if rng.random() < 0.85})
        tg2 = sorted({t for t in tg if rng.random() < 0.95})
        fwd.append(f"{rid} " + " ".join(map(str, tg)) if tg else str(rid))
        rev.append(f"{rid} " + " ".join(map(str, tg2)) if tg2 else str(rid))
    for name, lines in (("s1", fwd), ("s2", rev)):
        (d / f"{name}.txt").write_text("\n".join(lines) + "\n")
        r, t, n = parse_plaintext_pairs((d / f"{name}.txt").read_bytes())
        (d / f"{name}.aln").write_bytes(pack_pairs(r, t, n, 12))
    return d


def _run(main, case, data, out, monkeypatch, capsys):
    """Every command line of `case` through `main` in directory `out`;
    returns what went to stdout."""
    out.mkdir()
    (out / "manifest.tsv").write_text(f"{out}/a\t{data}/s1.txt\t{data}/s2.txt\n"
                                      f"# a comment line\n{out}/b\t{data}/s1.txt\n")
    printed = []
    for argv in CASES[case]:
        argv = [a.format(data=data, out=out) for a in argv]
        if argv[0] == "stdin":
            argv = argv[1:]
            stdin = io.TextIOWrapper(io.BytesIO((data / "s1.txt").read_bytes()))
            monkeypatch.setattr(sys, "stdin", stdin)
        capsys.readouterr()
        assert main(argv) == 0, (main.__module__, argv, capsys.readouterr().err)
        printed.append(capsys.readouterr().out)
    os.remove(out / "manifest.tsv")
    return printed


def _contents(path):
    if path.suffix == ".gz":
        return gzip.decompress(path.read_bytes())
    if path.suffix == ".npz":
        with np.load(path, allow_pickle=True) as z:
            return {k: z[k].tolist() for k in z.files}
    return path.read_bytes()


@pytest.mark.parametrize("case", list(CASES))
def test_cli_files_equal_jax_cli(case, data, tmp_path, monkeypatch, capsys):
    from msweep_tpu.cli import main as jax_main

    def port_main(argv):
        return cli.main(argv + ["--backend", "cpu"])

    jax_out = _run(jax_main, case, data, tmp_path / "jax", monkeypatch, capsys)
    port_out = _run(port_main, case, data, tmp_path / "port", monkeypatch, capsys)
    assert port_out == jax_out
    jax_files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    port_files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert port_files == jax_files
    assert jax_files or any(jax_out), "the case wrote nothing"
    for name in jax_files:
        assert _contents(tmp_path / "port" / name) == _contents(tmp_path / "jax" / name), name
    if case.startswith("all-masked"):
        rows = [ln for ln in (tmp_path / "port" / "run_abundances.txt").read_text().splitlines()
                if not ln.startswith("#")]
        assert [r.split("\t")[0] for r in rows] == ["clust1", "clust2", "clust3", "clust4"]
        assert all(float(v) == 0 for r in rows for v in r.split("\t")[1:])
