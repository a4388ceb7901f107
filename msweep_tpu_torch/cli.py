"""Command-line driver of the port: the mSWEEP-compatible CLI
(counterpart of msweep_tpu/cli.py, whose flag surface it copies): rcg and
EM fits, --iters bootstrap, --run-rate, --trace-dir, and EC-axis sharding
over devices (--shards) and processes (--distributed-*).

    python -m msweep_tpu_torch.cli --themisto-1 fwd.aln --themisto-2 rev.aln \\
        -i clustering.txt -o sample1 [--backend cuda|cpu]

`--backend` defaults to cuda and fails when no GPU is present; a CPU run
asks for `--backend cpu`.  Matrix dtype: `--precision` wins; otherwise
--algorithm emgpu follows `--emprecision` (default double: float64
matrices, also on CUDA, which has native FP64), and rcg runs float32 on
CUDA (the kernel path, escalated to float64 past the float32 floor) and
float64 on the CPU.

--shards N cuts the EC rows over the first N devices of --backend (0, the
default, means every visible one; 1 means no sharding).  A distributed run
starts one process per device with --distributed-coordinator host:port,
--distributed-nprocs and --distributed-process-id; process p runs on
cuda:{p % device_count} over NCCL (gloo with --backend cpu), holds one
row range, and process 0 alone logs and writes.  --trace-dir writes a
torch.profiler trace of the fit, with the fit's msweep:: spans.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

from . import __version__
from .device import resolve_device
from .log import Log
from .parallel import mesh


CITATION = (
    "Please cite us as:\n"
    "\tMäklin T, Kallonen T, David S et al. High-resolution sweep\n"
    "\tmetagenomics using fast probabilistic inference [version 2;\n"
    "\tpeer review: 2 approved]. Wellcome Open Res 2021, 5:14\n"
    "\t(https://doi.org/10.12688/wellcomeopenres.15639.2)"
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="msweep-tpu-torch",
        description=(
            "Estimate abundances of reference lineages in DNA sequencing reads "
            "(mSWEEP on PyTorch and CUDA)."
        ),
    )
    p.add_argument("--verbose", action="store_true", help="Print status messages to cerr.")
    p.add_argument("--version", action="store_true", help="Print version.")
    p.add_argument("--cite", action="store_true", help="Print citation information.")

    g = p.add_argument_group("Pseudoalignment files (required: -1 and -2, or only -x; stdin if none)")
    g.add_argument("--themisto-1", help="Pseudoalignments for the 1st strand of paired-end reads.")
    g.add_argument("--themisto-2", help="Pseudoalignments for the 2nd strand of paired-end reads.")
    g.add_argument(
        "--themisto",
        help="Single alignment file or comma-separated list of several files.",
    )

    p.add_argument("-i", dest="indicators", required=False, help="Group indicators for the pseudoalignment reference.")
    p.add_argument("-o", dest="output", default="", help="Prefix for output files (default: print to cout).")

    b = p.add_argument_group("Binning options")
    b.add_argument("--bin-reads", action="store_true", help="Run the mGEMS binning algorithm.")
    b.add_argument("--target-groups", help="Only extract these groups (comma separated list).")
    b.add_argument("--min-abundance", type=float, default=None, help="Only extract groups with relative abundance higher than this.")

    o = p.add_argument_group("Output options")
    o.add_argument("--write-probs", action="store_true", help="Write read-to-group probabilities (_probs.tsv).")
    o.add_argument("--print-probs", action="store_true", help="Print the probabilities to cout.")
    o.add_argument("--write-likelihood", action="store_true", help="Write the likelihood matrix (_likelihoods.tsv).")
    o.add_argument("--write-likelihood-bitseq", action="store_true", help="Write likelihoods in BitSeq-parseable format.")
    o.add_argument("--compress", default="plaintext", help="Compress output files (z, bz2, lzma, zstd).")
    o.add_argument("--compression-level", type=int, default=6, help="Compression level (0-9; default 6).")

    ip = p.add_argument_group("Input options")
    ip.add_argument("--themisto-mode", default="intersection", help="Paired-end merge mode (intersection, union, or unpaired).")
    ip.add_argument("--read-likelihood", help="Path to a likelihood file written with --write-likelihood.")

    e = p.add_argument_group("Estimation options")
    e.add_argument("-t", dest="threads", type=int, default=1, help="Threads for host-side processing (device parallelism is automatic).")
    e.add_argument("--no-fit-model", action="store_true", help="Only build (and optionally write) the likelihood matrix.")
    e.add_argument("--max-iters", type=int, default=5000, help="Maximum optimizer iterations (default 5000).")
    e.add_argument("--tol", type=float, default=1e-6, help="Optimization convergence tolerance (default 1e-6).")
    e.add_argument("--algorithm", default="rcgcpu", help="rcggpu, emgpu, or rcgcpu (default rcgcpu; rcg* are the same program here).")
    e.add_argument("--emprecision", default="double", choices=["float", "double"], help="Precision for the emgpu algorithm (default double).")

    bs = p.add_argument_group("Bootstrapping options")
    bs.add_argument("--iters", type=int, default=0, help="Number of bootstrap rerun iterations (default 0).")
    bs.add_argument("--seed", type=int, default=26012023, help="Seed for the bootstrap RNG (default: random).")
    bs.add_argument("--bootstrap-count", type=int, default=0, help="How many pseudoalignments to resample (default: number of reads).")

    lk = p.add_argument_group("Likelihood options")
    lk.add_argument("-q", dest="q", type=float, default=0.65, help="Mean for the beta-binomial component (default 0.65).")
    lk.add_argument("-e", dest="e", type=float, default=0.01, help="Dispersion term for the beta-binomial component (default 0.01).")
    lk.add_argument("--alphas", help="Prior counts for relative abundances, comma-separated (default all 1.0).")
    lk.add_argument("--zero-inflation", type=float, default=0.01, help="Likelihood of an observation with 0 pseudoalignments against a group (default 0.01).")

    x = p.add_argument_group("Experimental options")
    x.add_argument("--run-rate", action="store_true", help="Calculate RATE/KLD reliability for each estimate.")
    x.add_argument("--min-hits", type=int, default=0, help="Only consider groups with at least this many aligned reads (default 0).")
    x.add_argument("--backend", default=None, help="(extension) device: cuda (default, also gpu) or cpu; a missing GPU is an error.")
    x.add_argument("--precision", default=None, choices=["float", "double"], help="(extension) matrix dtype for any algorithm.")
    x.add_argument("--shards", type=int, default=0, help="(extension) shard the EC axis over this many devices (0 = all available).")
    x.add_argument("--write-checkpoint", help="(extension) save the built likelihood problem as a full-precision npz checkpoint.")
    x.add_argument("--read-checkpoint", help="(extension) resume from an npz checkpoint, skipping alignment ingestion and likelihood build.")
    x.add_argument("--trace-dir", help="(extension) write a torch.profiler trace of the estimation to this directory; it carries the fit's msweep:: spans (chunks, host reads) beside the device's kernels.")
    x.add_argument(
        "--samples-manifest",
        help="(extension) batch mode: TSV of `output_prefix<TAB>aln1[<TAB>aln2]` "
        "lines; processes every sample in one invocation, reusing the "
        "reference and the built kernels across samples.",
    )
    x.add_argument(
        "--no-precision-escalation", action="store_true",
        help="(extension) stop rcg at the f32 numerical floor instead of "
        "escalating to float64 past it (faster on ill-conditioned data; "
        "abundances may differ from the double answer by ~1e-3).",
    )
    d = p.add_argument_group(
        "Distributed options (extension; multi-host analog of the "
        "reference's MPI build, docs/compilation.md:40-58 — estimation is "
        "sharded across processes, process 0 does all I/O)"
    )
    d.add_argument("--distributed-coordinator", help="coordinator address host:port shared by all processes.")
    d.add_argument("--distributed-nprocs", type=int, help="total number of processes in the job.")
    d.add_argument("--distributed-process-id", type=int, help="this process's id (0-based; 0 = root).")
    return p


def _matrix_dtype(args, device: torch.device) -> torch.dtype:
    """--precision wins; emgpu honours --emprecision on every device (the
    JAX package's CPU rule, msweep_tpu/cli.py:186-192: its TPU-only float32
    override has no reason on a card with FP64 units); rcg runs float32 on
    CUDA and float64 on the CPU."""
    if args.precision:
        return torch.float32 if args.precision == "float" else torch.float64
    if args.algorithm == "emgpu":
        return torch.float32 if args.emprecision == "float" else torch.float64
    return torch.float32 if device.type == "cuda" else torch.float64


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    log = Log(verbose=args.verbose)
    log(f"msweep-tpu-{__version__} abundance estimation")

    if args.version:
        print(f"msweep-tpu-{__version__}", file=sys.stderr)
    if args.cite:
        print(CITATION, file=sys.stderr)
    if args.version or args.cite:
        return 0

    if not args.indicators:
        print("Error in parsing arguments:\n  -i is required\nexiting", file=sys.stderr)
        return 1

    if "/" in args.output:
        outdir = args.output[: args.output.rfind("/")]
        if not os.path.isdir(outdir):
            print(
                f"Error in parsing arguments:\n  directory {outdir} does not exist\nexiting",
                file=sys.stderr,
            )
            return 1

    alignment_paths: list[str] = []
    if args.themisto:
        alignment_paths = args.themisto.split(",")
    elif args.themisto_1 and args.themisto_2:
        alignment_paths = [args.themisto_1, args.themisto_2]

    try:
        device = _setup_device(args)
        return _run(args, alignment_paths, device, log)
    except Exception as e:  # fail fast with the message, like the reference
        print(f"{type(e).__name__}: {e}\nexiting", file=sys.stderr)
        log.flush()
        return 1
    finally:
        if mesh.process_group_up():
            torch.distributed.destroy_process_group()


def _setup_device(args) -> torch.device:
    """The device of --backend; in a distributed run (msweep_tpu/cli.py:
    157-169) this process's own device, after joining the process group."""
    device = resolve_device(args.backend)
    if not args.distributed_coordinator:
        return device
    if args.distributed_nprocs is None or args.distributed_process_id is None:
        raise RuntimeError(
            "--distributed-coordinator requires --distributed-nprocs "
            "and --distributed-process-id"
        )
    if args.shards > 1:
        raise RuntimeError("--shards > 1 cannot be combined with --distributed-*: "
                           "each process holds one shard on its own device")
    if device.type == "cuda":
        device = torch.device("cuda", args.distributed_process_id % torch.cuda.device_count())
    mesh.init_distributed(args.distributed_coordinator, args.distributed_nprocs,
                          args.distributed_process_id, device)
    return device


def _run(args, alignment_paths: list[str], device: torch.device, log: Log) -> int:
    from .core import binning as binning_mod
    from .core.alignment import collapse
    from .core.likelihood import (
        build_likelihood,
        read_likelihood_msweep,
        write_likelihood_bitseq,
        write_likelihood_msweep,
    )
    from .core.sample import SEED_SENTINEL, BootstrapResampler, make_sample
    from .io.compressed import read_input_bytes
    from .io.grouping import read_reference
    from .io.outputs import (
        OutfileDesignator,
        write_abundances,
        write_abundances_bootstrap,
        write_abundances_rate,
        write_bin,
        write_probs,
    )
    from .io.packed import looks_packed, parse_packed_pairs
    from .io.themisto import merge_strands, parse_plaintext_pairs
    from .inference import (
        algorithm_family,
        dirichlet_kld_from_pseudocounts,
        fit_em_batch,
        fit_rcg_batch,
        fit_result,
        pack_problem,
        pick_impl,
        rates_from_log_kld,
    )

    log("Reading the input files")
    log("  reading group indicators")
    reference = read_reference(args.indicators)
    n_groupings = reference.n_groupings
    if n_groupings > 1:
        log(f"  read {n_groupings} groupings")
    log(f"  read {reference.n_refs} group indicators")

    is_root = mesh.rank_and_size()[0] == 0
    if not is_root:
        log.verbose = False  # root-only logging (msweep_tpu/cli.py:267-269)
    devices = None
    if args.shards != 1 and not mesh.process_group_up():
        devices = mesh.ec_devices(args.shards, device)
        if devices:
            log(f"  sharding the EC axis over {len(devices)} devices")
    dtype = _matrix_dtype(args, device)
    if (device.type == "cuda" and dtype == torch.float32 and not args.precision
            and args.algorithm != "emgpu"):
        log(
            "  using float32 matrices with float64 accumulation (CUDA kernel "
            "path); pass --precision double for reference double precision"
        )

    def run_one_sample(out, sample_paths):
        """Per-sample pipeline (alignment -> fit -> outputs), shared by the
        single-sample path and --samples-manifest."""
        aln = None
        resume = bool(args.read_likelihood or args.read_checkpoint)
        if not resume:
            log("  reading pseudoalignments")
            strands = []
            n_reads = 0
            if sample_paths:
                buffers = [read_input_bytes(p) for p in sample_paths]
            else:
                buffers = [sys.stdin.buffer.read()]
            for buf in buffers:
                if looks_packed(buf):
                    r, t, n = parse_packed_pairs(buf, reference.n_refs)
                else:
                    r, t, n = parse_plaintext_pairs(buf, args.threads)
                strands.append((r, t))
                n_reads = n  # overwritten per strand like the reference
            keys = merge_strands(strands, reference.n_refs, args.themisto_mode)
            log(f"  read alignments for {n_reads} reads")
            log("Building equivalence classes")
            aln = collapse(keys, reference.n_refs, n_reads)
            log(f"  found {aln.n_ecs} unique alignments")
        elif n_groupings > 1:
            raise RuntimeError(
                "Using more than one grouping with --read-likelihood is not yet implemented."
            )

        if args.read_checkpoint and args.bin_reads:
            raise RuntimeError("--read-checkpoint is incompatible with --bin-reads")

        for gi in range(n_groupings):
            grouping = reference.groupings[gi]

            if args.read_checkpoint:
                log("  reading likelihood checkpoint")
                from .io.checkpoint import load_checkpoint

                lik, _ = load_checkpoint(args.read_checkpoint)
                if lik.n_groups_total != grouping.n_groups:
                    raise RuntimeError(
                        f"checkpoint has {lik.n_groups_total} groups but the "
                        f"grouping file has {grouping.n_groups}"
                    )
                sample = make_sample(lik.ec_counts, int(lik.ec_counts.sum()))
            elif args.read_likelihood:
                log("  reading likelihoods from file")
                lik = read_likelihood_msweep(
                    read_input_bytes(args.read_likelihood), grouping.n_groups
                )
                sample = make_sample(lik.ec_counts, int(lik.ec_counts.sum()))
            else:
                log("Computing the likelihood matrix")
                lik = build_likelihood(
                    aln,
                    grouping.indicators,
                    grouping.sizes,
                    q=args.q,
                    e=args.e,
                    min_hits=args.min_hits,
                    zero_inflation=args.zero_inflation,
                )
                sample = make_sample(aln.ec_counts, aln.n_reads)

            if args.write_checkpoint:
                log("  writing likelihood checkpoint")
                from .io.checkpoint import save_checkpoint

                path = args.write_checkpoint
                if n_groupings > 1:
                    path = f"{path}.{gi}" if gi else path
                save_checkpoint(path, lik, grouping.names)

            if args.write_likelihood or args.write_likelihood_bitseq:
                fmt_name = "bitseq" if args.write_likelihood_bitseq else "mSWEEP"
                stream = out.likelihoods(fmt_name)
                if fmt_name == "bitseq":
                    write_likelihood_bitseq(lik, stream)
                else:
                    write_likelihood_msweep(lik, stream)
                if stream is not sys.stdout:
                    stream.close()

            mask = lik.groups_mask
            estimated_names = [n for n, m in zip(grouping.names, mask) if m]
            zero_names = (
                [n for n, m in zip(grouping.names, mask) if not m] if args.min_hits > 0 else []
            )

            if args.no_fit_model:
                log("Skipping relative abundance estimation (--no-fit-model toggled)")
                if gi < n_groupings - 1:
                    out.next_grouping()
                continue

            log("Estimating relative abundances")
            alpha = None
            if args.alphas:
                alpha = np.array([float(v) for v in args.alphas.split(",")], dtype=np.float64)

            problem = pack_problem(lik, alpha=alpha, dtype=dtype, device=device,
                                   devices=devices)
            trace = contextlib.nullcontext()
            if args.trace_dir:
                from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

                activities = [ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(ProfilerActivity.CUDA)
                trace = profile(activities=activities,
                                on_trace_ready=tensorboard_trace_handler(args.trace_dir))
            t_fit = time.time()
            with trace:
                res = fit_result(
                    problem,
                    args.algorithm,
                    tol=args.tol,
                    max_iters=args.max_iters,
                    verbose=args.verbose,
                    log=log,
                    refine=not args.no_precision_escalation,
                )
                theta = res.theta.cpu().numpy()  # waits for the device
            t_fit = time.time() - t_fit
            n_it = max(res.n_iters, 1)
            st = res.stats
            log(
                f"  optimizer finished after {res.n_iters} iterations "
                f"({t_fit:.2f}s, {n_it / t_fit:.2f} it/s): {st.main} main, {st.blind} blind "
                f"in {st.windows} windows ({st.rolled_back} rolled back), {st.polish} polish; "
                f"{st.enqueued} enqueued, {st.host_reads} host reads"
            )
            if args.trace_dir:
                log(f"  wrote profiler trace to {args.trace_dir}")

            if args.run_rate:
                print(
                    "WARNING: --run-rate is an experimental option that has not been "
                    "thoroughly tested and is subject to change.\n",
                    file=sys.stderr,
                )
                # O(G): the pseudocounts a = N - alpha come from the
                # optimizer state; no gamma matrix is needed.
                log_klds = dirichlet_kld_from_pseudocounts(res.pseudocounts)
                sample.log_klds = log_klds.cpu().numpy()
                sample.rates = rates_from_log_kld(log_klds).cpu().numpy()

            if args.min_hits > 0:
                print(
                    "WARNING: --min-hits > 0 is an experimental option that has not been "
                    "thoroughly tested and is subject to change.\n",
                    file=sys.stderr,
                )

            sample.abundances = theta
            # The (E, G) probability matrix is built only when an output
            # consumes it (probs files / binning), and gathered to the root
            # process, which alone writes them.
            if args.bin_reads and args.read_likelihood:
                raise RuntimeError("--bin-reads can't be used with --read-likelihood")
            gamma_host = None
            if args.print_probs or args.write_probs or args.bin_reads:
                gamma_host = mesh.to_host(res.gamma())  # None off the root process
                sample.gamma = gamma_host

            if args.bin_reads and is_root:
                if args.target_groups:
                    target_names = args.target_groups.split(",")
                else:
                    target_names = list(estimated_names)
                if args.min_abundance is not None:
                    target_names = binning_mod.filter_target_groups(
                        estimated_names, theta, args.min_abundance, target_names
                    )
                bins = binning_mod.bin_reads(aln, gamma_host, theta, estimated_names, target_names)
                for name in target_names:
                    stream = out.bin(name)
                    write_bin(stream, bins[name])
                    stream.close()

            if args.print_probs and is_root:
                write_probs(sys.stdout, estimated_names, gamma_host, zero_names)
            if args.write_probs and is_root:
                stream = out.probs()
                write_probs(stream, estimated_names, gamma_host, zero_names)
                stream.close()

            # Bootstrap replicates: one batch of resampled count vectors
            # sharing the likelihood matrix (the reference refits serially,
            # src/mSWEEP.cpp:496-518).  The draws stay on the host in
            # numpy, so the JAX package and the port draw the same batch
            # from --seed; every process of a distributed run draws the
            # whole batch, from a random seed that process 0 picks when
            # --seed is not given (msweep_tpu/cli.py:494-508).
            if args.iters > 0:
                log(f"Running estimation with {args.iters} bootstrap iterations")
                seed = args.seed
                if seed == SEED_SENTINEL and mesh.process_group_up():
                    seed = mesh.broadcast_from_root(
                        int(np.random.default_rng().integers(0, 2**31 - 1)))
                resampler = BootstrapResampler(
                    lik.ec_counts, bootstrap_count=args.bootstrap_count, seed=seed
                )
                batch = resampler.resample_batch(args.iters)
                family = algorithm_family(args.algorithm)
                # Abundances straight from the batch fit: no (B, E, G) batch.
                stats = []
                if family == "rcg":
                    tb, _, _ = fit_rcg_batch(problem, batch, tol=args.tol,
                                             max_iters=args.max_iters, stats=stats)
                else:
                    tb, _, _ = fit_em_batch(problem, batch, tol=args.tol,
                                            max_iters=args.max_iters)
                tb = tb.cpu().numpy()
                line = f"  {family} bootstrap: impl={pick_impl(problem)} replicates={args.iters}"
                if stats and log.verbose:
                    st = stats[0]
                    line += (f": iterations {st.iters.tolist()}, {int(st.live_passes)} of "
                             f"{st.passes} replicate-passes live; {st.enqueued} enqueued in "
                             f"{st.chunks} chunks, {st.host_reads} host reads")
                log(line)
                sample.bootstrap_results = [theta] + list(tb)

            stream = out.abundances()
            if sample.rate_run:
                write_abundances_rate(
                    stream,
                    estimated_names,
                    theta,
                    sample.rates,
                    sample.log_klds,
                    sample.n_reads,
                    sample.counts_total,
                    zero_names,
                )
            elif args.iters > 0:
                write_abundances_bootstrap(
                    stream,
                    estimated_names,
                    sample.bootstrap_results,
                    sample.n_reads,
                    sample.counts_total,
                    zero_names,
                )
            else:
                write_abundances(
                    stream,
                    estimated_names,
                    theta,
                    sample.n_reads,
                    sample.counts_total,
                    zero_names,
                )
            if stream is not sys.stdout:
                stream.close()

            if gi < n_groupings - 1:
                out.next_grouping()

    if args.samples_manifest:
        if sum(1 for p in (args.themisto, args.themisto_1, args.read_likelihood,
                           args.read_checkpoint) if p):
            raise RuntimeError(
                "--samples-manifest is incompatible with --themisto*, "
                "--read-likelihood and --read-checkpoint"
            )
        samples = _manifest_samples(args.samples_manifest)
        log(f"Batch mode: {len(samples)} samples from {args.samples_manifest}")
        for si, (prefix, paths) in enumerate(samples):
            log(f"Sample {si + 1}/{len(samples)}: {prefix}")
            if "/" in prefix and not os.path.isdir(prefix[: prefix.rfind("/")]):
                raise RuntimeError(f"directory {prefix[: prefix.rfind('/')]} does not exist")
            run_one_sample(
                OutfileDesignator(prefix, n_groupings, args.compress, args.compression_level,
                                  root=is_root),
                paths,
            )
    else:
        run_one_sample(
            OutfileDesignator(args.output, n_groupings, args.compress, args.compression_level,
                              root=is_root),
            alignment_paths,
        )

    log.flush()
    return 0


def _manifest_samples(path: str) -> list[tuple[str, list[str]]]:
    """Parse a --samples-manifest TSV: `output_prefix<TAB>aln1[<TAB>aln2]`
    per line (blank lines and #-comments skipped)."""
    rows: list[tuple[str, list[str]]] = []
    with open(path) as f:
        for ln_no, ln in enumerate(f, 1):
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            parts = ln.split("\t")
            if len(parts) not in (2, 3):
                raise ValueError(
                    f"samples manifest line {ln_no}: expected "
                    f"prefix<TAB>aln1[<TAB>aln2], got {len(parts)} fields"
                )
            rows.append((parts[0], parts[1:]))
    if not rows:
        raise ValueError("samples manifest contains no samples")
    return rows


if __name__ == "__main__":
    sys.exit(main())
