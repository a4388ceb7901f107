"""Standalone packed-alignment codec CLI (alignment-writer equivalent).

The reference ecosystem ships a separate `alignment-writer` binary that
packs Themisto plaintext into the compressed .aln format consumed with
`--themisto` (docs/example.md:36-40 in the reference).  This is the
msweep-tpu analog for our pack format (io/packed.py):

    python -m msweep_tpu_torch.cli_pack pack   -n N_REFS  [in.txt]  > out.aln
    python -m msweep_tpu_torch.cli_pack unpack [in.aln]             > out.txt

Reads stdin / writes stdout when paths are omitted; transparently
decompresses gz/bz2/xz inputs (io/compressed.py).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="msweep-tpu-pack",
        description="Pack/unpack Themisto plaintext pseudoalignments "
        "(msweep-tpu packed format; see msweep_tpu_torch/io/packed.py).",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    pk = sub.add_parser("pack", help="plaintext -> packed")
    pk.add_argument("input", nargs="?", help="plaintext alignment (default stdin)")
    pk.add_argument("-n", "--n-refs", type=int, required=True,
                    help="number of reference sequences (pseudoalignment targets)")
    pk.add_argument("-l", "--level", type=int, default=6, help="zlib level (default 6)")
    up = sub.add_parser("unpack", help="packed -> plaintext")
    up.add_argument("input", nargs="?", help="packed alignment (default stdin)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .io.compressed import read_input_bytes
    from .io import packed

    data = read_input_bytes(args.input)

    if args.cmd == "pack":
        from .io.themisto import parse_plaintext_pairs

        reads, tgts, n_reads = parse_plaintext_pairs(data)
        if len(tgts) and int(tgts.max()) >= args.n_refs:
            raise SystemExit(
                f"target id {int(tgts.max())} out of range for --n-refs {args.n_refs}"
            )
        sys.stdout.buffer.write(
            packed.pack_pairs(reads, tgts, n_reads, args.n_refs, level=args.level)
        )
        return 0

    # unpack: emit one line per read, `read_id tgt tgt ...` like Themisto.
    nl = data.find(b"\n")
    _, n_refs = packed.read_header(data[:nl])
    reads, tgts, n_reads = packed.parse_packed_pairs(data, n_refs)
    out = sys.stdout
    order = np.lexsort((tgts, reads))
    reads = reads[order]
    tgts = tgts[order]
    boundaries = np.flatnonzero(
        np.concatenate([[True], reads[1:] != reads[:-1]])
    )
    ptr = np.append(boundaries, len(reads))
    by_read = {int(reads[b]): (int(ptr[i]), int(ptr[i + 1]))
               for i, b in enumerate(boundaries)}
    for r in range(n_reads):
        if r in by_read:
            lo, hi = by_read[r]
            out.write(str(r) + " " + " ".join(map(str, tgts[lo:hi])) + "\n")
        else:
            out.write(f"{r}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
