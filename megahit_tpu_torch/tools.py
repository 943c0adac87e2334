"""Toolkit subcommands: contig2fastg, filterbylen, readstat.

Re-expressions of reference src/tools/ (contigs_to_fastg.cpp,
filter_by_len.cpp, read_stat.cpp) with format-compatible output.
Host-only: no tool touches a device. Exposed via
`python -m megahit_tpu_torch.tools <cmd> ...` and the
`megahit-tpu-torch-tools` script. Counterpart of megahit_tpu/tools.py,
whose output it reproduces byte for byte.
"""

from __future__ import annotations

import io
import sys

import numpy as np

from .io.fastx import _iter_fastx_stream, iter_fastx

_COMP = {"A": "T", "C": "G", "G": "C", "T": "A",
         "a": "T", "c": "G", "g": "C", "t": "A"}

K_MAX = 255  # largest supported k (reference src/sdbg/sdbg_def.h:21)


def _revcomp(s: str) -> str:
    return "".join(_COMP.get(c, "N") for c in reversed(s))


def _read_fasta_with_multi(path: str) -> tuple[list[str], list[float]]:
    seqs: list[str] = []
    muls: list[float] = []
    name = None
    mul = 1.0
    chunks: list[str] = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip()
            if line.startswith(">"):
                if name is not None:
                    seqs.append("".join(chunks))
                    muls.append(mul)
                name = line[1:]
                mul = 1.0
                for tok in name.split():
                    if tok.startswith("multi="):
                        mul = float(tok[6:])
                chunks = []
            elif line:
                chunks.append(line)
        if name is not None:
            seqs.append("".join(chunks))
            muls.append(mul)
    return seqs, muls


def contig2fastg(k: int, path: str, out=None) -> None:
    """SPAdes-like FASTG export (contigs_to_fastg.cpp:82-155):
    node = contig in both orientations; an edge connects node X to Y
    when X's last k bases equal Y's first k bases. Writes to `out`
    (default: stdout)."""
    out = out or sys.stdout
    all_seqs, all_muls = _read_fasta_with_multi(path)
    ctgs = [s for s in all_seqs if len(s) >= k + 1]
    muls = [m for s, m in zip(all_seqs, all_muls) if len(s) >= k + 1]

    def node_name(i: int, rev: bool) -> str:
        s = (f"NODE_{i + 1}_length_{len(ctgs[i])}_"
             f"cov_{muls[i]:.4f}_ID_{(i + 1) * 2 - 1}")
        return s + "'" if rev else s

    start_kmer_to_id: dict[str, list[int]] = {}
    for i, c in enumerate(ctgs):
        start_kmer_to_id.setdefault(c[:k], []).append(i + 1)
        start_kmer_to_id.setdefault(_revcomp(c[-k:]), []).append(-i - 1)

    for i, c in enumerate(ctgs):
        for rev in (False, True):
            s = _revcomp(c) if rev else c
            header = ">" + node_name(i, rev)
            nbrs = start_kmer_to_id.get(s[-k:], [])
            if nbrs:
                header += ":" + ",".join(
                    node_name(j - 1, False) if j > 0
                    else node_name(-j - 1, True)
                    for j in nbrs
                )
            header += ";"
            out.write(f"{header}\n{s}\n")


def filterbylen(min_len: int, inp=None, out=None, err=None) -> None:
    """Filter FASTA (default: stdin) by length + N50 report
    (filter_by_len.cpp:36-64)."""
    inp, out, err = inp or sys.stdin, out or sys.stdout, err or sys.stderr
    lengths = []
    name = None
    chunks: list[str] = []

    def emit():
        if name is not None:
            seq = "".join(chunks)
            if len(seq) >= min_len:
                lengths.append(len(seq))
                out.write(f">{name}\n{seq}\n")

    for line in inp:
        line = line.rstrip()
        if line.startswith(">"):
            emit()
            name = line[1:]
            chunks = []
        elif line:
            chunks.append(line)
    emit()

    ls = np.sort(np.array(lengths, dtype=np.int64))[::-1]
    total = int(ls.sum()) if len(ls) else 0
    if len(ls):
        n50 = int(ls[np.searchsorted(np.cumsum(ls), total / 2)])
        err.write(
            f"{len(ls)} contigs, total {total} bp, min {int(ls[-1])} bp, "
            f"max {int(ls[0])} bp, avg {int(total / len(ls) + 0.5)} bp, "
            f"N50 {n50} bp\n"
        )
    else:
        err.write("0 contigs, total 0 bp\n")


def readstat(paths: list[str], out=None) -> None:
    """Read-count/length stats (read_stat.cpp:35-63). With no paths,
    reads stdin like the reference (`megahit_toolkit readstat < f`)."""
    out = out or sys.stdout

    def records():
        if not paths:
            yield from _iter_fastx_stream(
                io.BufferedReader(sys.stdin.buffer, 1 << 20))
            return
        for p in paths:
            yield from iter_fastx(p)

    n, total, mx, mn = 0, 0, 0, 999999999
    for rec in records():
        n += 1
        total += len(rec.seq)
        mx = max(mx, len(rec.seq))
        mn = min(mn, len(rec.seq))
    avg = total / n if n else 0.0
    out.write(
        f"number reads: {n}\ntotal size: {total}\nlongest: {mx}\n"
        f"shortest: {mn if n else 0}\navg: {avg:f}\n"
    )


def checkcpu(out=None) -> None:
    """Host parallelism, torch and CUDA versions, and the visible cards
    (the reference's cpu_dispatch introspection)."""
    import os

    import torch

    out = out or sys.stdout
    out.write(f"host cpus: {os.cpu_count()}\n")
    out.write(f"torch: {torch.__version__}, CUDA {torch.version.cuda}\n")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    out.write(f"cuda devices: {n}\n")
    for i in range(n):
        out.write(f"device: cuda:{i} {torch.cuda.get_device_name(i)}\n")


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(
            "usage: python -m megahit_tpu_torch.tools "
            "{contig2fastg,filterbylen,readstat} ...",
            file=sys.stderr,
        )
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "dumpversion" or cmd == "version":
        # reference main.cpp:52 dumpversion
        from . import __version__

        print(__version__)
        return 0
    if cmd == "kmax":
        # reference main.cpp `kmax` (sdbg_def.h:21 kMaxK=255)
        print(K_MAX)
        return 0
    if cmd == "checkcpu":
        checkcpu()
        return 0
    if cmd == "contig2fastg":
        if len(rest) < 2:
            print("usage: contig2fastg <kmer_size> <contigs.fa>",
                  file=sys.stderr)
            return 1
        contig2fastg(int(rest[0]), rest[1])
    elif cmd == "filterbylen":
        filterbylen(int(rest[0]) if rest else 0)
    elif cmd == "readstat":
        readstat(rest)  # no args = stdin, like the reference
    else:
        print(f"unknown tool: {cmd}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
