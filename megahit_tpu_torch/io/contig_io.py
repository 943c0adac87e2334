"""Contig FASTA I/O with MEGAHIT-compatible headers.

Header format (must match the reference so that outputs interoperate):
``>k{K}_{id} flag={f} multi={m:.4f} len={n}``
(reference src/sequence/io/contig/contig_writer.h:26-34, parsed
positionally by contig_reader.h:66-67,112-119).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import packing

# contig flags (reference src/definitions.h)
FLAG_STANDALONE = 1
FLAG_LOOP = 2


@dataclass
class ContigRecord:
    codes: np.ndarray  # uint8 base codes
    k: int
    cid: int
    flag: int
    multi: float

    @property
    def length(self) -> int:
        return len(self.codes)


def write_contigs(path: str, contigs: list[ContigRecord]) -> None:
    with open(path, "w") as fh:
        for c in contigs:
            fh.write(
                f">k{c.k}_{c.cid} flag={c.flag} multi={c.multi:.4f} "
                f"len={c.length}\n"
            )
            fh.write(packing.decode(c.codes))
            fh.write("\n")
    with open(path + ".info", "w") as fh:
        n_bases = sum(c.length for c in contigs)
        fh.write(f"{len(contigs)} {n_bases}\n")


def parse_header(hdr: str) -> tuple[int, int, int, float]:
    """'k59_12 flag=1 multi=2.5 len=300' -> (k, cid, flag, multi).

    Only flag/multi are semantically needed downstream (the reference
    reader parses just the comment, contig_reader.h:68); names that
    don't follow the k{K}_{cid} pattern (e.g. the reference's local
    contigs 'lc_0_strand_0_id_0') parse as k=0, cid=ordinal-ish."""
    fields = hdr.split()
    parts = fields[0].split("_")
    try:
        k = int(parts[0][1:])
        cid = int(parts[1])
    except (ValueError, IndexError):
        k, cid = 0, 0
    flag = 0
    multi = 1.0
    for f in fields[1:]:
        if f.startswith("flag="):
            flag = int(f[5:])
        elif f.startswith("multi="):
            multi = float(f[6:])
    return k, cid, flag, multi


def read_contigs(
    path: str,
    min_len: int = 0,
    extend_loop_k: tuple[int, int] | None = None,
) -> list[ContigRecord]:
    """Read a contig FASTA.

    extend_loop_k = (k_from, k_to): loop contigs (flag & 2) are
    circular; their string already wraps k_from bases, so appending
    bases at positions [k_from, k_to) continues the cycle and exposes
    every k_to-window across the junction exactly once (reference
    contig_reader.h:73-86: `ss.push_back(ss[i]) for i in k_from..k_to`;
    loops shorter than k_to + 1 are dropped entirely).
    """
    out: list[ContigRecord] = []
    name = None
    chunks: list[bytes] = []
    with open(path, "rb") as fh:
        for line in fh:
            line = line.rstrip()
            if line.startswith(b">"):
                if name is not None:
                    out.append(_make_record(name, b"".join(chunks)))
                name = line[1:].decode()
                chunks = []
            elif line:
                chunks.append(line)
        if name is not None:
            out.append(_make_record(name, b"".join(chunks)))

    result = []
    for c in out:
        if c.length < min_len:
            continue
        if extend_loop_k is not None and (c.flag & FLAG_LOOP):
            k_from, k_to = extend_loop_k
            if c.length < k_to + 1:
                continue
            # circular contig: continue the cycle past the k_from-base
            # wrap so every k_to-window across the junction exists
            c = ContigRecord(
                np.concatenate([c.codes, c.codes[k_from:k_to]]),
                c.k,
                c.cid,
                c.flag,
                c.multi,
            )
        result.append(c)
    return result


def _make_record(header: str, seq: bytes) -> ContigRecord:
    k, cid, flag, multi = parse_header(header)
    return ContigRecord(packing.encode(seq), k, cid, flag, multi)
