"""Reading what the program wrote, so the reference can judge it: the
first graph's edge file or graph file, and a contig FASTA."""

from __future__ import annotations

import numpy as np

from reference.first_graph import LUT, revcomp


def words_to_keys(words: np.ndarray, k1: int) -> np.ndarray:
    """(E, W) uint32 words, 2 bits a base, first base highest, left
    aligned -> uint64 keys with the first base highest (k1 <= 32)."""
    words = np.asarray(words, dtype=np.uint64)
    if words.ndim != 2 or words.shape[1] != -(-k1 // 16):
        raise ValueError(f"edge words of shape {words.shape} do not hold "
                         f"{k1}-mers")
    v = words[:, 0] << np.uint64(32)
    if words.shape[1] > 1:
        v |= words[:, 1]
    return v >> np.uint64(64 - 2 * k1)


def load_graph(path: str, k1: int) -> tuple[np.ndarray, np.ndarray]:
    """A first graph as written by the program: an edge file (canonical
    keys and counts) or a graph file in its full row form (every valid
    row of both strands with its multiplicity). Returns the canonical
    uint64 keys and their multiplicities."""
    z = np.load(path)
    if "counts" in z:
        return words_to_keys(z["keys"], k1), z["counts"].astype(np.int64)
    if int(z["format"]) != 3 or int(z["k"]) != k1:
        raise ValueError(f"{path}: not a full-row graph of {k1}-mers")
    n = int(z["n_real"])
    keys = words_to_keys(z["keys"][:n], k1)
    valid = np.unpackbits(z["valid"], count=n).astype(bool)
    canon = valid & (keys <= revcomp(keys, k1))
    return keys[canon], z["mult"][:n][canon].astype(np.int64)


def words_to_rows(words: np.ndarray, k1: int) -> np.ndarray:
    """(E, W) uint32 words, 2 bits a base, first base highest, left
    aligned -> the reference's rows of uint64 words (two uint32 words
    to one), for keys of any length."""
    words = np.asarray(words, dtype=np.uint64)
    if words.ndim != 2 or words.shape[1] != -(-k1 // 16):
        raise ValueError(f"edge words of shape {words.shape} do not hold "
                         f"{k1}-mers")
    if words.shape[1] % 2:
        words = np.concatenate(
            [words, np.zeros((len(words), 1), np.uint64)], axis=1)
    return (words[:, 0::2] << np.uint64(32)) | words[:, 1::2]


def load_edges(path: str, k1: int) -> tuple[np.ndarray, np.ndarray]:
    """A rung's edge file as the program wrote it (keys and counts) ->
    the reference's rows and the counts."""
    with np.load(path) as z:
        return words_to_rows(z["keys"], k1), z["counts"].astype(np.int64)


def header_flag(header: str) -> int:
    """The flag of a contig header ('k21_3 flag=1 multi=8.4658
    len=300')."""
    for field in header.split():
        if field.startswith("flag="):
            return int(field[len("flag="):])
    return 0


def header_multi(header: str) -> str:
    """The multi of a contig header ('k21_3 flag=0 multi=8.4658
    len=300'), as printed."""
    for field in header.split():
        if field.startswith("multi="):
            return field[len("multi="):]
    return ""


def read_contigs(path: str) -> list[tuple[str, np.ndarray]]:
    """(header, codes) of each record of a FASTA file."""
    out = []
    header, parts = None, []
    with open(path, "rb") as fh:
        for line in fh:
            line = line.rstrip(b"\n")
            if line.startswith(b">"):
                if header is not None:
                    out.append((header, b"".join(parts)))
                header, parts = line[1:].decode(), []
            elif line:
                parts.append(line)
    if header is not None:
        out.append((header, b"".join(parts)))
    return [(h, LUT[np.frombuffer(s, np.uint8)]) for h, s in out]
