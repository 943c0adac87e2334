"""2-bit base packing (host side, numpy).

Base encoding matches the reference semantics (A=0, C=1, G=2, T=3, with
N and unknown characters mapped to 2/'G'; see reference
src/sequence/sequence_package.h:80-83 "ACGTNacgtn" -> 0123201232).

Packed layout: 16 bases per uint32 word, big-endian within the word
(base i occupies bits [30 - 2*(i%16), 32 - 2*(i%16)) of word i//16).
This makes lexicographic comparison of base strings equal to numeric
comparison of the word tuples, which is what every sort in the system
relies on (reference: src/sequence/kmer.h packs the same way).
"""

from __future__ import annotations

import numpy as np

BASES_PER_WORD = 16
BITS_PER_BASE = 2

# ASCII -> 2-bit code; everything unknown maps to 2 (like reference 'N'->G).
_CODE_LUT = np.full(256, 2, dtype=np.uint8)
for _c, _v in zip(b"ACGTacgt", [0, 1, 2, 3, 0, 1, 2, 3]):
    _CODE_LUT[_c] = _v

_BASE_CHARS = np.frombuffer(b"ACGT", dtype=np.uint8)


def encode(seq: bytes | str | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 codes in [0,3]."""
    if isinstance(seq, str):
        seq = seq.encode()
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, bytes) else seq
    return _CODE_LUT[arr]


def decode(codes: np.ndarray) -> str:
    """uint8 codes -> ASCII string."""
    return _BASE_CHARS[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


def words_per_kmer(k: int) -> int:
    return (k + BASES_PER_WORD - 1) // BASES_PER_WORD


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """uint8 codes (n,) -> packed uint32 words (ceil(n/16),), big-endian."""
    n = len(codes)
    nw = words_per_kmer(n) if n else 0
    padded = np.zeros(nw * BASES_PER_WORD, dtype=np.uint32)
    padded[:n] = codes
    shifts = (30 - 2 * np.arange(BASES_PER_WORD, dtype=np.uint32)).astype(np.uint32)
    return (padded.reshape(nw, BASES_PER_WORD) << shifts).sum(
        axis=1, dtype=np.uint32
    )


def unpack_words(words: np.ndarray, n: int) -> np.ndarray:
    """packed uint32 words -> uint8 codes (n,)."""
    words = np.asarray(words, dtype=np.uint32)
    shifts = (30 - 2 * np.arange(BASES_PER_WORD, dtype=np.uint32)).astype(np.uint32)
    codes = (words[:, None] >> shifts) & 3
    return codes.reshape(-1)[:n].astype(np.uint8)


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return (3 - codes[::-1]).astype(np.uint8)


def pack_many(code_list: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate many code arrays into one flat code array + start offsets.

    Returns (flat_codes uint8 (B,), starts int64 (S+1,)).
    """
    lengths = np.array([len(c) for c in code_list], dtype=np.int64)
    starts = np.zeros(len(code_list) + 1, dtype=np.int64)
    np.cumsum(lengths, out=starts[1:])
    flat = (
        np.concatenate(code_list).astype(np.uint8)
        if code_list
        else np.zeros(0, dtype=np.uint8)
    )
    return flat, starts
