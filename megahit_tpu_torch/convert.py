"""Build this package's objects from megahit_tpu's state.

Each function takes megahit_tpu's state as plain numpy
arrays (no import of megahit_tpu or JAX) and returns the port's object,
so a test can feed both packages the same read pool, graph or unitig
graph. The on-disk artifacts (reads.lib.npz, k{K}.edges.npz, .sdbg.npz
in both formats, contig FASTA) need no conversion: both packages read
and write the same files.
"""

from __future__ import annotations

import numpy as np

from .graph.sdbg import Sdbg
from .graph.unitig import UnitigGraph
from .io.lib import PackedPool, SequenceLib

# UnitigGraph array fields, in megahit_tpu's order
UNITIG_FIELDS = (
    "start", "end", "rc_start", "rc_end", "length", "total_depth",
    "is_loop", "is_palindrome", "vid", "chain_start", "edge_pos", "nxt",
    "prv", "to_delete", "to_disconnect_fwd", "to_disconnect_rc",
    "changed", "alive",
)


def packed_pool(words: np.ndarray, n_bases: int) -> PackedPool:
    """A PackedPool from its u32 words (16 bases a word, big-endian)."""
    return PackedPool(int(n_bases), words=np.array(words, dtype=np.uint32))


def sequence_lib(words: np.ndarray, n_bases: int, starts: np.ndarray,
                 lib_ranges) -> SequenceLib:
    """A SequenceLib from its pool words, read start offsets and the
    per-library (begin, end, is_paired) ranges."""
    return SequenceLib(
        None, np.array(starts, dtype=np.int64),
        [(int(b), int(e), bool(p)) for b, e, p in lib_ranges],
        pool=packed_pool(words, n_bases))


def sdbg(k: int, keys: np.ndarray, mult: np.ndarray, valid: np.ndarray,
         rc: np.ndarray | None = None, real: int | None = None,
         device="cuda") -> Sdbg:
    """An Sdbg from its sorted (capacity-padded) keys, multiplicities,
    validity and, optionally, its rc pairing; the run navigation
    derives from the keys on first use."""
    return Sdbg(
        k=int(k), keys=np.array(keys, dtype=np.uint32),
        mult=np.array(mult, dtype=np.int32),
        valid=np.array(valid, dtype=bool),
        rc=None if rc is None else np.array(rc, dtype=np.int32),
        real=None if real is None else int(real), device=device)


def unitig_graph(k: int, graph: Sdbg, arrays: dict) -> UnitigGraph:
    """A UnitigGraph over `graph` from megahit_tpu's per-vertex and
    per-edge arrays (keys as in UNITIG_FIELDS; missing marks default)."""
    kw = {f: np.array(arrays[f]) for f in UNITIG_FIELDS
          if arrays.get(f) is not None}
    return UnitigGraph(k=int(k), sdbg=graph, **kw)
