"""Debug / sanitizer mode.

The reference ships ASan/UBSan/TSan build modes (CMakeLists.txt:59-65)
to catch memory and concurrency bugs; here the equivalent failure
classes are numeric (non-finite values in depth/similarity math) and
STRUCTURAL (a graph whose derived navigation drifts from its keys).
`MEGAHIT_TPU_TORCH_DEBUG=1` enables:

- a finiteness assertion on the float tensors the device cleaning
  engine computes (`enable_debug_checks`, armed by the CLI);
- full graph invariant checks after every SdBG construction (the
  default build only spot-checks 1K rows of an injected rc): rc
  involution, strand-symmetric validity and multiplicity, and the four
  candidate tables against the keys by brute force.

`CHECKS` counts the checks that ran, so a caller can show they were
armed. Counterpart of megahit_tpu/utils/debug.py.
"""

from __future__ import annotations

import os

import numpy as np

CHECKS = {"sdbg_invariants": 0, "finite": 0}
_finite_armed = False


def debug_enabled() -> bool:
    return os.environ.get("MEGAHIT_TPU_TORCH_DEBUG", "") not in ("", "0")


def enable_debug_checks() -> None:
    """Arm the finiteness assertion (call before device work).

    torch has no global counterpart of jax_debug_nans. Float math in
    this package happens only in the device cleaning engine (average
    depths, local depth means and ratios, weak-link depth sums; the
    bubble similarity is integer edit distance on the host), so that
    engine passes each float tensor it computes through
    `check_finite`, which raises on a NaN or an infinity once armed."""
    global _finite_armed
    _finite_armed = True


def check_finite(name: str, t):
    """t, after asserting every value is finite when debug checks are
    armed (a device sync on CUDA); a no-op otherwise."""
    if _finite_armed:
        import torch

        CHECKS["finite"] += 1
        _require(bool(torch.isfinite(t).all()),
                 f"non-finite values in {name}")
    return t


def _require(ok: bool, msg: str) -> None:
    """An assertion that `python -O` keeps."""
    if not ok:
        raise AssertionError(msg)


def check_sdbg_invariants(sdbg) -> None:
    """Full structural validation of an Sdbg (debug mode only).

    Raises AssertionError (also under `python -O`) with a precise
    message on the first broken invariant. Runs on host copies of the
    arrays whatever the graph's device; O(E) host work - gated behind
    MEGAHIT_TPU_TORCH_DEBUG.
    """
    from ..core import kmerops
    from ..graph.sdbg import cands_at

    CHECKS["sdbg_invariants"] += 1
    e = sdbg.real
    if e == 0:
        return
    keys = np.asarray(sdbg.keys[:e])
    k = sdbg.k
    rc = np.asarray(sdbg.rc[:e])
    valid = np.asarray(sdbg.valid[:e])
    mult = np.asarray(sdbg.mult[:e])

    rck = np.asarray(kmerops.revcomp_kmers(keys, k))
    _require((keys[rc] == rck).all(),
             "rc pairing broken: edges[rc] != revcomp")
    _require((rc[rc] == np.arange(e)).all(), "rc is not an involution")
    _require((valid[rc] == valid).all(), "validity not strand-symmetric")
    _require((mult[rc] == mult).all(), "multiplicity not strand-symmetric")

    # candidate tables: each row's candidate SET must equal the
    # brute-force set of existing neighbour k-mers derived by key
    # surgery + dict lookup
    suffix = kmerops.mask_tail(kmerops.drop_first_base(keys, k), k - 1)
    prefix = kmerops.mask_tail(keys, k - 1)
    index = {kk.tobytes(): i for i, kk in enumerate(keys)}

    def brute(node, place):
        """(e, 4) hit rows (or e, which sorts last) of the 4 possible
        neighbours of each node."""
        hits = np.full((e, 4), e, dtype=np.int64)
        for c in range(4):
            if place == "append":
                want = kmerops.set_base(node, k - 1, c)
            else:
                want = kmerops.mask_tail(kmerops.set_base(
                    kmerops.shift_right_bits(node, 2), 0, c), k)
            want = np.ascontiguousarray(want)
            hits[:, c] = [index.get(r.tobytes(), e) for r in want]
        return np.sort(hits, axis=1)

    rows = np.arange(e)
    for name, node, place in (("oc_t", suffix, "append"),
                              ("ic_t", suffix, "prepend"),
                              ("oc_s", prefix, "append"),
                              ("ic_s", prefix, "prepend")):
        t = cands_at(sdbg, rows, name).astype(np.int64)
        got = np.sort(np.where(t >= 0, t, e), axis=1)
        want = brute(node, place)
        bad = np.flatnonzero((got != want).any(axis=1))
        if len(bad):
            i = int(bad[0])
            raise AssertionError(
                f"{name}[{i}] candidate set "
                f"{[int(x) for x in got[i] if x < e]} != expected "
                f"{[int(x) for x in want[i] if x < e]}")
