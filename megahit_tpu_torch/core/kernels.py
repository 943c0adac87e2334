"""The count hot path's two kernels, written by hand for Hopper, and the
build and loading of every CUDA source of the port (the two merge
kernels' wrappers live in sortnet.py).

Each kernel has three parts:

- a plain PyTorch version of the same function (``*_plain``): the CPU
  tests use it, and ``chip_smoke.py`` holds the kernel to it on the card;
- a wrapper (``canonical_all_kmers``, ``count_sorted_runs``) that checks
  its operands, takes the plain version only for tensors on the CPU,
  and otherwise launches the CUDA kernel on the current stream (or
  raises: there is no fallback for a CUDA tensor);
- a launch counter on the wrapper (``wrapper.launches``), bumped once
  per kernel launch and nowhere else.

The kernels are CUDA C++ for ``sm_90a`` under ``../csrc/``, compiled with
``nvcc`` at first use into the git-ignored ``_build/`` directory and
loaded with ctypes. Operands are int32 tensors carrying u32 bits.

Counterpart of megahit_tpu/core/pallas_kernels.py.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

from . import kmerops

BLOCK_Q = 2048
_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "_build")
SOURCES = ("canonical_kmers", "count_runs", "merge_pairs", "merge_path")
# headers a source includes (a change rebuilds it)
HEADERS = {"merge_pairs": ("merge_common.cuh",),
           "merge_path": ("merge_common.cuh",)}

# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------


def phase_grouped_mask(mask: np.ndarray, block_q: int = BLOCK_Q
                       ) -> np.ndarray:
    """Reorder a per-position mask/array into canonical_all_kmers'
    phase-grouped layout (position q*16+r -> block, r, q_local)."""
    n = len(mask)
    q = n // 16
    q_pad = -(-q // block_q) * block_q
    if q_pad * 16 > n:
        mask = np.concatenate(
            [mask, np.zeros(q_pad * 16 - n, dtype=mask.dtype)])
    m = mask.reshape(q_pad // block_q, block_q, 16)
    return m.transpose(0, 2, 1).reshape(-1)


def narrow_tail_plane(cols, k: int):
    """Shrink the last key column to 16 bits (int16 carrying the u16
    top half) when the key's trailing word uses <= 8 bases: same
    lexicographic order, since the dropped low 16 bits are zero.
    Columns are int64 u32 words. Returns cols unchanged otherwise."""
    w = kmerops.words_per_kmer(k)
    used = k - (w - 1) * 16
    if used > 8 or len(cols) != w:
        return tuple(cols)
    top = (cols[-1] >> 16) & 0xFFFF
    return tuple(cols[:-1]) + (
        torch.where(top >= 0x8000, top - 0x10000, top).to(torch.int16),)


def widen_tail_plane(cols):
    """Inverse of narrow_tail_plane."""
    if cols[-1].dtype != torch.int16:
        return tuple(cols)
    return tuple(cols[:-1]) + (
        (cols[-1].to(torch.int64) & 0xFFFF) << 16,)


def q_padded(p: int, k: int) -> int:
    """Window starts of a (p,)-word pool, padded up to a BLOCK_Q
    multiple: canonical_all_kmers returns q_padded * 16 columns."""
    q = p - kmerops.words_per_kmer(k)
    return -(-q // BLOCK_Q) * BLOCK_Q


# ---------------------------------------------------------------------------
# building and loading the CUDA sources
# ---------------------------------------------------------------------------

_libs: dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built (set CUDA_HOME or put nvcc on PATH)")
    return cand


def _so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    """The library of source `name` is missing, or older than the
    source or a header it includes."""
    so = _so_path(name)
    deps = [os.path.join(_CSRC, f"{name}.cu")] + [
        os.path.join(_CSRC, h) for h in HEADERS.get(name, ())]
    return not os.path.exists(so) or os.path.getmtime(so) < max(
        os.path.getmtime(d) for d in deps)


def build_kernels(verbose: bool = False) -> dict[str, float]:
    """Compile every CUDA source whose library is stale (_stale), one
    nvcc per source, all started together. Returns the seconds each
    build took. Raises if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in filter(_stale, SOURCES):
        src = os.path.join(_CSRC, f"{name}.cu")
        so = _so_path(name)
        tmp = f"{so}.tmp.{os.getpid()}"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-o", tmp, src]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, so, time.monotonic())
    secs = {}
    errors = []
    for name, (proc, tmp, so, t0) in procs.items():
        out, _ = proc.communicate()
        secs[name] = time.monotonic() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed:\n{out}")
            continue
        if verbose and out:
            print(out)
        os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


_vp, _ll, _ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# launch functions and their argument types, per source
_LAUNCH = {
    "canonical_kmers": {"canonical_all_kmers_launch":
                        [_vp, _ll, _vp, _ll, _ci, _vp]},
    "count_runs": {"count_sorted_runs_launch":
                   [ctypes.POINTER(_vp), _ci, _ci, _ci, _vp, _vp, _vp, _ll,
                    _vp],
                   "count_runs_tile": []},
    "merge_pairs": {"merge_pairs_launch":
                    [_vp, _vp, _vp, _vp, _ll, _ci, _vp]},
    "merge_path": {"merge_path_launch":
                   [_vp, _vp, _vp, _vp, _ll, _ci, _ci, _vp],
                   "merge_path_splits_launch":
                   [_vp, _vp, _vp, _vp, _ll, _ci, _ci, _vp]},
}


def _lib(name: str) -> ctypes.CDLL:
    with _build_lock:
        if name not in _libs:
            build_kernels()
            lib = ctypes.CDLL(_so_path(name))
            for fn, argtypes in _LAUNCH[name].items():
                getattr(lib, fn).restype = _ci
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return _libs[name]


def _check(t: torch.Tensor, what: str, dtype=torch.int32) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous 1-D tensor")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


# ---------------------------------------------------------------------------
# kernel 1: canonical k-mers at every base offset
# ---------------------------------------------------------------------------


def canonical_all_kmers_plain(packed: torch.Tensor, k: int
                              ) -> torch.Tensor:
    """Canonical k-mer keys at every base offset of the packed (P,)
    int32 pool, as (W, q_padded*16) int32 in the PHASE-GROUPED layout:
    within each block of BLOCK_Q window starts, column r*BLOCK_Q + q
    holds the key at base offset q*16 + r. Tail windows read zero
    padding words."""
    w = kmerops.words_per_kmer(k)
    p = packed.shape[0]
    q_pad = q_padded(p, k)
    words = kmerops.u32_value(packed)
    if q_pad + w > p:
        words = torch.cat([words, words.new_zeros(q_pad + w - p)])
    keys = kmerops.extract_all_kmers(words[:q_pad + w], k)
    keys = keys.reshape(q_pad // BLOCK_Q, BLOCK_Q, 16, w)
    keys = keys.transpose(1, 2).reshape(q_pad * 16, w)
    canon, _ = kmerops.canonical_kmers(keys, k)
    return kmerops.i32_bits(canon.T.contiguous())


def canonical_all_kmers(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Kernel wrapper of canonical_all_kmers_plain (same contract).

    Replaces megahit_tpu/core/pallas_kernels.py:105
    canonical_all_kmers_pallas (kernel body _canon_kernel). Bound on
    an H100 by bytes: the pool read once (4 B a word) plus W*4 B written
    per base offset. One launch a call and no copy of the pool: the
    kernel reads any contiguous pool (16-B aligned or not) and reads the
    words past its end as zero. A block copies its window starts' words
    into shared memory once (a bulk copy where the pool is aligned), a
    thread takes V consecutive window starts and all 16 phases from
    registers, and each key plane's V words of a phase go out as one
    streaming 16-B store (8-B above W = 12)."""
    _check(packed, "packed")
    if not 1 <= k <= 255:
        raise ValueError(f"k must be in [1, 255], got {k}")
    w = kmerops.words_per_kmer(k)
    if packed.shape[0] <= w:
        raise ValueError("packed pool shorter than one k-mer")
    if packed.device.type == "cpu":
        return canonical_all_kmers_plain(packed, k)
    p = packed.shape[0]
    n_out = q_padded(p, k) * 16
    out = torch.empty((w, n_out), dtype=torch.int32, device=packed.device)
    lib = _lib("canonical_kmers")
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    err = lib.canonical_all_kmers_launch(
        packed.data_ptr(), p, out.data_ptr(), n_out, k, stream)
    canonical_all_kmers.launches += 1
    _raise_on(err, "canonical_all_kmers")
    return out


canonical_all_kmers.launches = 0


# ---------------------------------------------------------------------------
# kernel 2: run-length count over sorted key columns
# ---------------------------------------------------------------------------


def count_sorted_runs_plain(cols, n_inv: int):
    """Run-length count over sorted SoA key columns (any int dtype).

    head[i]: row i differs from row i-1 (row 0 always). counts[i] =
    (next head after i) - i on head rows, 0 elsewhere; the final run
    loses the n_inv invalid (sentinel) rows, and a head whose count
    drops to 0 is cleared. Returns (head bool, counts int32)."""
    n = cols[0].shape[0]
    dev = cols[0].device
    head = torch.zeros(n, dtype=torch.bool, device=dev)
    head[0] = True
    for c in cols:
        head[1:] |= c[1:] != c[:-1]
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    head_pos = torch.where(head, idx, n)
    nh = kmerops.cummin_reverse(head_pos)
    nh = torch.cat([nh[1:], nh.new_full((1,), n)])
    counts = nh - idx
    counts = torch.where(nh == n, counts - int(n_inv), counts)
    counts = torch.where(head, counts, 0)
    return head & (counts > 0), counts.to(torch.int32)


def count_sorted_runs(cols, n_inv: int):
    """Kernel wrapper of count_sorted_runs_plain for int32 columns.

    Replaces megahit_tpu/core/pallas_kernels.py:286
    count_sorted_runs_pallas (kernel body _count_kernel, dispatcher
    count_sorted_runs_device). Bound on an H100 by bytes: W*4 B read
    and 5 B written per row. The TPU kernel walks its grid last block
    first and carries the suffix-min of head positions from step to
    step; blocks on Hopper run in no order. One launch (after one
    memset of its scratch) replaces the port's first three passes
    (heads and block minima, a one-block carry, finish), which sent the
    head flags through device memory twice and ran the carry on one
    block: tiles of 4096 rows are taken last first from an atomic
    ticket, each thread keeps the head flags of its 16 rows (4 groups of
    4, so that a warp's 16-B loads and stores are contiguous) in a
    register mask, the next head inside a tile comes from bit scans,
    shuffles and shared memory, and a decoupled look-ahead
    over per-tile descriptors brings the first head of the later tiles:
    a tile with a head publishes it at once, a headless one reads ahead
    until it finds one. On the card n is at most 2^31 minus a tile (rows
    are 32-bit ints there); no padding, columns at any 4-B offset
    (scalar loads where one is not 16-B aligned)."""
    cols = tuple(cols)
    if not 1 <= len(cols) <= 16:
        raise ValueError(f"1..16 key columns expected, got {len(cols)}")
    n = cols[0].shape[0]
    dev = cols[0].device
    for i, c in enumerate(cols):
        _check(c, f"cols[{i}]", dtype=c.dtype if dev.type == "cpu"
               else torch.int32)
        if c.shape[0] != n or c.device != dev:
            raise ValueError("key columns differ in length or device")
    if n < 1:
        raise ValueError(f"row count must be at least 1, got {n}")
    if not 0 <= n_inv <= n:
        raise ValueError(f"n_inv must be in [0, {n}], got {n_inv}")
    if dev.type == "cpu":
        return count_sorted_runs_plain(cols, n_inv)
    tile = count_runs_tile()
    if n > 2 ** 31 - tile:
        raise ValueError(f"row count must be at most {2 ** 31 - tile} on "
                         f"the card, got {n}")
    head = torch.empty(n, dtype=torch.uint8, device=dev)
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    # per-tile descriptors and the ticket, zeroed by the launch function
    scratch = torch.empty(-(-n // tile) + 1, dtype=torch.int64, device=dev)
    ptrs = (ctypes.c_void_p * len(cols))(*[c.data_ptr() for c in cols])
    lib = _lib("count_runs")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.count_sorted_runs_launch(
        ptrs, len(cols), n, int(n_inv), head.data_ptr(),
        counts.data_ptr(), scratch.data_ptr(), scratch.numel(), stream)
    count_sorted_runs.launches += 1
    _raise_on(err, "count_sorted_runs")
    return head.view(torch.bool), counts


count_sorted_runs.launches = 0


def count_runs_tile() -> int:
    """Rows per tile of count_sorted_runs' kernel (count_runs.cu's
    kTile, read from the built library)."""
    return _lib("count_runs").count_runs_tile()
