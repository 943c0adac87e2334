"""Merge sort of the (u32, u16) k-mer key planes: two merge kernels.

The keys are 48 bits, a u32 ``hi`` plane and a u16 ``lo`` plane, sorted
ascending as the u64 ``hi << 16 | lo``, keys only (equal keys are
interchangeable). ``hi`` rides as int32 carrying the u32 bits and ``lo``
as int16 carrying the u16 bits, so a merge level moves 6 B a key each
way, as on the TPU.

``sort_planes`` sorts rows of ``init_run`` keys with one batched
``torch.sort`` and then merges pairs of runs level by level: with
kernel 3 (``merge_pairs``, csrc/merge_pairs.cu) while a pair fits one
block's tile, with kernel 4 (``merge_path_level``, csrc/merge_path.cu)
once the runs are longer (``merge_levels`` lists them). Both kernels
have one plain PyTorch version, ``merge_pairs_plain``, the row sort of
each pair, which the CPU tests use and ``chip_smoke.py`` holds the
kernels to on the card; a wrapper takes the plain version only for
tensors on the CPU, counts its launches on ``wrapper.launches``, and
raises on a CUDA tensor it cannot take.

No stage of the pipeline sorts with this, as in megahit_tpu, whose
production sorts stay with ``lax.sort``; here they stay with
``torch.sort``. Counterpart of megahit_tpu/core/sortnet.py.
"""

from __future__ import annotations

import functools

import torch

from . import kernels

# Defaults for the card: a Hopper block has at most 227 KB of shared
# memory (the TPU kernels had megabytes of VMEM and used 8192 / 65536).
# Both kernels keep two tiles of 8192 keys in a ring (96 KB, two blocks
# an SM); 8192 is kernel 4's largest tile and kernel 3's slot of whole
# pairs. The first two merge levels at 2^24 keys (runs of 2048 and 4096)
# go through kernel 3 and the rest through kernel 4. The sorted result
# does not depend on either value.
INIT_RUN = 2048
MAX_TILE = 8192


def pack_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(int32 u32 bits, int16 u16 bits) -> non-negative int64 keys, so
    signed order is the unsigned 48-bit order."""
    return ((hi.to(torch.int64) & 0xFFFFFFFF) << 16) | (
        lo.to(torch.int64) & 0xFFFF)


def unpack_key(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of pack_key -> (hi int32, lo int16)."""
    hi = key >> 16
    lo = key & 0xFFFF
    hi = torch.where(hi >= 1 << 31, hi - (1 << 32), hi).to(torch.int32)
    lo = torch.where(lo >= 1 << 15, lo - (1 << 16), lo).to(torch.int16)
    return hi, lo


def _check_planes(hi: torch.Tensor, lo: torch.Tensor) -> None:
    if not isinstance(hi, torch.Tensor) or not isinstance(lo, torch.Tensor):
        raise TypeError("hi and lo must be tensors")
    if hi.dtype != torch.int32 or lo.dtype != torch.int16:
        raise TypeError(f"expected int32 hi and int16 lo, got {hi.dtype} "
                        f"and {lo.dtype}")
    if hi.dim() != 1 or hi.shape != lo.shape:
        raise ValueError("hi and lo must be 1-D and of one length")
    if not (hi.is_contiguous() and lo.is_contiguous()):
        raise ValueError("hi and lo must be contiguous")
    if hi.device != lo.device or hi.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported devices {hi.device}, {lo.device}")


def _check_level(n: int, run_len: int) -> None:
    if run_len <= 0 or run_len & (run_len - 1):
        raise ValueError(f"run_len must be a power of two, got {run_len}")
    if n % (2 * run_len):
        raise ValueError(f"{n} keys are not whole pairs of {run_len}-runs")


# ---------------------------------------------------------------------------
# kernel 3: merge levels where a pair of runs fits one tile
# ---------------------------------------------------------------------------


def merge_pairs_plain(hi, lo, run_len: int):
    """Each pair of sorted runs of run_len keys -> one sorted run of
    2 * run_len (a row sort of the packed keys)."""
    key = pack_key(hi, lo).reshape(-1, 2 * run_len)
    return unpack_key(torch.sort(key, dim=1).values.reshape(-1))


def merge_pairs(hi, lo, run_len: int):
    """Kernel wrapper of merge_pairs_plain (same contract).

    Replaces megahit_tpu/core/sortnet.py:224 _merge_level_aligned
    (kernel body _merge_pair_kernel). Bound on an H100 by bytes, 12 B a
    key. Kernel 4's pipeline (merge_common.cuh) with no split search:
    persistent blocks walk slots of 8192 keys (whole pairs); a producer
    warp bulk-copies the next slot into a two-slot ring in shared memory
    while 8 warps merge the current one, 32 ranks a thread inside its own
    pair, and store it in 16-B vectors through a bank-conflict-free
    staging layout. Any power-of-two run_len with 2 * run_len at most the
    kernel's kMaxPair, 32768 (merge_pairs.cu); on the card a longer one
    raises."""
    _check_planes(hi, lo)
    n = hi.shape[0]
    _check_level(n, run_len)
    if hi.device.type == "cpu":
        return merge_pairs_plain(hi, lo, run_len)
    out_hi, out_lo = torch.empty_like(hi), torch.empty_like(lo)
    lib = kernels._lib("merge_pairs")
    stream = torch.cuda.current_stream(hi.device).cuda_stream
    err = lib.merge_pairs_launch(hi.data_ptr(), lo.data_ptr(),
                                 out_hi.data_ptr(), out_lo.data_ptr(), n,
                                 run_len, stream)
    kernels._raise_on(err, "merge_pairs")
    merge_pairs.launches += 1
    return out_hi, out_lo


merge_pairs.launches = 0


# ---------------------------------------------------------------------------
# kernel 4: merge levels for runs longer than a tile (merge path)
# ---------------------------------------------------------------------------


def merge_path_level(hi, lo, run_len: int, tile: int):
    """Kernel wrapper of merge_pairs_plain (same contract: the tiling
    changes how the level is computed, not its result).

    Replaces megahit_tpu/core/sortnet.py:363 _merge_level_path (kernel
    from _make_path_kernel, splits from _merge_path_splits). Bound on an
    H100 by bytes, 12 B a key. Persistent blocks walk contiguous ranges
    of output tiles: a producer warp finds the next tile's split with a
    32-way warp search in device memory (as merge_path_splits does) and
    bulk-copies its A and B windows into a two-slot ring in shared
    memory while the block's other 8 warps merge the current tile (one
    merge-path search and 32 ranks a thread) and store it in 16-B
    vectors through a bank-conflict-free staging layout. tile divides
    run_len and is at most the kernel's kTile, 8192
    (merge_path.cu)."""
    _check_planes(hi, lo)
    n = hi.shape[0]
    _check_level(n, run_len)
    if tile <= 0 or tile & (tile - 1) or tile > run_len:
        raise ValueError(f"tile must be a power of two <= run_len "
                         f"({run_len}), got {tile}")
    if hi.device.type == "cpu":
        return merge_pairs_plain(hi, lo, run_len)
    out_hi, out_lo = torch.empty_like(hi), torch.empty_like(lo)
    lib = kernels._lib("merge_path")
    stream = torch.cuda.current_stream(hi.device).cuda_stream
    err = lib.merge_path_launch(hi.data_ptr(), lo.data_ptr(),
                                out_hi.data_ptr(), out_lo.data_ptr(), n,
                                run_len, tile, stream)
    kernels._raise_on(err, "merge_path_level")
    merge_path_level.launches += 1
    return out_hi, out_lo


merge_path_level.launches = 0


# ---------------------------------------------------------------------------
# kernel 4's split search, alone
# ---------------------------------------------------------------------------


def merge_path_splits_plain(hi, lo, run_len: int, tile: int):
    """Per output tile of a merge level: (a_from, a_to), int32, the
    A-run range [a_from, a_to) that feeds the tile's merged ranks
    [q_lo, q_lo + tile) of its pair, q_lo the tile's offset in the pair.
    Ties go to A: among the first q merged keys of a pair, the A count
    is the largest a with a == max(0, q - run_len) or
    A[a - 1] <= B[q - a]."""
    key = pack_key(hi, lo)
    n = key.shape[0]
    t = torch.arange(n // tile, dtype=torch.int64, device=key.device)
    pair_start = (t * tile) // (2 * run_len) * (2 * run_len)
    q_lo = t * tile - pair_start

    def split(q):
        lo_a = torch.clamp(q - run_len, min=0)
        hi_a = torch.clamp(q, max=run_len)
        active = lo_a < hi_a
        while bool(active.any()):
            a = (lo_a + hi_a + 1) // 2
            ai = torch.clamp(pair_start + a - 1, 0, n - 1)
            bi = torch.clamp(pair_start + run_len + q - a, 0, n - 1)
            ok = key[ai] <= key[bi]
            lo_a = torch.where(active & ok, a, lo_a)
            hi_a = torch.where(active & ~ok, a - 1, hi_a)
            active = lo_a < hi_a
        return lo_a.to(torch.int32)

    return split(q_lo), split(q_lo + tile)


def merge_path_splits(hi, lo, run_len: int, tile: int):
    """Kernel wrapper of merge_path_splits_plain: the split search of
    merge_path_level's blocks (the same device function), run alone so
    that it can be held to its plain version. A check, not a merge
    level: nothing on the sort's path calls it, and it counts no
    launches."""
    _check_planes(hi, lo)
    n = hi.shape[0]
    _check_level(n, run_len)
    if tile <= 0 or tile & (tile - 1) or tile > run_len:
        raise ValueError(f"tile must be a power of two <= run_len "
                         f"({run_len}), got {tile}")
    if hi.device.type == "cpu":
        return merge_path_splits_plain(hi, lo, run_len, tile)
    a_from = torch.empty(n // tile, dtype=torch.int32, device=hi.device)
    a_to = torch.empty_like(a_from)
    lib = kernels._lib("merge_path")
    stream = torch.cuda.current_stream(hi.device).cuda_stream
    err = lib.merge_path_splits_launch(hi.data_ptr(), lo.data_ptr(),
                                       a_from.data_ptr(), a_to.data_ptr(),
                                       n, run_len, tile, stream)
    kernels._raise_on(err, "merge_path_splits")
    return a_from, a_to


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------


def sort_rows(hi, lo, init_run: int):
    """sort_planes' first step: every row of init_run keys sorted with
    one batched torch.sort of the packed keys."""
    n = hi.shape[0]
    key = pack_key(hi, lo).reshape(n // init_run, init_run)
    return unpack_key(torch.sort(key, dim=1).values.reshape(n))


def merge_levels(n: int, init_run: int = INIT_RUN,
                 max_tile: int = MAX_TILE) -> list:
    """sort_planes' merge levels on n keys after sort_rows: (run_len,
    merge) per level, merge(hi, lo) the kernel wrapper that merges each
    pair of run_len-runs: kernel 3 while a pair fits max_tile, kernel 4
    after (megahit_tpu's rule). Empty where n takes the plain sort:
    below 2 * init_run or not a power of two."""
    if n < 2 * init_run or n & (n - 1):
        return []
    levels, run = [], init_run
    while run < n:
        if 2 * run <= max_tile:
            merge = functools.partial(merge_pairs, run_len=run)
        else:
            merge = functools.partial(merge_path_level, run_len=run,
                                      tile=max_tile)
        levels.append((run, merge))
        run *= 2
    return levels


def sort_planes(hi, lo, init_run: int = INIT_RUN, max_tile: int = MAX_TILE):
    """Ascending keys-only sort of the 48-bit (hi, lo) planes.

    n a power of two and at least 2 * init_run takes sort_rows and the
    merge levels; any other n is one torch.sort of the packed keys.
    Returns (hi int32, lo int16) on the planes' device."""
    _check_planes(hi, lo)
    levels = merge_levels(hi.shape[0], init_run, max_tile)
    if not levels:
        return unpack_key(torch.sort(pack_key(hi, lo)).values)
    hi, lo = sort_rows(hi, lo, init_run)
    for _, merge in levels:
        hi, lo = merge(hi, lo)
    return hi, lo
