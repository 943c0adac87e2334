"""Memory-bounded (out-of-core) SdBG construction.

Re-expression of the reference CX1 engine's defining capability:
building graphs larger than memory by streaming prefix buckets through
a fixed budget (reference AdjustMemory + the Lv1-bucket-round loop,
src/sorting/base_engine.cpp:14-141,176-281).

Design:
  * ONE streaming pass extracts window rows (key words + multiplicity
    word) chunk by chunk on the device and partitions them on the host
    into 256 spill files by the top 8 bits of the key (order-preserving
    prefix buckets).
  * Rounds = runs of consecutive buckets whose total row count fits the
    budget (reference Lv1FindEndBuckets). Keys equal each other only
    within one bucket, so rounds never split a key group.
  * Pass 2 sorts each round in one sort on the device (on the CPU the
    host's row sort), dedups with max/sum multiplicity (the mult word is
    the LAST sort word) and appends the round's edges; rounds are in
    prefix order, so the concatenation is the globally sorted edge set.
    Navigation derives lazily from it inside Sdbg.

Working-set memory is bounded by the round budget; the full window
multiset only ever exists on disk. The spill pass is double-buffered
(host partition+write overlaps the next chunk's extraction) and round
reads prefetch under the sorts.

Spans (utils/timers.py), on the calling thread: `spill`, with one
`extract` a chunk (extraction on the device, download, reverse
complements, row fill) and `write_wait` (blocked on the writer thread),
and one `round` a round, with `read_wait` (the prefetched spill read),
`sort` and `dedup`; counters `rows` and `spill_bytes` on `spill` and on
each `round`.

With shard_dir, each round's edges also stream to the sharded graph
files (graph/sdbg.py ShardedSdbgWriter). With a mesh, each round is one
sample sort over the mesh's shards (parallel/shuffle.py).

Counterpart of megahit_tpu/graph/bucketed.py.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import kmerops
from ..utils.device import resolve_device
from ..utils.log import get_logger
from ..utils.timers import count, span
from .counter import KMAX_MUL, _chunks, as_pool
from .sdbg import Sdbg, ShardedSdbgWriter, _make_sdbg, sdbg_from_edges

N_BUCKETS = 256  # spill files: top 8 bits of word0 = first 4 bases


def np_revcomp(keys: np.ndarray, k: int) -> np.ndarray:
    """Reverse complements of (N, W) host keys, as a contiguous array."""
    return np.ascontiguousarray(kmerops.revcomp_kmers(keys, k))


# ---------------------------------------------------------------------------
# spill files
# ---------------------------------------------------------------------------


class SpillSet:
    """256 append-only raw files of fixed-width uint32 rows, bucketed by
    the top 8 bits of each row's first word (the analogue of the
    reference's per-thread bucket-sharded files, sdbg_writer.h:19-63)."""

    def __init__(self, dir_: str, name: str, row_words: int):
        os.makedirs(dir_, exist_ok=True)
        self.paths = [
            os.path.join(dir_, f"{name}.{b:03d}.bin")
            for b in range(N_BUCKETS)
        ]
        self.row_words = row_words
        self.counts = np.zeros(N_BUCKETS, dtype=np.int64)
        for p in self.paths:
            if os.path.exists(p):
                os.remove(p)
        # persistent append handles: reopening 256 files per append
        # costs more than the writes at high batch counts
        self._fhs: dict[int, object] = {}

    def _fh(self, i: int):
        fh = self._fhs.get(i)
        if fh is None:
            fh = open(self.paths[i], "ab")
            self._fhs[i] = fh
        return fh

    def _close_fhs(self) -> None:
        for fh in self._fhs.values():
            fh.close()
        self._fhs.clear()

    def append(self, rows: np.ndarray) -> None:
        """rows: (N, row_words) uint32; bucketed by rows[:,0] >> 24."""
        if not len(rows):
            return
        b8 = (rows[:, 0] >> np.uint32(24)).astype(np.uint8)
        order = np.argsort(b8, kind="stable")  # numpy radix on u8
        rows = rows[order]
        sizes = np.bincount(b8, minlength=N_BUCKETS).astype(np.int64)
        self.counts += sizes
        offs = np.zeros(N_BUCKETS + 1, dtype=np.int64)
        np.cumsum(sizes, out=offs[1:])
        for i in np.nonzero(sizes)[0]:
            self._fh(i).write(rows[offs[i]:offs[i + 1]].tobytes())

    def read_range(self, lo: int, hi: int) -> np.ndarray:
        """All rows of buckets [lo, hi) (file append order)."""
        self._close_fhs()  # flush buffered appends before any read
        parts = [
            np.fromfile(self.paths[i], dtype=np.uint32)
            .reshape(-1, self.row_words)
            for i in range(lo, hi) if self.counts[i]
        ]
        if not parts:
            return np.zeros((0, self.row_words), np.uint32)
        return np.concatenate(parts, axis=0)

    def cleanup(self) -> None:
        self._close_fhs()
        for p in self.paths:
            if os.path.exists(p):
                os.remove(p)


def round_cap_rows() -> int:
    """Performance cap on rows per round, independent of the -m budget:
    a single giant round defeats the spill-read prefetch overlap. The
    budget remains the hard memory bound; this only splits finer.
    MEGAHIT_TPU_TORCH_ROUND_CAP_ROWS overrides the default 2^26."""
    return int(os.environ.get("MEGAHIT_TPU_TORCH_ROUND_CAP_ROWS", 1 << 26))


def plan_rounds(counts: np.ndarray, budget_rows: int
                ) -> list[tuple[int, int]]:
    """Greedy contiguous bucket ranges with total rows <= budget
    (reference Lv1FindEndBuckets, base_engine.cpp:254-281). A single
    bucket larger than the budget becomes its own (oversized) round."""
    log = get_logger()
    budget_rows = min(budget_rows, max(round_cap_rows(), 1 << 14))
    rounds = []
    lo = 0
    while lo < N_BUCKETS:
        hi = lo + 1
        total = int(counts[lo])
        if total > budget_rows:
            log.warning(
                "bucket %d has %d rows > budget %d; processing oversized",
                lo, total, budget_rows,
            )
        while hi < N_BUCKETS and total + int(counts[hi]) <= budget_rows:
            total += int(counts[hi])
            hi += 1
        rounds.append((lo, hi))
        lo = hi
    return rounds


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------


@dataclass
class PoolSource:
    """A packed sequence pool: every k-window of every sequence, both
    strands, carrying its sequence's multiplicity. flat_codes may be
    raw u8 codes or a PackedPool (streamed in bounded windows)."""

    flat_codes: np.ndarray
    starts: np.ndarray
    mults: np.ndarray  # (S,) int32 per-sequence


@dataclass
class EdgeSource:
    """Canonical edges + counts (counter/mercy/iterate outputs); the rc
    strand is implied."""

    keys: np.ndarray
    counts: np.ndarray


def _spill_pool(spill: SpillSet, src: PoolSource, k: int,
                batch_windows: int, device, unit: bool = False) -> int:
    """Stream-extract all window rows of a pool into the spill set.

    Fully windowed: only one chunk of packed words / validity / mults
    is resident, so the pass handles pools larger than RAM. The windows
    of a chunk are extracted on `device`; masking, reverse complements
    and the spill writes run on the host. Returns total rows spilled."""
    w = kmerops.words_per_kmer(k)
    if int(src.starts[-1]) < k:
        return 0
    pool = as_pool(src.flat_codes)
    mults = np.asarray(src.mults, dtype=np.int32)
    chunk = max(1 << 16, (batch_windows + 15) & ~15)
    total = 0
    # double-buffered: the host partition+write of chunk i overlaps the
    # extraction of chunk i+1; SpillSet state is touched only by the
    # single writer thread during the loop
    pending = None
    with ThreadPoolExecutor(max_workers=1) as ex:
        for lo, words, vm in _chunks(pool, src.starts, k, chunk):
            with span("extract"):
                fwd = kmerops.to_numpy(kmerops.extract_all_kmers(
                    kmerops.to_torch(words, device), k))[vm]
                rc = np_revcomp(fwd, k)
                n = len(fwd)
                if unit:
                    # every window contributes multiplicity 1: no mult
                    # word is spilled (dedup counts group sizes instead)
                    rows = np.empty((2 * n, w), np.uint32)
                    rows[:n] = fwd
                    rows[n:] = rc
                else:
                    posv = np.flatnonzero(vm) + lo
                    mm = mults[np.searchsorted(src.starts, posv,
                                               side="right") - 1]
                    rows = np.empty((2 * n, w + 1), np.uint32)
                    rows[:n, :w] = fwd
                    rows[n:, :w] = rc
                    rows[:n, w] = mm
                    rows[n:, w] = mm
            if pending is not None:
                with span("write_wait"):
                    pending.result()
            pending = ex.submit(spill.append, rows)
            total += len(rows)
        if pending is not None:
            with span("write_wait"):
                pending.result()
    return total


def _spill_edges(spill: SpillSet, src: EdgeSource, k: int) -> int:
    keys = np.asarray(src.keys, dtype=np.uint32)
    if not len(keys):
        return 0
    counts = np.asarray(src.counts, dtype=np.uint32)
    w = keys.shape[1]
    rc = np_revcomp(keys, k)
    rows = np.empty((2 * len(keys), w + 1), np.uint32)
    rows[: len(keys), :w] = keys
    rows[len(keys):, :w] = rc
    rows[: len(keys), w] = counts
    rows[len(keys):, w] = counts
    spill.append(rows)
    return len(rows)


# ---------------------------------------------------------------------------
# round sorts
# ---------------------------------------------------------------------------


def _sort_on_host(device) -> bool:
    """CPU rounds sort on the host (native row sort); tests patch this
    to run the card's route on CPU tensors."""
    return torch.device(device).type == "cpu"


def _sort_rows(rows: np.ndarray, device, mesh=None) -> np.ndarray:
    """Sort (N, C) uint32 rows lexicographically: one sort of the whole
    round on `device` (on the CPU the host's native row sort), or with a
    mesh one sample sort over its shards. Every column is a key, so the
    sort's stability does not change the result."""
    if len(rows) == 0:
        return rows
    if mesh is not None:
        from ..parallel.shuffle import sharded_sort_kmers

        # the sample sort drops all-ones rows as padding; a round's rows
        # never are (the mult word is bounded, and without one k % 16
        # leaves zero pad bits)
        out = sharded_sort_kmers(rows, mesh)
        assert len(out) == len(rows), (len(out), len(rows))
        return out
    if _sort_on_host(device):
        return kmerops.sort_keys_with_payload(rows)[0]
    (srows,) = kmerops.sort_keys_with_payload(
        kmerops.to_torch(rows, device))
    return kmerops.to_numpy(srows)


def _halve_palindromes(edges: np.ndarray, sums: np.ndarray, k: int
                       ) -> np.ndarray:
    """Palindromic keys (possible: the edge length k is even) received
    BOTH strand rows of each window into ONE group, so their window
    count arrived doubled; the reference counter counts each canonical
    window once (kmer_counter.cpp:137-144). Cheap prefilter: a
    palindrome's first base must complement its last. Mutates and
    returns sums."""
    first_b = edges[:, 0] >> np.uint32(30)
    lw, sh = (k - 1) >> 4, 30 - 2 * ((k - 1) & 15)
    last_b = (edges[:, lw] >> np.uint32(sh)) & np.uint32(3)
    cand = np.flatnonzero(first_b == np.uint32(3) - last_b)
    if len(cand):
        rcc = np_revcomp(edges[cand], k)
        pal = cand[(rcc == edges[cand]).all(axis=1)]
        sums[pal] >>= 1
    return sums


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------


@dataclass
class BuildStats:
    n_rounds: int = 0
    max_round_rows: int = 0
    total_spilled_rows: int = 0
    n_edges: int = 0
    round_ranges: list = field(default_factory=list)


def _round_edges(srows: np.ndarray, w: int, k: int, unit: bool,
                 mult_mode: str, min_count: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """A round's sorted rows deduplicated: (edges, multiplicities), the
    groups below min_count dropped in the summing modes."""
    keys = srows[:, :w]
    head = np.empty(len(keys), dtype=bool)
    head[0] = True
    np.any(keys[1:] != keys[:-1], axis=1, out=head[1:])
    tail = np.empty_like(head)
    tail[:-1] = head[1:]
    tail[-1] = True
    edges = np.ascontiguousarray(keys[tail])
    if unit:
        # group sizes ARE the sums (every contribution is 1)
        idx = np.flatnonzero(tail)
        sums = np.empty(len(idx), dtype=np.int64)
        sums[0] = idx[0] + 1
        np.subtract(idx[1:], idx[:-1], out=sums[1:])
    elif mult_mode == "max":
        # mult is the LAST sort word, so the tail row is the max
        return edges, np.minimum(srows[tail, w], KMAX_MUL).astype(np.int32)
    else:
        # group sums via cumulative-sum differences at tails
        cs = np.cumsum(srows[:, w], dtype=np.int64)
        sums = np.diff(np.concatenate([[0], cs[tail]]))
    sums = _halve_palindromes(edges, sums, k)
    mult = np.minimum(sums, KMAX_MUL).astype(np.int32)
    if min_count > 1:
        solid = sums >= min_count
        edges = edges[solid]
        mult = mult[solid]
    return edges, mult


def build_sdbg_bucketed(
    sources: list,
    k: int,
    budget_rows: int,
    spill_dir: str,
    batch_windows: int = 1 << 21,
    stats: BuildStats | None = None,
    mult_mode: str = "max",
    min_count: int = 1,
    device="cuda",
    shard_dir: str | None = None,
    mesh=None,
) -> Sdbg:
    """Build the SdBG from any mix of PoolSource/EdgeSource inputs with
    a bounded in-memory working set (<= ~budget_rows rows per device
    sort). The multiset itself lives on disk under `spill_dir`.

    mult_mode:
      "max"   - dedup keeps the maximum contribution (seq2sdbg
                semantics, seq_to_sdbg.cpp:640-643); identical to
                sdbg._finalize_sdbg over the union multiset.
      "count" - dedup SUMS contributions and drops groups below
                min_count: the 1-pass read2sdbg semantics (the
                both-strand group size of edge e equals occ(e) +
                occ(rc(e)), i.e. the canonical k-mer count, so counts
                match the 2-pass counter exactly).

    shard_dir: when set, each round's edges ALSO stream to a
    ShardedSdbgWriter there (per-shard files + bucket manifest,
    reference sdbg_writer.h:19-63) - rounds are bucket ranges in
    prefix order, so the shard layout falls straight out of the build.

    mesh: when set (parallel.multihost.Mesh), every round's sort is a
    sample sort over its shards; extraction stays on `device`.
    """
    device = resolve_device(device)
    log = get_logger()
    w = kmerops.words_per_kmer(k)
    st = stats if stats is not None else BuildStats()

    # unit-multiplicity fast path: every contribution is 1 (read windows
    # in count mode), so the mult word is never spilled; dedup counts
    # group sizes instead. Requires k % 16 != 0 so real keys always have
    # zero pad bits in the last word and sort strictly below the
    # all-ones sentinel rows.
    unit = (
        mult_mode == "count"
        and k % 16 != 0
        and all(isinstance(s, PoolSource)
                and bool(np.all(np.asarray(s.mults) == 1))
                for s in sources)
    )
    row_words = w if unit else w + 1

    # ---- pass 1: spill the window multiset, bucketed by key prefix
    spill = SpillSet(spill_dir, "edges", row_words)
    total = 0
    with span("spill") as spilled:
        for src in sources:
            if isinstance(src, PoolSource):
                total += _spill_pool(spill, src, k, batch_windows, device,
                                     unit=unit)
            elif isinstance(src, EdgeSource):
                total += _spill_edges(spill, src, k)
            else:
                raise TypeError(f"unknown source {type(src)}")
        count("rows", total)
        count("spill_bytes", total * row_words * 4)
    st.total_spilled_rows = total
    if total == 0:
        spill.cleanup()
        return sdbg_from_edges(np.zeros((0, w), np.uint32),
                               np.zeros(0, np.int32), k, device=device)

    rounds = plan_rounds(spill.counts, budget_rows)
    st.n_rounds = len(rounds)
    st.round_ranges = rounds
    log.info(
        "bucketed build k=%d: %d rows spilled in %.2fs, %d rounds "
        "(budget %d)", k, total, spilled.seconds, len(rounds),
        budget_rows)

    # ---- pass 2: per-round sort + dedup; rounds are in prefix order,
    # so concatenating their edges yields the globally sorted edge set
    all_keys = []
    all_mult = []
    shard_writer = None
    if shard_dir is not None:
        shard_writer = ShardedSdbgWriter(shard_dir, k)
    # prefetch each round's spill files while the previous round sorts
    with ThreadPoolExecutor(max_workers=1) as ex:
        nxt_fut = ex.submit(spill.read_range, *rounds[0])
        for ri, (lo, hi) in enumerate(rounds):
            with span("round") as rnd:
                with span("read_wait"):
                    rows = nxt_fut.result()
                if ri + 1 < len(rounds):
                    nxt_fut = ex.submit(spill.read_range, *rounds[ri + 1])
                st.max_round_rows = max(st.max_round_rows, len(rows))
                count("rows", len(rows))
                count("spill_bytes", rows.nbytes)
                if len(rows) == 0:
                    continue
                with span("sort") as sort:
                    srows = _sort_rows(rows, device, mesh)
                del rows
                with span("dedup"):
                    edges, mult = _round_edges(srows, w, k, unit,
                                               mult_mode, min_count)
                n_rows = len(srows)
                del srows
                if shard_writer is not None:
                    shard_writer.append(edges, mult)
                all_keys.append(edges)
                all_mult.append(mult)
            log.info("bucketed round %d/%d (buckets %d-%d): %d rows, "
                     "%d edges, %.2fs (sort %.2fs)", ri + 1, len(rounds),
                     lo, hi - 1, n_rows, len(edges), rnd.seconds,
                     sort.seconds)
    spill.cleanup()
    if shard_writer is not None:
        shard_writer.finalize()

    keys = np.concatenate(all_keys, axis=0) if all_keys else \
        np.zeros((0, w), np.uint32)
    mult = np.concatenate(all_mult) if all_mult else \
        np.zeros(0, np.int32)
    st.n_edges = len(keys)
    return _make_sdbg(keys, mult, k, device=device)
