"""Memory-bounded (out-of-core) SdBG construction.

Re-expression of the reference CX1 engine's defining capability:
building graphs larger than memory by streaming prefix buckets through
a fixed budget (reference AdjustMemory + the Lv1-bucket-round loop,
src/sorting/base_engine.cpp:14-141,176-281).

Design:
  * ONE streaming pass makes the window rows (key words + multiplicity
    word) of each chunk on the device and puts them there in a stable
    order of the top 8 bits of the key (256 order-preserving prefix
    buckets); the host writes each bucket's slice to its spill file.
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
(the host writes of chunk i overlap chunk i+1's device work) and round
reads prefetch under the sorts.

Spans (utils/timers.py), on the calling thread: `spill`, with one
`extract` a chunk (on the device: extraction or upload, validity mask,
reverse complements, rows and their bucket order; the download) and
`write_wait` (blocked on the writer thread), and one `round` a round,
with `read_wait` (the prefetched spill read), `sort` and `dedup`;
counters `rows` and `spill_bytes` on `spill` and on each `round`.

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

    def append(self, blocks: list[tuple[np.ndarray, np.ndarray]]
               ) -> None:
        """blocks: (rows, sizes) pairs, each block's (N, row_words)
        uint32 rows in bucket order (by rows[:,0] >> 24), the first
        sizes[0] rows bucket 0's and so on. Each bucket's rows of every
        block are appended to its file in block order, in one write (a
        write call costs more than its bytes on some file systems)."""
        sizes = np.array([s for _, s in blocks], dtype=np.int64
                         ).reshape(-1, N_BUCKETS)
        offs = np.zeros((len(blocks), N_BUCKETS + 1), dtype=np.int64)
        np.cumsum(sizes, axis=1, out=offs[:, 1:])
        self.counts += sizes.sum(axis=0)
        for b in np.flatnonzero(sizes.sum(axis=0)):
            self._fh(b).write(b"".join(
                rows[o[b]:o[b + 1]] for (rows, _), o in zip(blocks, offs)))

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


# rows a step of the partition: a step's temporaries (int64 words,
# reverse complements, the sort's keys and order) scale with it, not
# with the chunk
_STEP = 1 << 19


def _bucketed_rows(fwd: torch.Tensor, mult: torch.Tensor | None, k: int
                   ) -> list[tuple[np.ndarray, np.ndarray]]:
    """The spill rows of keys `fwd` ((n, w) kmerops words on the device)
    and, where `mult` ((n,) int32) is given, of their multiplicity word:
    the n keys' rows, then their reverse complements', as host uint32
    words. In steps of _STEP rows, each put in a stable order of its
    bucket on the device and downloaded into one host array. Returns
    (step rows, the step's 256 bucket sizes) in row order: appended in
    that order, every bucket file gets its rows in the order of all 2n,
    as one stable partition would give."""
    n, w = fwd.shape
    out = np.empty((2 * n, w + (mult is not None)), np.uint32)
    dst = torch.from_numpy(out.view(np.int32))
    steps, sizes = [], []
    for at in [*range(0, n, _STEP), *range(n, 2 * n, _STEP)]:
        s = at % n
        keys = fwd[s:s + _STEP]
        if at >= n:
            keys = kmerops.revcomp_kmers(keys, k)
        b8 = (keys[:, 0] >> 24).to(torch.uint8)
        order = torch.sort(b8, stable=True)[1]
        rows = kmerops.i32_bits(keys)
        if mult is not None:
            rows = torch.cat([rows, mult[s:s + _STEP, None]], 1)
        dst[at:at + len(rows)].copy_(rows[order])
        steps.append(out[at:at + len(rows)])
        sizes.append(torch.bincount(b8, minlength=N_BUCKETS))
    if not steps:
        return []
    return list(zip(steps, torch.stack(sizes).cpu().numpy()))


def _spill_chunks(spill: SpillSet, chunks) -> int:
    """Append each chunk's steps (from the iterator `chunks`, which makes
    them on the device) on a writer thread, so that a chunk's writes
    overlap the next chunk's device work; SpillSet state is touched only
    by that thread during the loop. Returns the rows spilled."""
    total = 0
    pending = None
    with ThreadPoolExecutor(max_workers=1) as ex:
        for steps in chunks:
            if pending is not None:
                with span("write_wait"):
                    pending.result()
            pending = ex.submit(spill.append, steps)
            total += sum(len(rows) for rows, _ in steps)
        if pending is not None:
            with span("write_wait"):
                pending.result()
    return total


def _chunk_rows(batch_windows: int) -> int:
    """Windows (or edges) a chunk of the spill: a multiple of 16 (a
    whole packed word), at least 2^16."""
    return max(1 << 16, (batch_windows + 15) & ~15)


def _pool_keys(words: np.ndarray, vm: np.ndarray, lo: int, k: int,
               device, starts: torch.Tensor | None,
               mults: torch.Tensor | None
               ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """A pool chunk's valid windows (validity `vm`) as keys on `device`
    and, in the counted layout (`starts` and `mults` on the device),
    each window's sequence multiplicity."""
    valid = torch.from_numpy(vm).to(device)
    fwd = kmerops.extract_all_kmers(kmerops.to_torch(words, device),
                                    k)[valid]
    if mults is None:
        return fwd, None
    pos = torch.nonzero(valid).squeeze(1) + lo
    return fwd, mults[torch.searchsorted(starts, pos, right=True) - 1]


def _spill_pool(spill: SpillSet, src: PoolSource, k: int,
                batch_windows: int, device, unit: bool = False) -> int:
    """Stream-extract all window rows of a pool into the spill set.

    Fully windowed: only one chunk of packed words / validity / mults
    is resident, so the pass handles pools larger than RAM. Returns
    total rows spilled."""
    if int(src.starts[-1]) < k:
        return 0
    # the unit layout spills no multiplicity word: every window
    # contributes 1 (dedup counts group sizes instead)
    starts = mults = None
    if not unit:
        starts = torch.from_numpy(
            np.ascontiguousarray(src.starts, dtype=np.int64)).to(device)
        mults = torch.from_numpy(
            np.ascontiguousarray(src.mults, dtype=np.int32)).to(device)

    def chunks():
        for lo, words, vm in _chunks(as_pool(src.flat_codes), src.starts,
                                     k, _chunk_rows(batch_windows)):
            with span("extract"):
                steps = _bucketed_rows(
                    *_pool_keys(words, vm, lo, k, device, starts, mults),
                    k)
            yield steps

    return _spill_chunks(spill, chunks())


def _spill_edges(spill: SpillSet, src: EdgeSource, k: int,
                 batch_windows: int, device) -> int:
    """Spill an EdgeSource's rows (each key and its reverse complement,
    with the key's count as the multiplicity word), uploaded in chunks.
    Returns total rows spilled."""
    keys = np.asarray(src.keys, dtype=np.uint32)
    counts = np.asarray(src.counts, dtype=np.uint32)
    chunk = _chunk_rows(batch_windows)

    def chunks():
        for s in range(0, len(keys), chunk):
            with span("extract"):
                steps = _bucketed_rows(
                    kmerops.to_torch(keys[s:s + chunk], device),
                    torch.from_numpy(counts[s:s + chunk].view(np.int32))
                    .to(device), k)
            yield steps

    return _spill_chunks(spill, chunks())


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
                total += _spill_edges(spill, src, k, batch_windows,
                                      device)
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
