"""The succinct de Bruijn graph (run-based navigation).

Semantics (matching the reference SdBG, src/sdbg/sdbg.h): at parameter k,
graph EDGES are distinct k-mers and NODES are (k-1)-mers. An edge's source
node is its (k-1)-prefix, its target node its (k-1)-suffix. Both strands
are present (the edge set is closed under reverse complement).

Representation: the sorted multi-word k-mer keys plus a compact
RUN-based navigation core. Edges are sorted lexicographically, so all
edges sharing a source (k-1)-prefix form one CONSECUTIVE RUN of <= 4
rows. Navigation state:
    run_start[e] = first edge of e's prefix run
    nxt_link[e]  = first edge of the run whose prefix == suffix(e)
                   (-1 if no edge leaves e's target node)
    rc[e]        = index of e's reverse complement
All four neighbour-candidate sets fall out by strand symmetry:
    out-edges of target(e)  = run(nxt_link[e])
    out-edges of source(e)  = run(run_start[e])          (e's siblings)
    in-edges  of target(e)  = rc[run(run_start[rc[e]])]
    in-edges  of source(e)  = rc[run(nxt_link[rc[e]])]

The graph's arrays live on the host (numpy); ``Sdbg.device`` names the
device its whole-graph passes run on. On CUDA the tip and simple-path
passes are torch ops on that device; on the CPU they are the host
engine's sparse walks and native chain walks (the choice is
``utils.device.graph_on_card``).

Besides the one-file formats (`Sdbg.save`/`load`), a graph persists as
per-shard files with a bucket manifest (`save_sharded`,
`ShardedSdbgWriter`), in megahit_tpu's "sharded-v1" layout.

Counterpart of megahit_tpu/graph/sdbg.py (the out-of-core bucketed
builder is graph/bucketed.py).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..core import kmerops
from ..utils import device as devices
from ..utils.device import resolve_device
from ..utils.log import get_logger
from .counter import KMAX_MUL, _pow2_pad

NULL = np.int32(-1)

class Sdbg:
    """See module docstring for the representation.

    Core state is (k, keys, mult, valid) - ~10 B/edge in memory. The
    navigation core (run_start, nxt_link, rc) is DERIVED from the
    sorted keys on first navigation; `save` persists only the core, and
    only its canonical strand half (key <= rc(key)), ~5 B/edge at rest
    vs the reference's ~2 B/edge BWT shards (sdbg_item.h:14-24). A file
    in the oldest format carries eager (E, 4) candidate tables; the
    navigation core is read off them.
    """

    def __init__(self, k, keys, mult, rc=None, oc_t=None, oc_s=None,
                 valid=None, real=None, run_start=None, nxt_link=None,
                 device="cuda"):
        self.k = int(k)
        self.device = resolve_device(device)
        self.keys = keys
        self.mult = mult
        self.valid = valid if valid is not None \
            else np.ones(len(keys), dtype=bool)
        # number of non-padding rows (padding rows carry sentinel keys
        # and are excluded from nav derivation)
        self.real = len(keys) if real is None else int(real)
        self._rc = rc
        self._run_start, self._nxt_link = run_start, nxt_link
        self._oc_t, self._oc_s = oc_t, oc_s
        self._ref_rank = None
        self._rvc = None

    def _ensure_nav(self) -> None:
        """Derive the compact navigation core (run_start, nxt_link, rc)
        from the sorted keys; pad rows are inert (self-rc, own-index
        run, no link)."""
        if self._run_start is not None and self._rc is not None:
            return
        e, cap = self.real, self.size
        if self._oc_t is not None and self._run_start is None:
            # eager tables injected (old-format load): nav falls out -
            # tables are static, so min over slots = run start
            ot, os_ = np.asarray(self._oc_t), np.asarray(self._oc_s)
            big = np.int32(np.iinfo(np.int32).max)
            rs = np.where(os_ >= 0, os_, big).min(axis=1)
            nl = np.where(ot >= 0, ot, big).min(axis=1)
            self._run_start = np.where(rs == big,
                                       np.arange(cap, dtype=np.int32),
                                       rs).astype(np.int32)
            self._nxt_link = np.where(nl == big, NULL, nl).astype(
                np.int32)
            return
        if e == 0:
            self._rc = np.arange(cap, dtype=np.int32)
            self._run_start = np.arange(cap, dtype=np.int32)
            self._nxt_link = np.full(cap, NULL, np.int32)
            return
        run_start, nxt_link, rc = _nav_links(
            np.asarray(self.keys[:e]), self.k
        )
        padn = cap - e
        if padn:
            tailr = np.arange(e, cap, dtype=np.int32)
            if self._rc is None:
                self._rc = np.concatenate([rc, tailr])
            self._run_start = np.concatenate([run_start, tailr])
            self._nxt_link = np.concatenate(
                [nxt_link, np.full(padn, NULL, np.int32)]
            )
        else:
            if self._rc is None:
                self._rc = rc
            self._run_start = run_start
            self._nxt_link = nxt_link

    @property
    def rc(self) -> np.ndarray:
        self._ensure_nav()
        return self._rc

    @property
    def run_start(self) -> np.ndarray:
        self._ensure_nav()
        return self._run_start

    @property
    def nxt_link(self) -> np.ndarray:
        self._ensure_nav()
        return self._nxt_link

    def __copy__(self):
        """Shallow copy sharing the immutable structure but owning the
        MUTABLE state (valid + the validity-derived rvc cache), so two
        copies can diverge safely."""
        c = object.__new__(Sdbg)
        c.__dict__.update(self.__dict__)
        c.valid = self.valid.copy()
        c._rvc = None if self._rvc is None else self._rvc.copy()
        return c

    @property
    def rvc(self) -> np.ndarray:
        """Per-run VALID-edge count, stored at each run's start row
        (0 elsewhere). Makes every degree query a single gather
        (deg(node) = rvc[its run start]); maintained incrementally by
        invalidate/invalidate_idx."""
        if self._rvc is None:
            self._ensure_nav()
            self._rvc = np.bincount(
                self._run_start[self.valid], minlength=self.size
            ).astype(np.int32)
        return self._rvc

    @property
    def size(self) -> int:
        return len(self.keys)

    @property
    def ref_rank(self) -> np.ndarray:
        """(E,) int32: rank of each edge in the REFERENCE's SdBG
        edge-id order - colex by source node (first k-1 chars
        reversed), then the last char (kmerops.ref_order_keys;
        verified against a GetLabel dump of a reference .sdbg file).
        Real-edge relative order in the reference file equals this
        rank order (dummy-$ rows only interleave), so orientation/
        ordering tie-breaks the reference resolves by edge id are
        resolved here by ref_rank. Computed lazily, cached; invalid
        rows rank after all valid rows."""
        if getattr(self, "_ref_rank", None) is None:
            n = self.size
            # HOST on every backend: ref_rank is consumed by host-side
            # tie-break logic, so the old device sort paid two E-sized
            # link crossings per k for nothing (native transform +
            # threaded MSD argsort cover every W <= 16, i.e. k <= 255).
            # Invalid rows must rank after all valid ones: force them
            # to the all-ones sentinel (real keys can collide with it
            # only at k = 16*W exactly, where relative order vs
            # invalid rows is irrelevant to the valid-edge tie-breaks
            # ref_rank serves).
            if self.k <= 32:
                from ..native import OP_REF_ORDER, transform_rows

                ro = transform_rows(self.keys, self.k, OP_REF_ORDER)
                # u64 order == row order
                col = ro[:, 0].astype(np.uint64) << np.uint64(32)
                if ro.shape[1] > 1:
                    col |= ro[:, 1]
                col = np.where(self.valid, col,
                               np.uint64(0xFFFFFFFFFFFFFFFF))
                perm = np.argsort(col)
            else:
                ro = np.ascontiguousarray(np.asarray(
                    kmerops.ref_order_keys(self.keys, self.k)))
                if not self.valid.all():
                    ro[~self.valid] = np.uint32(0xFFFFFFFF)
                perm = kmerops.argsort_rows_np(ro)
            rank = np.empty(n, dtype=np.int32)
            rank[perm] = np.arange(n, dtype=np.int32)
            self._ref_rank = rank
        return self._ref_rank

    def num_valid(self) -> int:
        return int(self.valid.sum())

    def save(self, path: str, fmt: str = "compact") -> None:
        """Persist the graph (the analogue of the reference's
        .sdbg.{tid} + .sdbg_info shards, sdbg_writer.cpp:25-80 -
        redesigned as one npz since there is no per-thread sharding).

        fmt="compact" (default, ~5 B/edge at W=2): only canonical-
        strand rows (key <= rc(key); the set is closed under revcomp
        and mult/valid are strand-symmetric), multiplicity as uint16
        (KMAX_MUL clamps to 65535, matching the reference's kMaxMul),
        validity bit-packed. Navigation rebuilds on first use after
        load.

        fmt="nav" (~22 B/edge at W=2): the full sorted row set plus the
        derived navigation core, so load is pure I/O - used by the
        pipeline for its tmp k-stage artifacts, where reload speed
        beats disk (the reference keeps its .sdbg shards loaded-form-
        adjacent for the same reason, sdbg_raw_content.cpp:18-95)."""
        e = self.real
        if fmt == "nav":
            self._ensure_nav()
            np.savez(
                path, k=np.int64(self.k), format=np.int64(3),
                keys=self.keys[:e],
                mult=np.asarray(self.mult[:e], dtype=np.uint16),
                valid=np.packbits(self.valid[:e]),
                rc=self._rc[:e].astype(np.int32),
                run_start=self._run_start[:e].astype(np.int32),
                nxt_link=self._nxt_link[:e].astype(np.int32),
                n_real=np.int64(e),
            )
            return
        keys = self.keys[:e]
        if e:
            rck = kmerops.revcomp_kmers(np.asarray(keys), self.k)
            canon = ~kmerops.lex_less(rck, keys)  # key <= rc(key)
        else:
            canon = np.zeros(0, dtype=bool)
        # validity is stored for ALL real rows (not just the canonical
        # half): it may be rc-asymmetric mid-mutation, and the
        # reconstructed sorted row order equals the original so the
        # bits map 1:1
        np.savez(
            path, k=np.int64(self.k), format=np.int64(2),
            keys=keys[canon],
            mult=np.asarray(self.mult[:e][canon], dtype=np.uint16),
            valid=np.packbits(self.valid[:e]),
            n_canon=np.int64(int(canon.sum())),
            n_real=np.int64(e),
        )

    @classmethod
    def load(cls, path: str, device="cuda") -> "Sdbg":
        device = resolve_device(device)
        z = np.load(path)
        if "format" not in z:  # round-1 eager format
            return cls(
                k=int(z["k"]), keys=z["keys"], mult=z["mult"],
                rc=z["rc"], oc_t=z["oc_t"], oc_s=z["oc_s"],
                valid=z["valid"],
                device=device,
            )
        k = int(z["k"])
        if int(z["format"]) == 3:  # nav format: pure I/O load
            e = int(z["n_real"])
            keys, rc = z["keys"], z["rc"]
            rs, nl = z["run_start"], z["nxt_link"]
            mult = z["mult"].astype(np.int32)
            valid = np.unpackbits(z["valid"], count=e).astype(bool)
            cap = _pow2_pad(max(e, 16))
            padn = cap - e
            if padn:
                w = keys.shape[1]
                kp = np.empty((cap, w), np.uint32)
                kp[:e] = keys
                kp[e:] = 0xFFFFFFFF
                tail = np.arange(e, cap, dtype=np.int32)

                def padv(a, fillv):
                    out = np.empty(cap, a.dtype)
                    out[:e] = a
                    out[e:] = fillv
                    return out

                return cls(
                    k=k, keys=kp, mult=padv(mult, 0),
                    rc=np.concatenate([rc, tail]),
                    run_start=np.concatenate([rs, tail]),
                    nxt_link=padv(nl, NULL),
                    valid=padv(valid, False), real=e, device=device,
                )
            return cls(k=k, keys=keys, mult=mult, rc=rc,
                       run_start=rs, nxt_link=nl, valid=valid, real=e,
                       device=device)
        ckeys = z["keys"]
        n = int(z["n_canon"])
        n_real = int(z["n_real"])
        cmult = z["mult"].astype(np.int32)
        real_valid = np.unpackbits(z["valid"], count=n_real).astype(bool)
        if n == 0:
            return _make_sdbg(
                np.zeros((0, kmerops.words_per_kmer(k)), np.uint32),
                np.zeros(0, np.int32), k, device=device,
            )
        # restore the full strand-closed set: add rc rows, re-sort,
        # drop the palindrome duplicates. The sorted reconstructed
        # order equals the original row order (same key set), so the
        # per-row validity bits apply positionally.
        rck = kmerops.revcomp_kmers(ckeys, k)
        keys = np.concatenate([ckeys, rck], axis=0)
        mult = np.concatenate([cmult, cmult])
        skeys, smult = kmerops.sort_keys_with_payload(keys, mult)
        head = np.ones(len(skeys), dtype=bool)
        head[1:] = (skeys[1:] != skeys[:-1]).any(axis=1)
        skeys, smult = skeys[head], smult[head]
        svalid = real_valid
        # capacity-pad and construct LAZILY - rc + candidate tables
        # rebuild on first navigation, so load stays O(core)
        e = len(skeys)
        w = skeys.shape[1]
        cap = _pow2_pad(max(e, 16))
        padn = cap - e
        if padn:
            skeys = np.concatenate(
                [skeys, np.full((padn, w), 0xFFFFFFFF, np.uint32)]
            )
            smult = np.concatenate([smult, np.zeros(padn, np.int32)])
            svalid = np.concatenate([svalid, np.zeros(padn, bool)])
        return cls(k=k, keys=skeys, mult=smult, valid=svalid, real=e,
                   device=device)

    # -- sharded persistence (reference SdbgWriter/SdbgMeta) --------

    def save_sharded(self, dir_path: str,
                     rows_per_shard: int = 1 << 24) -> None:
        """Write the graph as per-shard files + a bucket manifest (the
        analogue of the reference's thread-sharded writer with bucket
        records, sdbg_writer.h:19-63, sdbg_meta.cpp:51-75). Shard
        boundaries sit on 16-bit key-prefix bucket boundaries; runs
        share 2(k-1) >= 16 prefix bits, so no shard ever splits a
        navigation run - a bucket range is a self-contained subgraph
        slice loadable via load_sharded_rows."""
        e = self.real
        w = ShardedSdbgWriter(dir_path, self.k,
                              rows_per_shard=rows_per_shard)
        step = max(rows_per_shard, 1)
        lo = 0
        while lo < e:
            hi = min(e, lo + step)
            # snap the cut to the next bucket boundary
            if hi < e:
                b = int(self.keys[hi - 1, 0] >> np.uint32(16))
                while hi < e and int(
                        self.keys[hi, 0] >> np.uint32(16)) == b:
                    hi += 1
            w.append(self.keys[lo:hi], self.mult[lo:hi],
                     self.valid[lo:hi])
            lo = hi
        w.finalize()

    @classmethod
    def load_sharded(cls, dir_path: str, device="cuda") -> "Sdbg":
        """Load a sharded graph whole; load_sharded_rows reads a bucket
        range instead."""
        device = resolve_device(device)
        man = _read_manifest(dir_path)
        k = int(man["k"])
        e = int(man["n_real"])
        if e == 0:
            return _make_sdbg(
                np.zeros((0, kmerops.words_per_kmer(k)), np.uint32),
                np.zeros(0, np.int32), k, device=device)
        w = kmerops.words_per_kmer(k)
        cap = _pow2_pad(max(e, 16))
        keys = np.full((cap, w), 0xFFFFFFFF, np.uint32)
        mult = np.zeros(cap, np.int32)
        valid = np.zeros(cap, bool)
        for sh in man["shards"]:
            z = np.load(os.path.join(dir_path, sh["file"]))
            r0, n = int(sh["row_start"]), int(sh["rows"])
            keys[r0:r0 + n] = z["keys"]
            mult[r0:r0 + n] = z["mult"].astype(np.int32)
            valid[r0:r0 + n] = np.unpackbits(
                z["valid"], count=n).astype(bool)
        return cls(k=k, keys=keys, mult=mult, valid=valid, real=e,
                   device=device)

    @staticmethod
    def load_sharded_rows(dir_path: str, bucket_lo: int,
                          bucket_hi: int
                          ) -> tuple[np.ndarray, np.ndarray,
                                     np.ndarray, int]:
        """Rows of 16-bit prefix buckets [bucket_lo, bucket_hi): the
        redistribution primitive - a reader opens only the shards
        overlapping its bucket range; nothing materializes the whole
        graph. Returns (keys, mult, valid, global_row_offset)."""
        man = _read_manifest(dir_path)
        bc = np.load(os.path.join(dir_path, man["bucket_counts"]))
        boffs = np.zeros(len(bc) + 1, np.int64)
        np.cumsum(bc, out=boffs[1:])
        want_lo, want_hi = int(boffs[bucket_lo]), int(boffs[bucket_hi])
        w = kmerops.words_per_kmer(int(man["k"]))
        keys = np.empty((want_hi - want_lo, w), np.uint32)
        mult = np.empty(want_hi - want_lo, np.int32)
        valid = np.empty(want_hi - want_lo, bool)
        for sh in man["shards"]:
            r0, n = int(sh["row_start"]), int(sh["rows"])
            lo = max(r0, want_lo)
            hi = min(r0 + n, want_hi)
            if lo >= hi:
                continue
            z = np.load(os.path.join(dir_path, sh["file"]))
            keys[lo - want_lo:hi - want_lo] = z["keys"][lo - r0:hi - r0]
            mult[lo - want_lo:hi - want_lo] = \
                z["mult"][lo - r0:hi - r0].astype(np.int32)
            valid[lo - want_lo:hi - want_lo] = np.unpackbits(
                z["valid"], count=n).astype(bool)[lo - r0:hi - r0]
        return keys, mult, valid, want_lo

    def invalidate(self, mask: np.ndarray) -> None:
        """Invalidate edges in `mask` AND their reverse complements,
        keeping validity rc-symmetric (the reference walks both strands
        explicitly; symmetry is an invariant here)."""
        full = mask.copy()
        full[self.rc[mask]] = True
        if self._rvc is not None:
            rows = np.flatnonzero(full & self.valid)
            np.subtract.at(self._rvc, self.run_start[rows], 1)
        self.valid &= ~full

    def invalidate_idx(self, idx: np.ndarray) -> None:
        """Index-based invalidate (sparse callers); rc-symmetric."""
        if self._rvc is not None:
            idx = np.asarray(idx, dtype=np.int64)
            both = np.concatenate([idx, self.rc[idx]])
            newly = np.unique(both[self.valid[both]])
            self.valid[newly] = False
            np.subtract.at(self._rvc, self.run_start[newly], 1)
            return
        self.valid[idx] = False
        self.valid[self.rc[idx]] = False


# ---------------------------------------------------------------------------
# sharded graph files
# ---------------------------------------------------------------------------


_MANIFEST_NAME = "sdbg_manifest.json"


def _read_manifest(dir_path: str) -> dict:
    with open(os.path.join(dir_path, _MANIFEST_NAME)) as fh:
        return json.load(fh)


class ShardedSdbgWriter:
    """Per-shard graph files + a bucket manifest ("sharded-v1", the
    format megahit_tpu writes) - the analogue of the reference's
    thread-sharded SdbgWriter whose SdbgMeta bucket records enable
    streamed, merged loading (sdbg_writer.h:19-63, sdbg_meta.cpp:51-75).

    Files: sdbg.shard.NNNNN.npz (keys, mult as uint16, valid through
    packbits), bucket_counts.npy (rows per 16-bit key prefix) and
    sdbg_manifest.json.

    Rows must arrive in globally sorted order, each append starting on
    a 16-bit key-prefix bucket boundary (the bucketed builder's rounds
    are bucket ranges in prefix order, so appending one round at a
    time satisfies this). A shard flushes once it holds at least
    rows_per_shard rows; flushes happen only at append boundaries, so
    shard boundaries are bucket boundaries and a bucket range is a
    self-contained slice (Sdbg.load_sharded_rows)."""

    def __init__(self, dir_path: str, k: int,
                 rows_per_shard: int = 1 << 24):
        os.makedirs(dir_path, exist_ok=True)
        self.dir = dir_path
        self.k = int(k)
        self.rows_per_shard = int(rows_per_shard)
        self._pend_keys: list[np.ndarray] = []
        self._pend_mult: list[np.ndarray] = []
        self._pend_valid: list[np.ndarray] = []
        self._pend_rows = 0
        self._row_off = 0
        self._shards: list[dict] = []
        self._bucket_counts = np.zeros(65536, np.int64)
        self._done = False

    def append(self, keys: np.ndarray, mult: np.ndarray,
               valid: np.ndarray | None = None) -> None:
        n = len(keys)
        if n == 0:
            return
        if valid is None:
            valid = np.ones(n, dtype=bool)
        b16 = (keys[:, 0] >> np.uint32(16)).astype(np.int64)
        self._bucket_counts += np.bincount(b16, minlength=65536)
        self._pend_keys.append(np.ascontiguousarray(keys))
        self._pend_mult.append(np.asarray(mult, dtype=np.uint16))
        self._pend_valid.append(np.asarray(valid, dtype=bool))
        self._pend_rows += n
        if self._pend_rows >= self.rows_per_shard:
            self._flush()

    def _flush(self) -> None:
        if self._pend_rows == 0:
            return
        keys = np.concatenate(self._pend_keys, axis=0)
        mult = np.concatenate(self._pend_mult)
        valid = np.concatenate(self._pend_valid)
        i = len(self._shards)
        name = f"sdbg.shard.{i:05d}.npz"
        np.savez(os.path.join(self.dir, name), keys=keys, mult=mult,
                 valid=np.packbits(valid))
        self._shards.append({
            "file": name,
            "rows": int(len(keys)),
            "row_start": int(self._row_off),
            "bucket_lo": int(keys[0, 0] >> np.uint32(16)),
            "bucket_hi": int(keys[-1, 0] >> np.uint32(16)) + 1,
        })
        self._row_off += len(keys)
        self._pend_keys, self._pend_mult, self._pend_valid = [], [], []
        self._pend_rows = 0

    def finalize(self) -> None:
        if self._done:
            return
        self._flush()
        np.save(os.path.join(self.dir, "bucket_counts.npy"),
                self._bucket_counts)
        man = {
            "format": "sharded-v1",
            "k": self.k,
            "n_real": int(self._row_off),
            "bucket_counts": "bucket_counts.npy",
            "shards": self._shards,
        }
        with open(os.path.join(self.dir, _MANIFEST_NAME), "w") as fh:
            json.dump(man, fh, indent=1)
        self._done = True


# ---------------------------------------------------------------------------
# navigation core derivation
# ---------------------------------------------------------------------------


def _run4(starts: np.ndarray, run_start: np.ndarray, real: int
          ) -> np.ndarray:
    """(N,) run-start indices (or -1) -> (N, 4) member rows of each
    run: runs are <= 4 CONSECUTIVE rows (same (k-1)-prefix, distinct
    last base); -1 padded, ascending."""
    n = len(starts)
    if n == 0 or real == 0:
        return np.full((n, 4), NULL, np.int32)
    safe = np.maximum(starts, 0)
    idx = safe[:, None] + np.arange(4, dtype=np.int32)[None, :]
    clip = np.minimum(idx, real - 1)
    ok = (starts[:, None] >= 0) & (idx < real) \
        & (run_start[clip] == safe[:, None])
    return np.where(ok, idx, NULL).astype(np.int32)


def _nav_links(keys: np.ndarray, k: int):
    """(run_start, nxt_link, rc) for SORTED (E, W) keys, host numpy.

    Exploits sortedness (every Sdbg constructor sorts): prefix runs are
    consecutive, so run_start is a head-flag scan; the suffix join and
    the rc pairing are single binary searches (no 2E-row sort-join as
    in _neighbor_tables)."""
    e = len(keys)
    idx = np.arange(e, dtype=np.int32)
    if e == 0:
        z = np.zeros(0, np.int32)
        return z, z.copy(), z.copy()
    if k <= 32 and keys.shape[1] <= 2:
        c = np.uint64
        u = kmerops.keys_to_u64_words(keys) if keys.shape[-1] == 2 \
            else keys[:, 0].astype(np.uint64) << c(32)
        # runs-are-consecutive requires sorted keys; every constructor
        # sorts, so violation is a bug, not an input condition
        assert np.all(u[1:] >= u[:-1]), "Sdbg keys must be sorted"
        node_mask = ~c(0) << c(64 - 2 * (k - 1))
        prefix = u & node_mask
        head = np.empty(e, dtype=bool)
        head[0] = True
        np.not_equal(prefix[1:], prefix[:-1], out=head[1:])
        run_start = np.maximum.accumulate(
            np.where(head, idx, 0)).astype(np.int32)
        hrows = idx[head]
        hpref = prefix[head]
        suffix = (u << c(2)) & node_mask

        # both searches are DRAM-latency-bound random probes; split the
        # query ranges across threads (searchsorted releases the GIL)
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=8) as tp:
            pos, found = kmerops.member_sorted_mt(hpref, suffix, tp)
            nxt_link = np.where(
                found, hrows[np.minimum(pos, len(hrows) - 1)], NULL
            ).astype(np.int32)
            rc_u = (kmerops._reverse_bases_u64(~u) << c(2 * (32 - k))) \
                & (~c(0) << c(64 - 2 * k))
            rc = kmerops.member_sorted_mt(u, rc_u, tp)[0].astype(
                np.int32)
        return run_start, nxt_link, rc

    # general multi-word path: the native threaded row search - one
    # binary search per join, no 2E-row sort
    assert e <= 1 or np.all(keys[1:, 0] >= keys[:-1, 0]), \
        "Sdbg keys must be sorted"
    prefix = np.asarray(kmerops.mask_tail(keys, k - 1))
    head = np.empty(e, dtype=bool)
    head[0] = True
    np.any(prefix[1:] != prefix[:-1], axis=1, out=head[1:])
    run_start = np.maximum.accumulate(
        np.where(head, idx, 0)).astype(np.int32)
    hrows = idx[head]
    hpref = prefix[head]
    suffix = np.asarray(kmerops.mask_tail(
        np.asarray(kmerops.drop_first_base(keys, k)), k - 1))
    rck = np.asarray(kmerops.revcomp_kmers(keys, k))
    from ..native import row_search

    pos, found = row_search(hpref, suffix)
    nxt_link = np.where(
        found, hrows[np.minimum(pos, len(hrows) - 1)], NULL
    ).astype(np.int32)
    rc = row_search(keys, rck)[0].astype(np.int32)
    return run_start, nxt_link, rc


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


def _neighbor_tables(keys: np.ndarray, k: int, n_group_words: int = 0):
    """rc index + the four (E, 4) candidate tables of host keys: the u64
    fast path for single-u64-width keys, the sort-join otherwise."""
    if n_group_words == 0 and k <= 32 and keys.shape[-1] <= 2:
        return _neighbor_tables_u64(keys, k)
    return _neighbor_tables_impl(keys, k, n_group_words)


def _neighbor_tables_u64(keys, k):
    """Host fast path of _neighbor_tables_impl for k <= 32: all key
    surgery on one u64 per edge (left-aligned 2-bit layout), the rc
    pairing by direct binary search in the (sorted) edge keys, and the
    node join by one u64 argsort. Same outputs as the general path."""
    c = np.uint64
    e = len(keys)
    u = kmerops.keys_to_u64_words(keys) if keys.shape[-1] == 2 \
        else keys[:, 0].astype(np.uint64) << c(32)
    node_mask = ~c(0) << c(64 - 2 * (k - 1))
    prefix = u & node_mask
    suffix = (u << c(2)) & node_mask
    first = (u >> c(62)).astype(np.int32)
    last = ((u >> c(64 - 2 * k)) & c(3)).astype(np.int32)

    idx = np.arange(e, dtype=np.int32)
    node = np.concatenate([prefix, suffix])
    kind = np.concatenate([np.zeros(e, np.int32), np.ones(e, np.int32)])
    base = np.concatenate([last, first])
    eid = np.concatenate([idx, idx])
    order = np.argsort(node)
    snode = node[order]
    skind, sbase, seid = kind[order], base[order], eid[order]
    head = np.ones(2 * e, dtype=bool)
    head[1:] = snode[1:] != snode[:-1]
    node_id = np.cumsum(head.astype(np.int32), dtype=np.int32) - 1

    pos = node_id * 4 + sbase
    node_out = np.full(2 * e * 4, NULL, np.int32)
    node_in = np.full(2 * e * 4, NULL, np.int32)
    sel = skind == 0
    node_out[pos[sel]] = seid[sel]
    node_in[pos[~sel]] = seid[~sel]
    node_out = node_out.reshape(2 * e, 4)
    node_in = node_in.reshape(2 * e, 4)
    pfx_id = np.zeros(e, np.int32)
    sfx_id = np.zeros(e, np.int32)
    pfx_id[seid[sel]] = node_id[sel]
    sfx_id[seid[~sel]] = node_id[~sel]

    oc_t = node_out[sfx_id]
    ic_t = node_in[sfx_id]
    oc_s = node_out[pfx_id]
    ic_s = node_in[pfx_id]

    # rc pairing: the edge set is closed under revcomp and the caller
    # hands keys in sorted order (finalize output) - but don't assume
    # it: search a sorted view
    rc_u = (kmerops._reverse_bases_u64(~u) << c(2 * (32 - k))) \
        & (~c(0) << c(64 - 2 * k))
    if np.all(u[1:] >= u[:-1]):
        rc_idx = np.searchsorted(u, rc_u).astype(np.int32)
    else:
        uo = np.argsort(u).astype(np.int32)
        rc_idx = uo[np.searchsorted(u[uo], rc_u)].astype(np.int32)
    return rc_idx, oc_t, ic_t, oc_s, ic_s


def _neighbor_tables_impl(keys, k, n_group_words: int = 0):
    """rc index + the four (E,4) candidate tables via sort-joins.

    Redesign note: the v1 implementation ran 17 batched binary searches
    (4 tables x 4 bases + rc) - random gathers that dominate build time
    at scale. Instead, join edges on their shared (k-1)-mer NODES: one
    sort of the 2E (node, kind, base) rows groups every edge incident
    to a node, from which all four tables fall out as two scatters +
    gathers; rc is one more sort-join of edges against their reverse
    complements. No binary search anywhere.

    keys: (E, G+W) with optional leading group words (disconnected
    per-group subgraphs, see localasm.mini_asm); node/rc joins match
    only within a group.
    """
    e = keys.shape[0]
    g = keys[:, :n_group_words]
    kk = keys[:, n_group_words:]
    idx = np.arange(e, dtype=np.int32)

    prefix = kmerops.mask_tail(kk, k - 1)
    suffix = kmerops.mask_tail(kmerops.drop_first_base(kk, k), k - 1)
    first = kmerops.get_base(kk, 0).astype(np.int32)
    last = kmerops.get_base(kk, k - 1).astype(np.int32)

    def with_group(part):
        return np.concatenate([g, part], axis=1) if n_group_words \
            else part

    node = np.concatenate([with_group(prefix), with_group(suffix)], axis=0)
    kind = np.concatenate([np.zeros(e, np.int32), np.ones(e, np.int32)])
    base = np.concatenate([last, first])
    eid = np.concatenate([idx, idx])

    snode, skind, sbase, seid = kmerops.sort_keys_with_payload(
        node, kind, base, eid)
    head = np.ones(2 * e, dtype=bool)
    head[1:] = (snode[1:] != snode[:-1]).any(axis=-1)
    node_id = np.cumsum(head.astype(np.int32), dtype=np.int32) - 1

    def scatter(n_slots, pos, val, sel):
        outv = np.full(n_slots, NULL, np.int32)
        outv[pos[sel]] = val[sel]
        return outv

    pos = node_id * 4 + sbase
    node_out = scatter(2 * e * 4, pos, seid, skind == 0).reshape(2 * e, 4)
    node_in = scatter(2 * e * 4, pos, seid, skind == 1).reshape(2 * e, 4)
    pfx_id = scatter(e, seid, node_id, skind == 0)
    sfx_id = scatter(e, seid, node_id, skind == 1)

    oc_t = node_out[sfx_id]
    ic_t = node_in[sfx_id]
    oc_s = node_out[pfx_id]
    ic_s = node_in[pfx_id]

    # rc: sort-join edges with their reverse complements (tag in the
    # key so each group's fwd row precedes its rc row)
    rc_kk = kmerops.revcomp_kmers(kk, k)
    pair_keys = np.concatenate([with_group(kk), with_group(rc_kk)], axis=0)
    tag = np.concatenate([np.zeros(e, np.uint32), np.ones(e, np.uint32)])
    pair_full = np.concatenate([pair_keys, tag[:, None]], axis=1)
    _, pidx = kmerops.sort_keys_with_payload(
        pair_full, np.concatenate([idx, idx]))
    a = pidx[0::2]
    b = pidx[1::2]
    rc_idx = np.zeros(e, np.int32)
    rc_idx[a] = b
    rc_idx[b] = a
    return rc_idx, oc_t, ic_t, oc_s, ic_s


def _dedup_sorted_max(skeys, smult):
    """(head mask, per-group max multiplicity at head rows, 0 elsewhere)
    over sorted keys: host reduceat for numpy, a segment max on the
    tensors' device for torch."""
    if isinstance(skeys, np.ndarray):
        n = len(skeys)
        head = np.ones(n, dtype=bool)
        head[1:] = (skeys[1:] != skeys[:-1]).any(axis=-1)
        hrows = np.flatnonzero(head)
        gmax = np.maximum.reduceat(smult, hrows)
        out = np.zeros(n, smult.dtype)
        out[hrows] = gmax
        return head, out
    n = skeys.shape[0]
    head = torch.ones(n, dtype=torch.bool, device=skeys.device)
    head[1:] = (skeys[1:] != skeys[:-1]).any(dim=-1)
    seg = torch.cumsum(head, 0) - 1
    gmax = torch.full((n,), torch.iinfo(smult.dtype).min,
                      dtype=smult.dtype, device=skeys.device)
    gmax.scatter_reduce_(0, seg, smult, reduce="amax")
    return head, torch.where(head, gmax[seg], 0)


def sdbg_from_edges(
    edge_keys: np.ndarray, edge_mults: np.ndarray, k: int, device="cuda"
) -> Sdbg:
    """Build the graph directly from canonical edge k-mers + counts
    (the k_min path: solid edges from the counter and mercy edges feed
    straight in - the reference's seq2sdbg with --input_prefix,
    src/sorting/seq_to_sdbg.cpp:428-467, minus the re-sort). The reverse
    complements are computed on `device`; the graph's whole-graph passes
    run there too."""
    device = resolve_device(device)
    keys = np.asarray(edge_keys, dtype=np.uint32)
    n = len(keys)
    w = kmerops.words_per_kmer(k)
    if n == 0:
        return Sdbg(k, np.zeros((0, w), np.uint32),
                    np.zeros(0, np.int32), valid=np.zeros(0, bool),
                    device=device)
    rc = kmerops.to_numpy(kmerops.revcomp_kmers(
        kmerops.to_torch(keys, device), k))
    both = np.concatenate([keys, rc], axis=0)
    mults = np.concatenate([edge_mults, edge_mults]).astype(np.int32)
    return _finalize_sdbg(both, mults, k, n_windows=n, device=device)


def _finalize_sdbg(keys: np.ndarray, mults: np.ndarray, k: int,
                   n_windows: int, device="cuda") -> Sdbg:
    """Sort + dedup-max + neighbour tables over a raw (strand-closed)
    edge multiset."""
    log = get_logger()
    total = len(keys)
    # host sort/dedup: the multiset arrives as host arrays and the
    # Sdbg's arrays live on host (native threaded row sort)
    kn = np.asarray(keys)
    order = kmerops.argsort_rows_np(kn)
    skeys = kn[order]
    smult = np.asarray(mults)[order]
    head, gmult = _dedup_sorted_max(skeys, smult)
    edges = skeys[head]
    mult = np.minimum(gmult[head], KMAX_MUL).astype(np.int32)

    sdbg = _make_sdbg(edges, mult, k, device=device)
    log.debug("sdbg k=%d: %d windows -> %d edges (cap %d)",
              k, n_windows, len(edges), sdbg.size)
    return sdbg


def window_edge_multiset(
    flat_codes,
    starts: np.ndarray,
    seq_mults: np.ndarray,
    k: int,
    batch_windows: int = 1 << 21,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Raw both-strand edge multiset (keys, mults) of all k-windows of a
    sequence pool, each window with its sequence's multiplicity, as host
    arrays: the pre-finalize half of the graph build, so callers can
    union several edge sources into one _finalize_sdbg pass. Windows are
    extracted on `device` one chunk at a time; the reverse complements
    are taken on the host (native per-row transform)."""
    from .counter import _chunks, as_pool

    device = resolve_device(device)
    pool = as_pool(flat_codes)
    seq_mults = np.asarray(seq_mults, dtype=np.int32)
    chunk = max(1 << 16, (batch_windows + 15) & ~15)
    chunks_k, chunks_m = [], []
    for lo, words, vm in _chunks(pool, starts, k, chunk):
        fwd_np = kmerops.to_numpy(kmerops.extract_all_kmers(
            kmerops.to_torch(words, device), k))[vm]
        chunks_k.append(fwd_np)
        chunks_k.append(kmerops.revcomp_kmers(fwd_np, k))
        posv = np.flatnonzero(vm) + lo
        mm = seq_mults[np.searchsorted(starts, posv, side="right") - 1]
        chunks_m.append(mm)
        chunks_m.append(mm)
    keys = np.concatenate(chunks_k, axis=0)
    mults = np.concatenate(chunks_m, axis=0).astype(np.int32)
    return keys, mults


def build_sdbg_device_resident(
    flat_codes,
    starts: np.ndarray,
    seq_mults: np.ndarray,
    k: int,
    edge_keys: np.ndarray | None = None,
    edge_counts: np.ndarray | None = None,
    batch_windows: int = 1 << 21,
    device="cuda",
) -> Sdbg:
    """Window multiset -> SdBG with the multiset resident on `device`
    from extraction to dedup; only the deduplicated edges come back.

    The 2-bit pool goes up one chunk at a time with its packed window
    validity and the chunk's sequence starts and multiplicities; windows
    are extracted, masked, reverse-complemented, sorted and max-deduped
    on the device. Invalid windows ride as all-ones sentinel rows with
    multiplicity -1 and sort into one tail group that is dropped; the
    max with -1 keeps a real all-T key (k % 16 == 0) exact. Edge-file
    inputs (iterate output) join as one upload with their reverse
    complements. Same edges and multiplicities as window_edge_multiset +
    _finalize_sdbg except that, as in megahit_tpu, the multiplicities
    are not clipped to KMAX_MUL here."""
    from .counter import _chunks, as_pool, num_windows

    device = resolve_device(device)
    log = get_logger()
    w = kmerops.words_per_kmer(k)
    n_bases = int(starts[-1])
    pool = as_pool(flat_codes)
    n = num_windows(starts, k)
    if n_bases < k or n == 0:
        if edge_keys is not None and len(edge_keys):
            return sdbg_from_edges(edge_keys, edge_counts, k, device=device)
        return Sdbg(k, np.zeros((0, w), np.uint32), np.zeros(0, np.int32),
                    valid=np.zeros(0, bool), device=device)

    seq_mults = np.asarray(seq_mults, dtype=np.int32)
    chunk = max(1 << 16, (batch_windows + 15) & ~15)
    up_bytes = 0
    dev_keys, dev_mults = [], []
    for lo, words, vm in _chunks(pool, starts, k, chunk):
        # every window the chunk's words hold; those past its valid
        # span are invalid and join the sentinel group
        span = len(vm)
        vm_host = np.packbits(vm)
        # the chunk's sequences, with starts relative to lo
        j0 = max(int(np.searchsorted(starts, lo, side="right")) - 1, 0)
        j1 = int(np.searchsorted(starts, lo + span, side="left"))
        nseq = max(j1 - j0, 1)
        rel = np.clip(starts[j0:j0 + nseq] - lo, -(2 ** 30), span + 1)
        msub = seq_mults[j0:j0 + nseq]
        up_bytes += words.nbytes + vm_host.nbytes + rel.nbytes + msub.nbytes
        kf, kr, mm = _dev_extract_chunk(
            kmerops.to_torch(words, device),
            torch.from_numpy(vm_host).to(device),
            torch.from_numpy(rel.astype(np.int64)).to(device),
            torch.from_numpy(msub).to(device), span, k)
        dev_keys += [kf, kr]
        dev_mults += [mm, mm]
    keys = torch.cat(dev_keys, dim=0)
    mults = torch.cat(dev_mults, dim=0)
    del dev_keys, dev_mults
    if edge_keys is not None and len(edge_keys):
        ek = kmerops.to_torch(edge_keys, device)
        ec = torch.from_numpy(
            np.asarray(edge_counts, dtype=np.int32)).to(device)
        up_bytes += np.asarray(edge_keys).nbytes + ec.numel() * 4
        keys = torch.cat([keys, ek, kmerops.revcomp_kmers(ek, k)], dim=0)
        mults = torch.cat([mults, ec, ec])

    skeys, smult = kmerops.sort_keys_with_payload(keys, mults)
    del keys, mults
    head, gmult = _dedup_sorted_max(skeys, smult)
    # gather the head rows (the deduplicated edges) on the device: only
    # the edge set crosses to the host
    edges_host = kmerops.to_numpy(skeys[head])
    mult_host = gmult[head].cpu().numpy()
    down_bytes = edges_host.nbytes + mult_host.nbytes
    # drop the sentinel tail group (invalid windows): the all-ones key
    # with mult < 0 (a real all-T key keeps mult >= 1)
    if len(mult_host) and mult_host[-1] < 0:
        edges_host, mult_host = edges_host[:-1], mult_host[:-1]
    log.info(
        "device-resident build k=%d: %d windows -> %d edges; transfers "
        "up %.1f MB / down %.1f MB", k - 1, n, len(edges_host),
        up_bytes / 1e6, down_bytes / 1e6)
    return _make_sdbg(np.ascontiguousarray(edges_host),
                      mult_host.astype(np.int32), k, device=device)


def build_sdbg_union(flat_codes, starts: np.ndarray,
                     seq_mults: np.ndarray, k: int,
                     edge_keys: np.ndarray | None, edge_counts:
                     np.ndarray | None, device,
                     batch_windows: int = 1 << 21) -> Sdbg:
    """The in-memory union of a rung's inputs (reference seq2sdbg
    Initialize, seq_to_sdbg.cpp:359-528): the windows of the contig
    sequences (each at its multiplicity) and the edge-file keys with
    their reverse complements, finalized once. On a card the multiset
    stays on the device through the dedup (build_sdbg_device_resident);
    on the CPU it is window_edge_multiset, the edges appended, and one
    _finalize_sdbg (utils.device.graph_on_card decides)."""
    if devices.graph_on_card(device):
        return build_sdbg_device_resident(
            flat_codes, starts, seq_mults, k, edge_keys=edge_keys,
            edge_counts=edge_counts, batch_windows=batch_windows,
            device=device)
    keys, mults = window_edge_multiset(flat_codes, starts, seq_mults, k,
                                       batch_windows=batch_windows,
                                       device=device)
    if edge_keys is not None and len(edge_keys):
        rc = kmerops.revcomp_kmers(
            np.ascontiguousarray(edge_keys, dtype=np.uint32), k)
        keys = np.concatenate([keys, edge_keys, rc], axis=0)
        mults = np.concatenate([mults, edge_counts, edge_counts])
    return _finalize_sdbg(keys, mults.astype(np.int32), k,
                          n_windows=len(keys), device=device)


def _dev_extract_chunk(sub, vm_packed, rel_starts, rel_mults, span: int,
                       k: int):
    """One chunk of the device-resident build: extract the windows,
    mask invalid ones to all-ones sentinels, reverse-complement, and
    look up each window's sequence multiplicity (-1 when invalid), all
    on the tensors' device. rel_starts are the chunk-relative sequence
    starts, ascending."""
    fwd = kmerops.extract_all_kmers(sub, k)[:span]
    bitpos = torch.arange(span, dtype=torch.int64, device=sub.device)
    vm = ((vm_packed[bitpos >> 3].to(torch.int64)
           >> (7 - (bitpos & 7))) & 1).bool()
    kf = torch.where(vm[:, None], fwd, kmerops.M32)
    kr = torch.where(vm[:, None], kmerops.revcomp_kmers(fwd, k),
                     kmerops.M32)
    si = torch.searchsorted(rel_starts, bitpos, right=True) - 1
    mm = torch.where(
        vm, rel_mults[torch.clamp(si, 0, rel_mults.shape[0] - 1)],
        torch.tensor(-1, dtype=torch.int32, device=sub.device))
    return kf, kr, mm


def _make_sdbg(edges, mult, k, rc_idx=None, device="cuda") -> Sdbg:
    """Assemble the Sdbg from sorted dedup'd edges with capacity
    padding (shared by the in-memory finalize and the out-of-core
    bucketed builder). Navigation (run_start/nxt_link/rc) derives
    lazily from the sorted keys; a precomputed rc may be injected."""
    from ..utils.debug import check_sdbg_invariants, debug_enabled

    e = len(edges)
    w = kmerops.words_per_kmer(k)
    if rc_idx is not None and e:
        # spot-check an injected rc pairing
        sample = np.arange(0, e, max(1, e // 1024))
        rc_sample = kmerops.revcomp_kmers(edges[sample], k)
        assert (edges[rc_idx[sample]] == rc_sample).all(), \
            "edge set must be closed under revcomp"
    # pad all per-edge arrays to a power-of-two CAPACITY with inert
    # rows (valid=False, self-rc, no candidates), as the reference
    # implementation does: its graph arrays and artifacts keep the
    # same capacity classes
    cap = _pow2_pad(max(e, 16))
    padn = cap - e

    def padi(a, fill):
        a = np.asarray(a)
        if not padn:
            return a
        # empty + two slice fills: one allocation, no second write of
        # the live region
        out = np.empty((cap,) + a.shape[1:], a.dtype)
        out[:e] = a
        out[e:] = fill
        return out

    if padn:
        keys_p = np.empty((cap, w), np.uint32)
        keys_p[:e] = edges
        keys_p[e:] = 0xFFFFFFFF
    else:
        keys_p = edges
    rc_p = None
    if rc_idx is not None:
        if padn:
            rc_p = np.empty(cap, np.int32)
            rc_p[:e] = rc_idx
            rc_p[e:] = np.arange(e, cap, dtype=np.int32)
        else:
            rc_p = np.asarray(rc_idx, dtype=np.int32)
    sdbg = Sdbg(
        k=k,
        keys=keys_p,
        mult=padi(mult, 0),
        rc=rc_p,
        valid=np.concatenate(
            [np.ones(e, bool), np.zeros(padn, bool)]
        ),
        real=e,
        device=device,
    )
    if debug_enabled():
        check_sdbg_invariants(sdbg)
    return sdbg


# ---------------------------------------------------------------------------
# navigation (vectorized over edge frontiers, run-based)
# ---------------------------------------------------------------------------


def cands_at(sdbg: "Sdbg", rows: np.ndarray, which: str) -> np.ndarray:
    """(len(rows), 4) candidate edge indices for the given rows, -1
    padded - the sparse (frontier-shaped) replacement for indexing the
    old global (E, 4) tables. which: oc_t | oc_s | ic_t | ic_s."""
    rs, nl, rc = sdbg.run_start, sdbg.nxt_link, sdbg.rc
    rows = np.asarray(rows)
    if which == "oc_t":
        return _run4(nl[rows], rs, sdbg.real)
    if which == "oc_s":
        return _run4(rs[rows], rs, sdbg.real)
    if which == "ic_t":
        m = _run4(rs[rc[rows]], rs, sdbg.real)
    elif which == "ic_s":
        m = _run4(nl[rc[rows]], rs, sdbg.real)
    else:
        raise ValueError(which)
    return np.where(m >= 0, rc[np.maximum(m, 0)], NULL).astype(np.int32)


def deg_at(sdbg: "Sdbg", rows, which: str) -> np.ndarray:
    """Valid-degree per row via the per-run valid counts: one gather.
    rows=None means all rows. which as in cands_at."""
    rvc = sdbg.rvc
    if which == "oc_t":
        s = sdbg.nxt_link if rows is None else sdbg.nxt_link[rows]
    elif which == "oc_s":
        s = sdbg.run_start if rows is None else sdbg.run_start[rows]
    elif which == "ic_t":
        rc = sdbg.rc if rows is None else sdbg.rc[rows]
        s = sdbg.run_start[rc]
    elif which == "ic_s":
        rc = sdbg.rc if rows is None else sdbg.rc[rows]
        s = sdbg.nxt_link[rc]
    else:
        raise ValueError(which)
    return np.where(s >= 0, rvc[np.maximum(s, 0)], 0).astype(np.int32)


def simple_path_links_host(sdbg: "Sdbg"):
    """Host route of simple_path_links: the native threaded scan
    (native/seedscan.cpp simple_links), whose degree tests are single
    rvc gathers and whose prv is the exact inverse of nxt."""
    from ..native import simple_links

    return simple_links(sdbg.run_start, sdbg.nxt_link, sdbg.rc,
                        sdbg.valid, sdbg.rvc, sdbg.real)


def _run_members_valid(starts, run_start, valid):
    """(N,) run-start indices (or -1) -> ((N, 4) valid-member mask,
    (N, 4) member rows), torch. Pad rows are inert (own-index run,
    invalid)."""
    cap = valid.shape[0]
    safe = torch.clamp(starts, min=0)
    idx = safe[:, None] + torch.arange(4, device=starts.device)[None, :]
    clip = torch.clamp(idx, max=cap - 1)
    ok = (starts >= 0)[:, None] & (run_start[clip] == safe[:, None]) \
        & valid[clip]
    return ok, clip


def simple_path_links(run_start, nxt_link, rc, valid):
    """next[e], prev[e]: the simple-path successor/predecessor, -1 if
    none, as whole-graph torch passes on the tensors' device (one block
    of simple_path_links_rows: plain indexing, no exchange)."""
    from ..parallel.rows import Blocks, Rows

    nxt, prv = simple_path_links_rows(
        Rows(None, valid.device),
        *(Blocks([t]) for t in (run_start, nxt_link, rc, valid)))
    return nxt.b[0], prv.b[0]


def simple_path_links_rows(rows, run_start, nxt_link, rc, valid):
    """simple_path_links over row blocks (parallel/rows.py).

    next[e] = the unique out-edge f of target(e) when target(e) has
    out-degree 1 and in-degree 1 (reference SDBG::NextSimplePathEdge,
    sdbg.h:418-427); prev is symmetric (PrevSimplePathEdge,
    sdbg.h:404-412). In-edge sets come by strand symmetry, and validity
    is rc-symmetric, so degrees count pre-rc rows directly. Every row
    another shard owns is read through ``rows.take``; a run's four
    members may straddle a block edge, so they are taken too."""
    from ..parallel import rows as R

    cap = rows.n * valid.b[0].shape[0]
    # run_start where valid, else -1: one column to read (safe >= 0);
    # pad rows are inert (own-index run, invalid)
    run_valid = R.where(valid, run_start, -1)

    def members(starts):
        safe = starts.clamp(min=0)
        idx = R.bmap(lambda t: t[:, None] + torch.arange(4, device=t.device),
                     safe)
        clip = idx.clamp(max=cap - 1)
        (rs,) = rows.take([run_valid], clip)
        return (starts >= 0)[:, None] & (rs == safe[:, None]), clip

    def unique_member(ok, r):
        """The single flagged row (assuming exactly one), else -1."""
        return R.where(ok, r, -1).amax(dim=-1)

    rs_rc, nl_rc = rows.take([run_start, nxt_link], rc)
    ok_ot, rows_ot = members(nxt_link)
    odt = ok_ot.sum(-1)
    idt = members(rs_rc)[0].sum(-1)
    ods = members(run_start)[0].sum(-1)
    ok_is, rows_is = members(nl_rc)
    ids = ok_is.sum(-1)
    nxt = R.where(valid & (odt == 1) & (idt == 1),
                  unique_member(ok_ot, rows_ot), -1)
    prv_pre = unique_member(ok_is, rows_is)
    (rc_pre,) = rows.take([rc], prv_pre.clamp(min=0))
    prv = R.where(valid & (ids == 1) & (ods == 1) & (prv_pre >= 0),
                  rc_pre, -1)
    return nxt, prv


# ---------------------------------------------------------------------------
# SdBG-level tip removal (reference src/assembly/sdbg_pruning.cpp:61-178)
# ---------------------------------------------------------------------------


def _trim_tips_once(run_start, nxt_link, rc, valid, max_len: int):
    """One Trim(len) pass as whole-graph torch passes: a chain ending in
    an out-degree-0 edge is a tip when it is <= max_len edges long and
    detaches at its start (dead start or branch) - remove it and its
    reverse complement.

    The reference's walk-back (sdbg_pruning.cpp:61-145) steps through
    nodes with in/out degree (1,1), i.e. the simple-path chains, so
    pointer doubling with ceil(log2(max_len))+1 rounds replaces the
    linear scan: chains longer than the horizon are correctly
    classified non-tips because their measured prefix already exceeds
    max_len. Returns (to_remove mask, number of tip chains)."""
    e = valid.shape[0]
    ok_ot, _ = _run_members_valid(nxt_link, run_start, valid)
    odt = ok_ot.sum(-1)
    ok_is, _ = _run_members_valid(nxt_link[rc], run_start, valid)
    ids_ = ok_is.sum(-1)
    ok_os, _ = _run_members_valid(run_start, run_start, valid)
    ods = ok_os.sum(-1)

    nxt, prv = simple_path_links(run_start, nxt_link, rc, valid)
    idx = torch.arange(e, device=valid.device)
    n = torch.where(nxt >= 0, nxt, idx)
    p = torch.where(prv >= 0, prv, idx)
    d_start = (prv >= 0).to(torch.int64)
    rounds = max(1, int(np.ceil(np.log2(max(max_len, 2)))) + 1)
    for _ in range(rounds):
        d_start = d_start + d_start[p]
        n = n[n]
        p = p[p]
    start = p  # chain start (or 2^rounds back for long chains)
    chain_len = d_start + 1

    # tip-stop classification at the chain start: dead start or branch
    tip_stop = (ids_ == 0) | ((ids_ == 1) & (ods != 1))
    seed = valid & (odt == 0)
    # reference Trim(len) walks i = 1..len-1, so chains of <= len-1
    # edges are classified (sdbg_pruning.cpp:74-85)
    is_tip_seed = seed & (chain_len <= max_len - 1) & tip_stop[start]
    # mark whole chains: members follow nxt to the chain end and
    # inherit its tip flag
    to_remove = valid & is_tip_seed[n]
    return to_remove, int(is_tip_seed.sum())


def _tip_schedule(max_tip_len: int) -> list[int]:
    lens = []
    ln = 2
    while ln < max_tip_len:
        lens.append(ln)
        ln *= 2
    lens.append(max_tip_len)
    return lens


def _remove_tips_sdbg_host(sdbg: Sdbg, max_tip_len: int) -> int:
    """Host tip removal: sparse seed-walks instead of whole-graph
    pointer doubling.

    Tips are a tiny frontier (out-degree-0 chain ends); the reference
    walks back from each seed linearly (sdbg_pruning.cpp:61-145).
    Degrees and simple-path links are computed once over all edges,
    then updated INCREMENTALLY around each removal (the only rows a
    removal can affect are the valid entries of the removed rows'
    four candidate sets). Identical marks to _trim_tips_once."""
    log = get_logger()
    valid = sdbg.valid

    def cand_deg(which, rows=None):
        # rvc-backed: one gather per degree query
        return deg_at(sdbg, rows, which)

    def unique_valid(which, rows):
        tt = cands_at(sdbg, rows, which)
        cv = (tt >= 0) & valid[np.maximum(tt, 0)]
        return np.max(np.where(cv, tt, NULL), axis=-1)

    # only the out-degree (seed detection) is materialized; prv links
    # and start-classification degrees are computed lazily at the
    # (sparse) rows the walks actually touch. -2 = not yet computed.
    odt = cand_deg("oc_t")
    UNK = np.int32(-2)
    prv = np.full(sdbg.size, UNK, dtype=np.int32)

    def prv_at(rows):
        need = rows[prv[rows] == UNK]
        if len(need):
            ids_n = cand_deg("ic_s", need)
            ods_n = cand_deg("oc_s", need)
            prv[need] = np.where(
                valid[need] & (ids_n == 1) & (ods_n == 1),
                unique_valid("ic_s", need), NULL,
            )
        return prv[rows]

    total = 0
    for ln in _tip_schedule(max_tip_len):
        if ln < 2:
            # chain_len <= max_len - 1 is unsatisfiable at max_len=1:
            # the device path and the reference remove nothing
            continue
        seeds = np.flatnonzero(valid & (odt == 0))
        if len(seeds) == 0:
            continue
        # vectorized walk back along prv, at most ln-1 hops; record
        # the trajectory to mark members later
        cur = seeds.copy()
        traj = [cur.copy()]
        aliv = np.ones(len(seeds), dtype=bool)
        for _ in range(int(ln) - 2):
            p = prv_at(cur)
            step = aliv & (p >= 0)
            if not step.any():
                break
            cur = np.where(step, p, cur)
            aliv = step
            traj.append(np.where(step, cur, NULL))
        complete = prv_at(cur) < 0  # walked to the chain start
        ids_c = cand_deg("ic_s", cur)
        ods_c = cand_deg("oc_s", cur)
        tip = complete & (
            (ids_c == 0) | ((ids_c == 1) & (ods_c != 1))
        )
        n = int(tip.sum())
        total += n
        if n == 0:
            continue
        members = np.unique(np.concatenate(
            [t[tip][t[tip] >= 0] for t in traj]
        ))
        members = np.unique(np.concatenate(
            [members, sdbg.rc[members]]
        ))
        sdbg.invalidate_idx(members)  # members already include rc
        # incremental repair: rows referencing a removed edge are
        # exactly the removed rows' candidate entries
        aff = np.concatenate([
            cands_at(sdbg, members, w_).ravel()
            for w_ in ("oc_t", "ic_t", "oc_s", "ic_s")
        ])
        aff = np.unique(aff[aff >= 0])
        aff = aff[valid[aff]]
        if len(aff):
            odt[aff] = cand_deg("oc_t", aff)
            prv[aff] = UNK  # recompute lazily if a walk reaches them
        odt[members] = 0
        prv[members] = NULL
    log.debug("sdbg tips removed: %d (max_len=%d)", total, max_tip_len)
    return total


def remove_tips_sdbg(sdbg: Sdbg, max_tip_len: int) -> int:
    """Doubling-length tip removal schedule (sdbg_pruning.cpp:147-178).

    Host: sparse seed walks; CUDA: whole-graph pointer doubling."""
    if not devices.graph_on_card(sdbg.device):
        return _remove_tips_sdbg_host(sdbg, max_tip_len)
    log = get_logger()
    dev = sdbg.device
    rs = torch.from_numpy(sdbg.run_start).to(dev, torch.int64)
    nl = torch.from_numpy(sdbg.nxt_link).to(dev, torch.int64)
    rc = torch.from_numpy(sdbg.rc).to(dev, torch.int64)
    total = 0
    for ln in _tip_schedule(max_tip_len):
        valid = torch.from_numpy(sdbg.valid).to(dev)
        to_remove, n = _trim_tips_once(rs, nl, rc, valid, int(ln))
        total += n
        to_remove = to_remove.cpu().numpy()
        if to_remove.any():
            sdbg.invalidate(to_remove)
    log.debug("sdbg tips removed: %d (max_len=%d)", total, max_tip_len)
    return total
