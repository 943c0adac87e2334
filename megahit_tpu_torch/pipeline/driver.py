"""The checkpointed multi-k assembly pipeline.

Re-expression of the reference Python driver (src/megahit:969-1033 main,
:996-1019 pipeline loop, :250-280 Checkpoint): build read lib -> k_min
graph (solid + mercy edges) -> assemble -> for each next k: [local
assembly] -> iterate junction edges -> build graph from contigs+edges ->
assemble -> merge final contigs. Stage artifacts live in out/tmp/k{K}/
and out/intermediate_contigs/ in the same formats as megahit_tpu's, so
runs resume (`--continue`) at stage granularity, mid-ladder included.
A rung whose window multiset exceeds the -m budget, and the k_min graph
under --kmin-1pass, build out of core (graph/bucketed.py).

Counterpart of megahit_tpu/pipeline/driver.py.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np

from ..core import kmerops, packing
from ..graph import iterate as it
from ..graph.bucketed import (
    BuildStats, EdgeSource, PoolSource, build_sdbg_bucketed,
)
from ..graph.counter import count_canonical_kmers
from ..graph.mercy import find_mercy_edges
from ..graph.sdbg import (
    Sdbg, _finalize_sdbg, build_sdbg_device_resident, sdbg_from_edges,
    use_device_build, window_edge_multiset,
)
from ..io.contig_io import (
    FLAG_LOOP, FLAG_STANDALONE, ContigRecord, read_contigs, write_contigs,
)
from ..io.lib import SequenceLib, build_lib
from ..pipeline.assemble import AssembleOptions, assemble
from ..pipeline.options import Options
from ..utils.device import resolve_device
from ..utils.log import get_logger
from ..utils.timers import PhaseTimer, max_rss_mb


class EarlyTerminate(Exception):
    def __init__(self, k):
        self.k = k


class Checkpoint:
    """Stage counter persisted as "<n> done" lines
    (reference src/megahit:250-280)."""

    def __init__(self, path: str, resume: bool):
        self.path = path
        self.idx = 0
        self.done_upto = -1
        self.timer = PhaseTimer()
        if resume and os.path.exists(path):
            with open(path) as fh:
                for line in fh:
                    parts = line.split()
                    if len(parts) == 2 and parts[1] == "done":
                        self.done_upto = max(self.done_upto, int(parts[0]))

    def run(self, fn, *args, **kwargs):
        idx = self.idx
        self.idx += 1
        log = get_logger()
        if idx <= self.done_upto:
            log.info("skipping checkpointed stage %d (%s)",
                     idx, fn.__name__)
            return None
        t0 = time.monotonic()
        with self.timer.phase(fn.__name__):
            out = fn(*args, **kwargs)
        log.info(
            "stage %d (%s%s): %.2fs, maxrss %.0f MB",
            idx, fn.__name__,
            "".join(f" {a}" for a in args), time.monotonic() - t0,
            max_rss_mb(),
        )
        with open(self.path, "a") as fh:
            fh.write(f"{idx} done\n")
        return out


class Pipeline:
    def __init__(self, opt: Options):
        self.opt = opt
        self.device = resolve_device(opt.device)
        self.log = get_logger()
        self.out_dir = opt.out_dir
        self.tmp_dir = self._resolve_tmp_dir(opt)
        self.contig_dir = os.path.join(opt.out_dir, "intermediate_contigs")
        self.lib: SequenceLib | None = None
        self.timer = PhaseTimer()  # sub-stage spans (checkpoint-free)

    # ---------------- paths

    @staticmethod
    def _resolve_tmp_dir(opt: Options) -> str:
        """Reference --tmp-dir: a fresh megahit_tmp_* dir inside the
        given root (src/megahit:458-461), written back to opt.temp_dir
        so --continue reuses it."""
        if not opt.temp_dir:
            return os.path.join(opt.out_dir, "tmp")
        if os.path.basename(opt.temp_dir).startswith("megahit_tmp_"):
            return opt.temp_dir  # already resolved (resumed run)
        if opt.continue_mode:
            return opt.temp_dir  # run() re-resolves from saved options
        import tempfile

        os.makedirs(opt.temp_dir, exist_ok=True)
        opt.temp_dir = tempfile.mkdtemp(
            dir=opt.temp_dir, prefix="megahit_tmp_")
        return opt.temp_dir

    def graph_prefix(self, k: int) -> str:
        d = os.path.join(self.tmp_dir, f"k{k}")
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"k{k}")

    def contig_prefix(self, k: int) -> str:
        os.makedirs(self.contig_dir, exist_ok=True)
        return os.path.join(self.contig_dir, f"k{k}")

    @property
    def lib_path(self) -> str:
        return os.path.join(self.out_dir, "reads.lib.npz")

    # ---------------- stages

    def stage_build_lib(self) -> None:
        o = self.opt
        lib = build_lib(o.pe1, o.pe2, o.pe12, o.se)
        lib.save(self.lib_path)
        self.log.info(
            "read lib: %d seqs, %d bases, max len %d",
            lib.num_seqs, lib.num_bases, lib.max_len,
        )

    def _memory_budget(self) -> int:
        """The -m budget in bytes (reference memory autodetect,
        src/megahit:596-609: default 0.9 x RAM)."""
        m = self.opt.memory
        if m <= 1:
            return int(m * os.sysconf("SC_PAGE_SIZE")
                       * os.sysconf("SC_PHYS_PAGES"))
        return int(m)

    def _batch_windows(self) -> int:
        """Count batch size from the -m memory budget."""
        # ~64 B/window peak across extraction + sort working sets
        return int(max(1 << 20, min(1 << 26, self._memory_budget() // 64)))

    def _budget_rows(self, w: int) -> int:
        """Max edge-multiset rows resident at once, from the -m budget
        (the reference AdjustMemory role, base_engine.cpp:54-141):
        ~3 copies of (w+1) uint32 words live across sort working sets."""
        rows = self._memory_budget() // (12 * (w + 1))
        if self.opt.mem_flag == 0:
            # minimum-memory mode: more, smaller rounds (reference
            # mem_flag 0 = kMaxLv1ScanTime sizing, base_engine.cpp:103)
            rows //= 8
        return int(max(1 << 14, rows))

    def _load_lib(self) -> SequenceLib:
        if self.lib is None:
            # mem-flag 0 (minimum memory): the pool stays ON DISK and
            # every scan reads bounded windows (reference mem_flag 0 =
            # smallest Lv1 sizing, base_engine.cpp:103)
            mode = "window" if self.opt.mem_flag == 0 else "ram"
            self.lib = SequenceLib.load(self.lib_path, mode=mode)
        return self.lib

    def _mesh(self):
        """The run's shard mesh under --mesh (every rank of a process
        group, else every visible card), None without it."""
        if not self.opt.use_mesh:
            return None
        from ..parallel.multihost import global_shard_mesh

        return global_shard_mesh(self.device)

    def stage_first_graph(self) -> None:
        """count + mercy + graph at k_min (reference build_first_graph,
        src/megahit:789-802): the default 2-pass path counts solid edges
        first; --kmin-1pass builds the graph straight from the reads
        out of core (graph/bucketed.py; reference read2sdbg S1+S2,
        main_sdbg_build.cpp:88-156)."""
        o = self.opt
        lib = self._load_lib()
        k1 = o.k_min + 1
        if o.kmin_1pass:
            return self._first_graph_1pass(lib, k1)
        with self.timer.phase("first_graph.count"):
            if o.use_mesh:
                from ..parallel.shuffle import sharded_count_kmers

                mesh = self._mesh()
                self.log.info("mesh counting over %d devices (%s)",
                              mesh.size, mesh.transport)
                keys, counts, rare = sharded_count_kmers(
                    lib.pool, lib.starts, k1, o.min_count, mesh,
                    return_rare=True)
            else:
                keys, counts, rare = count_canonical_kmers(
                    lib.pool, lib.starts, k1, o.min_count,
                    batch_windows=self._batch_windows(),
                    return_rare=True, device=self.device,
                )
        self.log.info("k=%d: %d solid edges", o.k_min, len(keys))
        # min_count <= 1: every observed (k+1)-mer is already solid, so
        # the mercy scan provably returns nothing - skip it
        if not o.no_mercy and o.min_count > 1:
            with self.timer.phase("first_graph.mercy"):
                mercy = find_mercy_edges(
                    lib.pool, lib.starts, keys, k1, rare_keys=rare,
                    device=self.device,
                )
            if len(mercy):
                keys = np.concatenate([keys, mercy], axis=0)
                counts = np.concatenate(
                    [counts, np.ones(len(mercy), np.int32)])
        np.savez(self.graph_prefix(o.k_min) + ".edges.npz",
                 keys=keys, counts=counts)
        self._write_counting(counts)

    def _write_counting(self, counts: np.ndarray) -> None:
        """Multiplicity histogram artifact (reference .counting file,
        kmer_counter.cpp:409-410)."""
        vals, cnts = np.unique(counts, return_counts=True)
        with open(self.graph_prefix(self.opt.k_min) + ".counting",
                  "w") as fh:
            for v, c in zip(vals, cnts):
                fh.write(f"{v} {c}\n")

    def _first_graph_1pass(self, lib: SequenceLib, k1: int) -> None:
        """1-pass k_min graph: reads -> bucketed count-mode build.

        The window multiset only exists in the spill files; the solid
        filter and canonical counts are applied during the per-round
        dedup (count-mode group sums == the 2-pass counter's values).
        With mercy on, canonical solid keys are read back from the built
        graph, mercy edges appended, and the (small) edge set is written
        for the normal assemble path; with mercy off (the min_count == 1
        presets), the graph is saved directly, nav-form."""
        o = self.opt
        stats = BuildStats()
        with self.timer.phase("first_graph.1pass_build"):
            sdbg = build_sdbg_bucketed(
                [PoolSource(lib.pool, lib.starts,
                            np.ones(lib.num_seqs, np.int32))],
                k1, self._budget_rows(kmerops.words_per_kmer(k1)),
                os.path.join(self.tmp_dir, f"k{o.k_min}", "spill"),
                batch_windows=self._batch_windows(), stats=stats,
                mult_mode="count", min_count=o.min_count,
                device=self.device, mesh=self._mesh())
        self.log.info(
            "k=%d (1-pass): %d edges, %d rounds (max %d rows)",
            o.k_min, int(sdbg.valid.sum()), stats.n_rounds,
            stats.max_round_rows)
        prefix = self.graph_prefix(o.k_min)
        # canonical rows (key <= rc(key) <=> row index <= rc index in
        # the sorted edge array) for the .counting artifact and mercy
        canon = sdbg.valid & (np.arange(sdbg.size) <= sdbg.rc)
        keys = sdbg.keys[canon]
        counts = sdbg.mult[canon]
        mercy = None
        if not o.no_mercy and o.min_count > 1:
            # (min_count <= 1: all observed windows are solid - mercy
            # provably empty, scan skipped)
            with self.timer.phase("first_graph.mercy"):
                mercy = find_mercy_edges(lib.pool, lib.starts, keys, k1,
                                         device=self.device)
        if mercy is not None and len(mercy):
            keys = np.concatenate([keys, mercy], axis=0)
            counts = np.concatenate(
                [counts, np.ones(len(mercy), np.int32)])
            # the assemble stage re-finalizes edges + mercy (small: E
            # rows, not the window multiset)
            np.savez(prefix + ".edges.npz", keys=keys, counts=counts)
        else:
            # the built graph IS the k_min graph: persist it nav-form
            # so assemble loads it without a re-finalize
            sdbg.save(prefix + ".sdbg.npz", fmt="nav")
        self._write_counting(counts)

    def stage_assemble(self, k: int) -> None:
        """Load the k graph inputs, assemble, write contig files
        (reference assemble(), src/megahit:866-903)."""
        o = self.opt
        with self.timer.phase(f"assemble.k{k}.graph_build"):
            sdbg = self._build_sdbg_for_k(k)
        if sdbg.size == 0:
            self.log.warning("k=%d: empty graph", k)
        min_standalone = max(
            min(o.k_max * 3 - 1, int(o.min_contig_len * 1.5)),
            o.min_contig_len,
        )
        if o.max_tip_len >= 0:
            min_standalone = max(
                o.max_tip_len + o.k_max - 1, o.min_contig_len)
        aopt = AssembleOptions(
            min_standalone=min_standalone,
            prune_level=o.prune_level,
            merge_len=int(o.merge_len),
            merge_similar=o.merge_similar,
            cleaning_rounds=o.cleaning_rounds,
            disconnect_ratio=o.disconnect_ratio,
            low_local_ratio=o.low_local_ratio,
            min_depth=o.prune_depth,
            bubble_level=o.bubble_level,
            is_final_round=(k == o.k_max),
            careful_bubble=(k < o.k_max),
            output_standalone=o.no_local,
            use_mesh=o.use_mesh,
        )
        if o.max_tip_len == -1 and k * 3 - 1 > o.min_contig_len * 1.5:
            aopt.max_tip_len = max(1, int(o.min_contig_len * 1.5 + 1 - k))
        else:
            aopt.max_tip_len = o.max_tip_len
        with self.timer.phase(f"assemble.k{k}.clean_output"):
            res = assemble(sdbg, aopt)
        cp = self.contig_prefix(k)
        write_contigs(cp + ".contigs.fa", res.contigs)
        write_contigs(cp + ".final.contigs.fa", res.final_contigs)
        write_contigs(cp + ".addi.fa", res.addi_contigs)
        write_contigs(cp + ".bubble_seq.fa", res.bubbles)

    def _build_sdbg_for_k(self, k: int) -> Sdbg:
        """Union the k-graph inputs (reference seq2sdbg Initialize,
        seq_to_sdbg.cpp:359-528): edge files + contigs + bubble + addi +
        local from the previous k. On cuda the window multiset stays on
        the card through the dedup (build_sdbg_device_resident); on the
        CPU it is window_edge_multiset + _finalize_sdbg, the choice by
        backend megahit_tpu makes (sdbg.use_device_build, which
        MEGAHIT_TPU_TORCH_DEVICE_BUILD overrides)."""
        km = k + 1  # edge length
        dev = self.device
        prefix = self.graph_prefix(k)
        if os.path.exists(prefix + ".sdbg.npz"):
            return Sdbg.load(prefix + ".sdbg.npz", device=dev)
        edge_file = prefix + ".edges.npz"
        edge_keys = edge_counts = None
        n_edge_inputs = 0
        if os.path.exists(edge_file):
            z = np.load(edge_file)
            edge_keys, edge_counts = z["keys"], z["counts"]
            n_edge_inputs = len(edge_keys)

        seqs: list[np.ndarray] = []
        mults: list[float] = []
        k_from = self._prev_k(k)
        if k_from is not None:
            cp = self.contig_prefix(k_from)
            # EarlyTerminate when the previous round produced no NEW
            # information - no iterate edges, no addi, no local - even
            # if contigs exist (reference build_graph file_size check,
            # src/megahit:816-840: contigs/bubbles are not counted)
            new_info = n_edge_inputs > 0 or any(
                os.path.exists(cp + name) and os.path.getsize(cp + name)
                for name in (".addi.fa", ".local.fa")
            )
            if not new_info:
                raise EarlyTerminate(k_from)
            for name, extend in (
                (".contigs.fa", True), (".bubble_seq.fa", False),
                (".addi.fa", False), (".local.fa", False),
            ):
                path = cp + name
                if not os.path.exists(path):
                    continue
                for r in read_contigs(
                        path, min_len=km,
                        extend_loop_k=(k_from, k) if extend else None):
                    seqs.append(r.codes)
                    mults.append(r.multi)
            if n_edge_inputs == 0 and not seqs:
                raise EarlyTerminate(k_from)

        # estimate the union multiset size; route builds larger than
        # the -m budget out of core (graph/bucketed.py)
        n_window_rows = 2 * sum(max(len(s) - km + 1, 0) for s in seqs)
        est_rows = n_window_rows + 2 * n_edge_inputs
        budget_rows = self._budget_rows(kmerops.words_per_kmer(km))
        if seqs:
            flat, starts = packing.pack_many(seqs)
            seq_mults = np.floor(np.asarray(mults) + 0.5).astype(np.int32)
        # --mesh: route the build through the bucketed builder even
        # under budget, so its sorts shard over the mesh (the in-memory
        # builds are single-device by construction)
        if est_rows > budget_rows or (self.opt.use_mesh and est_rows):
            sources = []
            if seqs:
                sources.append(PoolSource(flat, starts, seq_mults))
            if edge_keys is not None and len(edge_keys):
                sources.append(EdgeSource(edge_keys, edge_counts))
            self.log.info(
                "k=%d: ~%d multiset rows > budget %d; bucketed "
                "out-of-core build", k, est_rows, budget_rows)
            return build_sdbg_bucketed(
                sources, km, budget_rows,
                os.path.join(self.tmp_dir, f"k{k}", "spill"),
                batch_windows=self._batch_windows(), device=dev,
                mesh=self._mesh())

        if seqs:
            if use_device_build(dev):
                return build_sdbg_device_resident(
                    flat, starts, seq_mults, km, edge_keys=edge_keys,
                    edge_counts=edge_counts,
                    batch_windows=self._batch_windows(), device=dev)
            keys, kmults = window_edge_multiset(flat, starts, seq_mults, km,
                                                device=dev)
            if edge_keys is not None and len(edge_keys):
                # union the contig-window multiset with the edge-file
                # inputs BEFORE the single finalize (sort + join) pass
                rc = kmerops.revcomp_kmers(
                    np.ascontiguousarray(edge_keys, dtype=np.uint32), km)
                keys = np.concatenate([keys, edge_keys, rc], axis=0)
                kmults = np.concatenate(
                    [kmults, edge_counts, edge_counts]).astype(np.int32)
            return _finalize_sdbg(keys, kmults, km, n_windows=len(keys),
                                  device=dev)
        if edge_keys is not None:
            return sdbg_from_edges(edge_keys, edge_counts, km, device=dev)
        return sdbg_from_edges(
            np.zeros((0, 1), np.uint32), np.zeros(0, np.int32), km,
            device=dev)

    def _prev_k(self, k: int) -> int | None:
        ks = self.opt.k_list
        i = ks.index(k)
        return ks[i - 1] if i > 0 else None

    def stage_iterate(self, cur_k: int, next_k: int) -> None:
        """Junction edge seeding (reference iterate(),
        src/megahit:850-862)."""
        step = next_k - cur_k
        lib = self._load_lib()
        cp = self.contig_prefix(cur_k)
        contigs: list[np.ndarray] = []
        muls: list[float] = []
        # the iterate reader discards loop AND standalone contigs
        # (reference AsyncContigReader, async_sequence_reader.h:80):
        # they cannot be extended by junction k-mers
        skip = FLAG_LOOP | FLAG_STANDALONE
        for name in (".contigs.fa", ".bubble_seq.fa"):
            if os.path.exists(cp + name):
                for r in read_contigs(cp + name):
                    if r.flag & skip:
                        continue
                    contigs.append(r.codes)
                    muls.append(r.multi)
        index = it.build_flank_index(contigs, muls, cur_k, step)
        keys, counts = it.find_next_kmers(lib.pool, lib.starts, index,
                                          device=self.device)
        np.savez(self.graph_prefix(next_k) + ".edges.npz",
                 keys=keys, counts=counts)

    def stage_local(self, cur_k: int, next_k: int) -> None:
        """Paired-end local assembly (reference local_assemble(),
        src/megahit:906-914)."""
        from ..localasm.local_assemble import run_local_assembly

        lib = self._load_lib()
        cp = self.contig_prefix(cur_k)
        contigs = read_contigs(cp + ".contigs.fa") \
            if os.path.exists(cp + ".contigs.fa") else []
        out = run_local_assembly(lib, contigs, local_kmax=next_k,
                                 device=self.device)
        write_contigs(cp + ".local.fa", out)

    def stage_merge_final(self, final_k: int) -> None:
        """cat *.final.contigs.fa + k_max contigs, filter by length
        (reference merge_final, src/megahit:917-936)."""
        o = self.opt
        name = "final.contigs.fa" if not o.out_prefix else \
            o.out_prefix + ".contigs.fa"
        out_path = os.path.join(self.out_dir, name)
        merged: list[ContigRecord] = []
        for k in o.k_list:
            p = self.contig_prefix(k) + ".final.contigs.fa"
            if os.path.exists(p):
                merged.extend(read_contigs(p))
        last = self.contig_prefix(final_k) + ".contigs.fa"
        if os.path.exists(last):
            merged.extend(read_contigs(last))
        merged = [c for c in merged if c.length >= o.min_contig_len]
        write_contigs(out_path, merged)
        lengths = np.array([c.length for c in merged], dtype=np.int64)
        from ..graph.output import contig_stats

        st = contig_stats(lengths)
        self.log.info(
            "%d contigs, total %d bp, min %d bp, max %d bp, avg %d bp, "
            "N50 %d bp",
            st["n"], st["total"], st["min"], st["max"], st["avg"],
            st["n50"],
        )

    # ---------------- main

    def run(self) -> dict[str, float]:
        """Run (or resume) the pipeline; returns the per-phase wall
        seconds it logged."""
        o = self.opt
        t0 = time.time()
        os.makedirs(self.out_dir, exist_ok=True)
        opt_path = os.path.join(self.out_dir, "options.json")
        if o.continue_mode and os.path.exists(opt_path):
            saved = Options.load(opt_path)
            saved.continue_mode = True
            saved.device = o.device
            self.opt = o = saved
            self.tmp_dir = self._resolve_tmp_dir(o)
        else:
            if o.temp_dir and not os.path.basename(
                    o.temp_dir).startswith("megahit_tmp_"):
                prev, o.continue_mode = o.continue_mode, False
                self.tmp_dir = self._resolve_tmp_dir(o)
                o.continue_mode = prev
            o.save(opt_path)
        from ..utils.threads import set_num_threads

        set_num_threads(o.num_cpu_threads)
        cp = Checkpoint(os.path.join(self.out_dir, "checkpoints.txt"),
                        resume=o.continue_mode)

        cp.run(self.stage_build_lib)
        max_len = self._load_lib().max_len
        if o.drop_large_k(max_len):
            self.log.info("k-max reset to %d (max read len %d)",
                          o.k_max, max_len)
        self.log.info("k list: %s", ",".join(map(str, o.k_list)))

        cp.run(self.stage_first_graph)
        cp.run(self.stage_assemble, o.k_min)

        cur_k = o.k_min
        final_k = o.k_max
        try:
            for next_k in o.k_list[1:]:
                if not o.no_local:
                    cp.run(self.stage_local, cur_k, next_k)
                cp.run(self.stage_iterate, cur_k, next_k)
                cp.run(self.stage_assemble, next_k)
                cur_k = next_k
        except EarlyTerminate as et:
            self.log.info("early termination at k=%d", et.k)
            final_k = et.k
        cp.run(self.stage_merge_final, final_k)

        if not o.keep_tmp_files and os.path.exists(self.tmp_dir):
            shutil.rmtree(self.tmp_dir)
        open(os.path.join(self.out_dir, "done"), "w").close()
        # per-phase span summary (reference xinfo timer lines)
        spans = dict(cp.timer.phases)
        spans.update(self.timer.phases)
        for name, dt in sorted(spans.items(), key=lambda x: -x[1]):
            self.log.info("phase %s: %.2fs total", name, dt)
        self.log.info("ALL DONE. Time elapsed: %.1f s", time.time() - t0)
        return spans
