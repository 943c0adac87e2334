"""Per-k assembly: SdBG -> cleaned unitig graph -> contigs.

Faithful re-expression of the reference `assemble` subprogram
(src/main_assemble.cpp:119-304): same pruning order, same defaults,
same output routing (contigs / final standalone / addi / bubble_seq).

The cleaning loop runs on the device engine (graph/assemble_device.py)
when the graph is on the card and on the host engine (graph/cleaning.py)
on the CPU; the two are byte-identical. Counterpart of
megahit_tpu/pipeline/assemble.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import packing
from ..graph import assemble_device, cleaning
from ..graph.output import output_contigs
from ..graph.sdbg import Sdbg, remove_tips_sdbg
from ..graph.unitig import build_unitig_graph
from ..io.contig_io import ContigRecord
from ..utils.log import get_logger


@dataclass
class AssembleOptions:
    """Mirrors reference LocalAsmOption (main_assemble.cpp:40-64)."""

    local_width: int = 1000
    max_tip_len: int = -1
    min_standalone: int = 200
    min_depth: float = -1
    is_final_round: bool = False
    bubble_level: int = 2
    merge_len: int = 20
    merge_similar: float = 0.98
    prune_level: int = 2
    disconnect_ratio: float = 0.1
    low_local_ratio: float = 0.2
    cleaning_rounds: int = 5
    output_standalone: bool = False
    careful_bubble: bool = False
    use_mesh: bool = False  # shard device cleaning state over the mesh


@dataclass
class AssembleResult:
    contigs: list  # ContigRecord
    final_contigs: list
    addi_contigs: list
    bubbles: list  # ContigRecord (careful-bubble branches)
    stats: dict


class _HostEngine:
    """graph/cleaning.py behind the engine interface shared with the
    device-resident cleaner (graph/assemble_device.DeviceCleaner)."""

    def __init__(self, g):
        self.g = g

    def remove_tips(self, max_tip_len):
        self.g, n = cleaning.remove_tips(self.g, max_tip_len)
        return n

    def pop_bubbles(self, max_len, permanent, similarity=None,
                    careful_threshold=None, bubble_records=None):
        self.g, n = cleaning.pop_bubbles(
            self.g, max_len, permanent, similarity=similarity,
            careful_threshold=careful_threshold,
            bubble_records=bubble_records)
        return n

    def pop_complex_bubbles(self, merge_level, similarity, permanent,
                            careful_threshold=None,
                            bubble_records=None):
        self.g, n = cleaning.pop_complex_bubbles(
            self.g, merge_level, similarity, permanent,
            careful_threshold=careful_threshold,
            bubble_records=bubble_records)
        return n

    def disconnect_weak_links(self, ratio):
        self.g, n = cleaning.disconnect_weak_links(self.g, ratio)
        return n

    def remove_local_low_depth(self, min_depth, max_len, local_width,
                               local_ratio, permanent):
        self.g, n, changed = cleaning.remove_local_low_depth(
            self.g, min_depth, max_len, local_width, local_ratio,
            permanent)
        return n, changed

    def iterate_local_low_depth(self, min_depth, min_len, local_width,
                                local_ratio, permanent):
        self.g, n = cleaning.iterate_local_low_depth(
            self.g, min_depth, min_len, local_width, local_ratio,
            permanent)
        return n

    def remove_low_depth(self, min_depth):
        self.g, n = cleaning.remove_low_depth(self.g, min_depth)
        return n

    def to_host(self):
        return self.g


def assemble(sdbg: Sdbg, opt: AssembleOptions) -> AssembleResult:
    import time as _time

    log = get_logger()
    _t0 = _time.monotonic()
    _marks: list[tuple[str, float]] = []

    def _mark(name: str) -> None:
        _marks.append((name, _time.monotonic()))
    # thresholds use the megahit-level k (node length); sdbg.k is the
    # edge length = megahit k + 1
    k = sdbg.k - 1
    max_tip_len = opt.max_tip_len if opt.max_tip_len != -1 else 2 * k
    min_depth = opt.min_depth
    if min_depth <= 0:
        min_depth = cleaning.infer_min_depth(sdbg)
        log.info("min depth set to %.3f", min_depth)

    if max_tip_len > 0:
        n = remove_tips_sdbg(sdbg, max_tip_len)
        log.info("sdbg tips removed: %d", n)
    _mark("sdbg_tips")

    g = build_unitig_graph(sdbg)
    log.info("unitig graph size: %d", g.size)
    _mark("unitig_build")

    use_device = assemble_device.use_device_cleaning(sdbg.device) \
        and g.size > 0
    if use_device:
        # Device depth accumulates in int32; exact iff every per-chain
        # multiplicity sum < 2^31. Sufficient sound bound: the total
        # valid multiplicity (every chain is a subset of the edge set).
        total_mult = int(np.sum(sdbg.mult, dtype=np.int64,
                                where=sdbg.valid[: sdbg.mult.shape[0]]))
        if total_mult >= 2 ** 31:
            log.warning(
                "total edge multiplicity %d >= 2^31: device depth sums "
                "could overflow int32; falling back to host cleaning "
                "to keep byte parity", total_mult)
            use_device = False
    if use_device:
        mesh = None
        if opt.use_mesh:
            from ..parallel.multihost import global_shard_mesh

            mesh = global_shard_mesh(sdbg.device)
        eng = assemble_device.DeviceCleaner(g, mesh=mesh)
        log.info(
            "cleaning on device (%s%s)", sdbg.device.type,
            f", {eng.mesh.size}-device mesh" if eng.mesh is not None
            else "")
    else:
        eng = _HostEngine(g)

    careful = 0.2 if opt.careful_bubble else None
    bubble_records: list[tuple[str, float]] = []

    for rnd in range(1, opt.cleaning_rounds + 1):
        changed = False
        if rnd > 1:
            n_tips = eng.remove_tips(max_tip_len)
            changed |= n_tips > 0
            log.info("tips removed: %d", n_tips)
        if opt.bubble_level >= 1:
            n = eng.pop_bubbles(
                k + 2, permanent=True,
                careful_threshold=careful, bubble_records=bubble_records,
            )
            changed |= n > 0
            log.info("bubbles removed: %d", n)
        if opt.bubble_level >= 2:
            n = eng.pop_complex_bubbles(
                opt.merge_len, opt.merge_similar, permanent=True,
                careful_threshold=careful, bubble_records=bubble_records,
            )
            changed |= n > 0
            log.info("complex bubbles removed: %d", n)
        n_disc = eng.disconnect_weak_links(opt.disconnect_ratio)
        changed |= n_disc > 0
        log.info("unitigs disconnected: %d", n_disc)

        if opt.prune_level >= 3:
            n1 = eng.remove_low_depth(min_depth)
            n2 = eng.pop_bubbles(
                k + 2, permanent=True,
                careful_threshold=careful, bubble_records=bubble_records,
            )
            n3 = 0
            if opt.bubble_level >= 2 and opt.merge_len > 0:
                n3 = eng.pop_complex_bubbles(
                    opt.merge_len, opt.merge_similar, permanent=True,
                    careful_threshold=careful,
                    bubble_records=bubble_records,
                )
            log.info("excessive pruning removed: %d", n1 + n2 + n3)
        elif opt.prune_level >= 2:
            n, _ = eng.remove_local_low_depth(
                min_depth, max_tip_len, opt.local_width,
                min(opt.low_local_ratio, 0.1), permanent=True,
            )
            log.info("excessive pruning removed: %d", n)
        if not changed:
            break
    _mark("cleaning_rounds")

    contigs: list[ContigRecord] = []
    finals: list[ContigRecord] = []
    addi: list[ContigRecord] = []

    if not (opt.is_final_round and opt.prune_level >= 1):
        contigs, finals = output_contigs(
            eng.to_host(), change_only=False,
            min_standalone=opt.min_standalone,
            want_final=opt.output_standalone,
        )

    if opt.prune_level >= 1:
        n_removed = eng.iterate_local_low_depth(
            min_depth, max_tip_len, opt.local_width,
            opt.low_local_ratio, permanent=opt.is_final_round,
        )
        n_bub = 0
        if opt.bubble_level >= 2 and opt.merge_len > 0:
            n_bub = eng.pop_complex_bubbles(
                opt.merge_len, opt.merge_similar, permanent=False
            )
        log.info(
            "local low depth removed: %d, complex bubbles: %d",
            n_removed, n_bub,
        )
        if not opt.is_final_round:
            addi, _ = output_contigs(eng.to_host(), change_only=True)
        else:
            contigs, finals = output_contigs(
                eng.to_host(), change_only=False,
                min_standalone=opt.min_standalone,
                want_final=opt.output_standalone,
            )

    _mark("prune_output")
    prev = _t0
    split = []
    for name, t in _marks:
        split.append(f"{name} {t - prev:.2f}s")
        prev = t
    log.info("assemble split: %s", ", ".join(split))

    bubble_contigs = [
        ContigRecord(packing.encode(s), k, 0, 0, m)
        for s, m in bubble_records
    ]
    lengths = np.array([c.length for c in contigs + finals], dtype=np.int64)
    from ..graph.output import contig_stats

    stats = contig_stats(lengths)
    log.info(
        "%d contigs, total %d bp, min %d bp, max %d bp, N50 %d bp",
        stats["n"], stats["total"], stats["min"], stats["max"], stats["n50"],
    )
    return AssembleResult(contigs, finals, addi, bubble_contigs, stats)
