"""The mesh cleaner split by owner rows (DeviceCleaner(mesh=), passes
over megahit_tpu_torch/parallel/rows.py), held exactly against the
unsharded engine pass by pass, with a size audit that shows no shard
builds a tensor of the whole graph's rows.

Graphs are small enough that a shard holds a few hundred edge rows
(E = 2048 at 8 shards: 256), so chains, runs and pointer-doubling reads
cross block edges everywhere. The unsharded engine itself is held to
megahit_tpu's device engine by tests/test_torch_cleaning.py; the whole
assemble() over the mesh is held to megahit_tpu's here, over two gloo
ranks."""

import contextlib
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from megahit_tpu_torch.core import packing
from megahit_tpu_torch.graph import assemble_device as tad
from megahit_tpu_torch.graph.cleaning import infer_min_depth
from megahit_tpu_torch.graph.counter import count_canonical_kmers
from megahit_tpu_torch.graph.sdbg import remove_tips_sdbg, sdbg_from_edges
from megahit_tpu_torch.graph.unitig import build_unitig_graph
from megahit_tpu_torch.parallel.multihost import Mesh
from megahit_tpu_torch.utils import device as devices
from megahit_tpu_torch.utils.audit import SizeAudit

from cleaning_cases import CASES, engine_steps, records

import torch_test_env  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
# the passes whose every op is audited; the bubble pass's host part
# (instance payloads, string fetch) is not, only its device parts
AUDITED_METHODS = ("remove_tips", "disconnect_weak_links",
                   "remove_local_low_depth", "iterate_local_low_depth",
                   "remove_low_depth")
AUDITED_FUNCTIONS = ("_bubble_shape", "_naive_bubble_marks", "_refresh")
OPTIONS = dict(prune_level=3, careful_bubble=True, min_standalone=200,
               output_standalone=True, merge_similar=0.95)


def two_haplotypes(seed, n_bases, n1, n2, err, snp_every):
    """Reads of a genome and of a copy with a SNP every snp_every bases
    and a second SNP 10 bases after every other one (bubbles too long
    for the simple pass, left to the complex one)."""
    rng = np.random.default_rng(seed)
    g1 = rng.integers(0, 4, n_bases).astype(np.uint8)
    g2 = g1.copy()
    pos = np.arange(snp_every // 2, n_bases, snp_every)
    g2[pos] = (g2[pos] + 1) % 4
    g2[pos[::2] + 10] = (g2[pos[::2] + 10] + 2) % 4
    reads = []
    for g, n in ((g1, n1), (g2, n2)):
        for _ in range(n):
            s = int(rng.integers(0, n_bases - 100))
            r = g[s: s + 100].copy()
            m = rng.random(100) < err
            r[m] = (r[m] + rng.integers(1, 4, int(m.sum()))) % 4
            if rng.random() < 0.5:
                r = packing.revcomp_codes(r)
            reads.append(r)
    return reads


GRAPHS = {
    # E = 2048: bubbles with records, complex bubbles, weak links, tips
    "haplotypes_2k": lambda: (two_haplotypes(4, 600, 150, 100, 0.01, 50),
                              2),
    # E = 8192: every pass removes something, local low depth included
    "haplotypes_8k": lambda: (two_haplotypes(6, 1000, 500, 100, 0.03, 90),
                              2),
    # loops: the refresh's cycle winners
    "loop_genome": lambda: CASES["loop_genome"]()[:2],
}


def edges(name):
    reads, min_count = GRAPHS[name]()
    flat, starts = packing.pack_many(reads)
    return count_canonical_kmers(flat, starts, 22, min_count, device="cpu")


def graph(name):
    """The graph after the SdBG tip pass, as assemble() cleans it."""
    sdbg = sdbg_from_edges(*edges(name), 22, device="cpu")
    remove_tips_sdbg(sdbg, 2 * (sdbg.k - 1))
    return sdbg


def assert_same_state(a, b, step):
    for xa, xb in zip(a.gathered(), b.gathered()):
        for f in dataclasses.fields(xa):
            ta, tb = getattr(xa, f.name), getattr(xb, f.name)
            if isinstance(ta, torch.Tensor):
                assert torch.equal(ta, tb), (step, f.name)
            else:
                assert ta == tb, (step, f.name)


class Audit:
    """The largest tensor over every audited pass of an engine."""

    def __init__(self):
        self.largest, self.op, self.where = 0, None, None

    def run(self, name, fn, *args, **kw):
        with SizeAudit() as a:
            out = fn(*args, **kw)
        if a.largest > self.largest:
            self.largest, self.op, self.where = a.largest, a.op, name
        return out


@contextlib.contextmanager
def audited(eng, audit):
    """While active, the engine's audited passes and the module's
    audited functions run under the size audit."""
    saved = [(tad, name, getattr(tad, name)) for name in AUDITED_FUNCTIONS]
    saved += [(eng, name, getattr(eng, name)) for name in AUDITED_METHODS]
    for obj, name, fn in saved:
        setattr(obj, name, lambda *a, _f=fn, _n=name, **k:
                audit.run(_n, _f, *a, **k))
    try:
        yield audit
    finally:
        for obj, name, fn in saved:
            if obj is eng:
                delattr(eng, name)
            else:
                setattr(obj, name, fn)


def run_steps(eng, k, min_depth, ref=None, check=True):
    """Every engine_steps pass; with ref, the same pass on the unsharded
    engine after each, held equal (counts, records, every state
    tensor). Returns the per-step counts and the records."""
    rec, ref_rec, counts = [], [], []
    steps = engine_steps(eng, k, min_depth, rec)
    ref_steps = engine_steps(ref, k, min_depth, ref_rec) if ref else None
    for i, (step, call) in enumerate(steps):
        n = call()
        counts.append(n)
        if ref is not None:
            assert n == ref_steps[i][1](), step
            assert rec == ref_rec, step
            if check:
                assert_same_state(eng, ref, step)
    return counts, rec


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_passes_match_unsharded(name, n):
    """Every DeviceCleaner pass over an n-shard one-process mesh: the
    count, the bubble records and every gathered state tensor equal the
    unsharded engine's after each pass; each shard holds E/n and Vc/n
    rows of every tensor."""
    sdbg = graph(name)
    k, min_depth = sdbg.k - 1, infer_min_depth(sdbg)
    mesh = Mesh(["cpu"] * n)
    eng = tad.DeviceCleaner(build_unitig_graph(graph(name)), mesh=mesh)
    ref = tad.DeviceCleaner(build_unitig_graph(sdbg))
    assert eng.mesh is mesh and ref.mesh is None
    for f in dataclasses.fields(eng.state):
        blocks = getattr(eng.state, f.name).b
        rows = eng.vc if f.name in ("start", "end", "length", "depth",
                                    "is_loop", "is_pal", "alive",
                                    "changed") else eng.sdbg.size
        assert [b.shape[0] for b in blocks] == [rows // n] * n, f.name
    counts, rec = run_steps(eng, k, min_depth, ref)
    assert eng.rows.exchanges > 0
    if name != "loop_genome":
        assert sum(c[0] if isinstance(c, tuple) else c for c in counts)
    if name == "haplotypes_2k":
        assert rec


def test_size_audit_at_four_shards(capsys):
    """No pass of the 4-shard engine builds a tensor of the whole
    graph's rows: its largest tensor over the audited passes is at most
    half the unsharded engine's (about a quarter plus the exchange
    buffers). Construction uploads each shard's own rows only."""
    name = "haplotypes_8k"
    sdbg = graph(name)
    k, min_depth = sdbg.k - 1, infer_min_depth(sdbg)
    e = sdbg.size
    g_mesh, g_ref = build_unitig_graph(graph(name)), build_unitig_graph(sdbg)
    with SizeAudit() as built:
        eng = tad.DeviceCleaner(g_mesh, mesh=Mesh(["cpu"] * 4))
    with SizeAudit() as built_ref:
        ref = tad.DeviceCleaner(g_ref)
    assert eng.mesh is not None
    assert built.largest <= e // 4 < built_ref.largest == e
    audits = []
    for engine in (eng, ref):
        with audited(engine, Audit()) as audit:
            run_steps(engine, k, min_depth)
        audits.append(audit)
    sharded, whole = audits
    ratio = sharded.largest / whole.largest
    with capsys.disabled():
        print(f"\nsize audit, 4 shards, E {e}: largest tensor "
              f"{sharded.largest} ({sharded.op} in {sharded.where}) vs "
              f"{whole.largest} unsharded ({whole.op} in {whole.where}): "
              f"ratio {ratio:.3f}")
    assert whole.largest >= e
    assert ratio <= 0.5


PASS_WORKER = r"""
import json, os, sys
import torch
torch.set_num_threads(1)
port, rank, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
sys.path.insert(0, sys.argv[4])
from megahit_tpu_torch.parallel.multihost import (
    global_shard_mesh, init_distributed,
)
init_distributed(coordinator=f"localhost:{port}", num_processes=2,
                 process_id=rank, device="cpu")
mesh = global_shard_mesh("cpu")
assert (mesh.size, mesh.local, mesh.transport) == (2, [rank], "gloo")
import test_torch_mesh_passes as t
from megahit_tpu_torch.graph import assemble_device as tad
from megahit_tpu_torch.graph.cleaning import infer_min_depth
from megahit_tpu_torch.graph.unitig import build_unitig_graph

sdbg = t.graph("haplotypes_2k")
k, min_depth = sdbg.k - 1, infer_min_depth(sdbg)
eng = tad.DeviceCleaner(build_unitig_graph(t.graph("haplotypes_2k")),
                        mesh=mesh)
ref = tad.DeviceCleaner(build_unitig_graph(sdbg))
assert eng.mesh is mesh
assert [b.shape[0] for b in eng.state.valid.b] == [sdbg.size // 2]
# pass by pass against this rank's own unsharded engine
counts, rec = t.run_steps(eng, k, min_depth, ref)
# the size audit, each engine built afresh
largest = []
for m in (mesh, None):
    e = tad.DeviceCleaner(build_unitig_graph(t.graph("haplotypes_2k")),
                          mesh=m)
    with t.audited(e, t.Audit()) as audit:
        t.run_steps(e, k, min_depth)
    largest.append(audit.largest)
with open(os.path.join(outdir, f"passes{rank}.json"), "w") as fh:
    json.dump({"counts": [list(c) if isinstance(c, tuple) else c
                          for c in counts], "records": len(rec),
               "largest": largest, "exchanges": eng.rows.exchanges}, fh)
torch.distributed.destroy_process_group()
print("WORKER_DONE", rank, flush=True)
"""


def test_passes_on_two_gloo_ranks(tmp_path):
    """Each of two gloo ranks holds one shard (E/2 = 1024 rows) and runs
    every pass against its own unsharded engine, equal after each; its
    largest tensor over the audited passes is at most 0.75 of the
    unsharded engine's."""
    from test_torch_multiprocess import _run_ranks

    _run_ranks(tmp_path, PASS_WORKER, HERE)
    got = [json.loads((tmp_path / f"passes{r}.json").read_text())
           for r in range(2)]
    assert got[0]["counts"] == got[1]["counts"]
    assert got[0]["records"] == got[1]["records"] > 0
    for g in got:
        sharded, whole = g["largest"]
        print(f"rank largest tensor {sharded} vs {whole} unsharded: "
              f"ratio {sharded / whole:.3f}")
        assert sharded <= 0.75 * whole
        assert g["exchanges"] > 0


ASSEMBLE_WORKER = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
port, rank, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
sys.path.insert(0, sys.argv[4])
from megahit_tpu_torch.parallel.multihost import init_distributed
init_distributed(coordinator=f"localhost:{port}", num_processes=2,
                 process_id=rank, device="cpu")
import logging
from cleaning_cases import records
from megahit_tpu_torch.graph.sdbg import sdbg_from_edges
from megahit_tpu_torch.pipeline.assemble import AssembleOptions, assemble
from megahit_tpu_torch.utils import device as devices
from megahit_tpu_torch.utils.log import get_logger
import test_torch_mesh_passes as t

# the card's route on CPU tensors, so that the device cleaning engine's
# state shards over the two ranks
devices.graph_on_card = lambda device: True

lines = []
class Keep(logging.Handler):
    def emit(self, r):
        lines.append(r.getMessage())
get_logger().addHandler(Keep())
get_logger().setLevel(logging.INFO)
z = np.load(os.path.join(outdir, "edges.npz"))
res = assemble(sdbg_from_edges(z["keys"], z["counts"], 22, device="cpu"),
               AssembleOptions(use_mesh=True, **t.OPTIONS))
assert any("cleaning on device (cpu, 2-device mesh)" in m for m in lines)
with open(os.path.join(outdir, f"assemble{rank}.json"), "w") as fh:
    json.dump({"records": records(res), "stats": res.stats}, fh)
torch.distributed.destroy_process_group()
print("WORKER_DONE", rank, flush=True)
"""


def test_assemble_on_two_gloo_ranks(tmp_path, monkeypatch):
    """assemble() with use_mesh on two gloo ranks (the device engine on
    CPU tensors, one shard a rank): both ranks' contigs, bubble records
    and stats equal the single-process unsharded engine's and
    megahit_tpu's device engine's on the same edges."""
    from megahit_tpu.graph.counter import count_canonical_kmers as jcount
    from megahit_tpu.graph.sdbg import sdbg_from_edges as j_sdbg
    from megahit_tpu.pipeline import assemble as jasm
    from megahit_tpu_torch.pipeline import assemble as tasm
    from test_torch_multiprocess import _run_ranks

    reads, min_count = GRAPHS["haplotypes_8k"]()
    flat, starts = packing.pack_many(reads)
    keys, counts = jcount(flat, starts, 22, min_count)
    np.savez(tmp_path / "edges.npz", keys=np.asarray(keys),
             counts=np.asarray(counts))
    _run_ranks(tmp_path, ASSEMBLE_WORKER, HERE)

    monkeypatch.setenv("MEGAHIT_TPU_DEVICE_CLEAN", "1")
    want = jasm.assemble(j_sdbg(keys, counts, 22),
                         jasm.AssembleOptions(**OPTIONS))
    monkeypatch.setattr(devices, "graph_on_card", lambda device: True)
    single = tasm.assemble(sdbg_from_edges(keys, counts, 22, device="cpu"),
                           tasm.AssembleOptions(**OPTIONS))

    def norm(x):
        return json.loads(json.dumps(x))

    assert norm(records(single)) == norm(records(want))
    assert norm(single.stats) == norm(want.stats)
    assert records(single)[3], "no bubble records to compare"
    for rank in range(2):
        got = json.loads((tmp_path / f"assemble{rank}.json").read_text())
        assert got["records"] == norm(records(single)), rank
        assert got["stats"] == norm(single.stats), rank
