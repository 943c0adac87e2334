"""The port's multi-k ladder against megahit_tpu's, on the CPU.

Seeded numpy inputs go through both packages: the contig-union graph
builders (device-resident and host), the iterate flank index and scan,
the local-assembly mapper, mini-assembler and driver, and the CLI on the
make_test_data fixtures and on Illumina-like reads. Every array, edge
file and contig file must be equal, byte for byte where it is a file."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from megahit_tpu.__main__ import main as jax_main
from megahit_tpu.core import kmerops as jkmer
from megahit_tpu.core import packing
from megahit_tpu.graph import iterate as jit_
from megahit_tpu.graph import sdbg as jsdbg
from megahit_tpu.io.contig_io import ContigRecord as JRecord
from megahit_tpu.io.lib import SequenceLib as JLib
from megahit_tpu.localasm import local_assemble as jlocal
from megahit_tpu.localasm import mapper as jmap
from megahit_tpu.localasm import mini_asm as jmini
from megahit_tpu.pipeline.options import Options as JOptions
from megahit_tpu_torch.__main__ import main as torch_main
from megahit_tpu_torch.graph import iterate as tit
from megahit_tpu_torch.graph import sdbg as tsdbg
from megahit_tpu_torch.io.contig_io import ContigRecord as TRecord
from megahit_tpu_torch.io.lib import SequenceLib as TLib
from megahit_tpu_torch.localasm import local_assemble as tlocal
from megahit_tpu_torch.localasm import mapper as tmap
from megahit_tpu_torch.localasm import mini_asm as tmini
from megahit_tpu_torch.pipeline.options import Options as TOptions

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _pool(rng, n_seqs, lmin, lmax):
    seqs = [rng.integers(0, 4, int(rng.integers(lmin, lmax))).astype(
        np.uint8) for _ in range(n_seqs)]
    return packing.pack_many(seqs)


def _assert_sdbg_equal(t, j):
    assert (t.k, t.real, t.size) == (j.k, j.real, j.size)
    for name in ("keys", "mult", "valid", "run_start", "nxt_link", "rc"):
        np.testing.assert_array_equal(np.asarray(getattr(t, name)),
                                      np.asarray(getattr(j, name)), name)


# ---------------------------------------------------------------------------
# the contig-union graph builders (tests/test_device_build.py cases)
# ---------------------------------------------------------------------------


def _build_case(case):
    """(flat, starts, mults, k1, edge_keys, edge_counts) per case."""
    rng = np.random.default_rng(99)
    if case.startswith("k1="):
        k1 = int(case[3:])
        flat, starts = _pool(rng, 80, 60, 200)
        return flat, starts, rng.integers(1, 9, 80).astype(np.int32), \
            k1, None, None
    if case == "edges":
        k1 = 22
        flat, starts = _pool(rng, 50, 80, 150)
        mults = rng.integers(1, 5, 50).astype(np.int32)
        w = jkmer.words_per_kmer(k1)
        ek = np.asarray(jkmer.mask_tail(
            rng.integers(0, 2 ** 32, (200, w)).astype(np.uint32), k1))
        ec = rng.integers(1, 30, 200).astype(np.int32)
        return flat, starts, mults, k1, ek, ec
    if case == "short_empty":
        seqs = [rng.integers(0, 4, n).astype(np.uint8)
                for n in (5, 21, 22, 23, 300, 0, 40)]
        flat, starts = packing.pack_many(seqs)
        return flat, starts, np.ones(len(seqs), np.int32), 22, None, None
    assert case == "all_t_k32"
    polyt = np.full(80, 3, np.uint8)
    other = rng.integers(0, 4, 150).astype(np.uint8)
    flat, starts = packing.pack_many([polyt, other])
    return flat, starts, np.array([7, 2], np.int32), 32, None, None


BUILD_CASES = ["k1=22", "k1=32", "k1=62", "edges", "short_empty",
               "all_t_k32"]


@pytest.mark.parametrize("case", BUILD_CASES)
def test_device_resident_build_matches_jax(case):
    flat, starts, mults, k1, ek, ec = _build_case(case)
    j = jsdbg.build_sdbg_device_resident(flat, starts, mults, k1,
                                         edge_keys=ek, edge_counts=ec)
    t = tsdbg.build_sdbg_device_resident(flat, starts, mults, k1,
                                         edge_keys=ek, edge_counts=ec,
                                         device="cpu")
    _assert_sdbg_equal(t, j)


@pytest.mark.parametrize("case", BUILD_CASES)
def test_host_union_build_matches_jax(case):
    """window_edge_multiset + _finalize_sdbg, the CPU route of the
    driver, against megahit_tpu's host route."""
    flat, starts, mults, k1, ek, ec = _build_case(case)
    jk, jm = jsdbg.window_edge_multiset(flat, starts, mults, k1)
    tk, tm = tsdbg.window_edge_multiset(flat, starts, mults, k1,
                                        device="cpu")
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tm, jm)
    if ek is not None:
        rc = np.asarray(jkmer.revcomp_kmers(ek, k1))
        jk = np.concatenate([jk, ek, rc])
        jm = np.concatenate([jm, ec, ec]).astype(np.int32)
    j = jsdbg._finalize_sdbg(jk, jm, k1, n_windows=len(jk))
    t = tsdbg._finalize_sdbg(jk, jm, k1, n_windows=len(jk), device="cpu")
    _assert_sdbg_equal(t, j)


# ---------------------------------------------------------------------------
# iterate (tests/test_iterate.py cases)
# ---------------------------------------------------------------------------


def _iterate_case(case):
    rng = np.random.default_rng(5)
    k, step = 21, 10
    if case == "dedup":
        base = rng.integers(0, 4, size=22).astype(np.uint8)
        c_short = np.concatenate([base, rng.integers(0, 4, 3).astype(
            np.uint8)])
        c_long = np.concatenate([c_short[:25], rng.integers(
            0, 4, 20).astype(np.uint8)])
        contigs, muls = [c_short, c_long], [1.0, 2.0]
        reads = [c_long.copy(), c_short.copy()]
    elif case == "junction":
        genome = rng.integers(0, 4, size=200).astype(np.uint8)
        contigs, muls = [genome[:100].copy(), genome[78:].copy()], [5., 7.]
        reads = [genome[s:s + 60].copy() for s in range(0, 141, 3)]
    elif case == "no_contigs":
        contigs, muls = [], []
        reads = [rng.integers(0, 4, 80).astype(np.uint8)]
    else:
        assert case == "many_junctions"
        genome = rng.integers(0, 4, size=300_000).astype(np.uint8)
        contigs = [genome[s:s + 400].copy()
                   for s in range(0, len(genome) - 400, 360)]
        muls = [2.0] * len(contigs)
        reads = [genome[s:s + 120].copy()
                 for s in range(0, len(genome) - 120, 37)]
    return contigs, muls, k, step, reads


@pytest.mark.parametrize("case", ["dedup", "junction", "no_contigs",
                                  "many_junctions"])
def test_iterate_matches_jax(case):
    contigs, muls, k, step, reads = _iterate_case(case)
    ji = jit_.build_flank_index(contigs, muls, k, step)
    ti = tit.build_flank_index(contigs, muls, k, step)
    for f in ("keys", "ext_bases", "ext_len", "mul"):
        np.testing.assert_array_equal(getattr(ti, f), getattr(ji, f), f)
    flat, starts = packing.pack_many(reads)
    jk, jm = jit_.find_next_kmers(flat, starts, ji)
    tk, tm = tit.find_next_kmers(flat, starts, ti, device="cpu")
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tm, jm)
    if case in ("junction", "many_junctions"):
        assert len(tk) > 0


# ---------------------------------------------------------------------------
# local assembly (tests/test_localasm.py cases)
# ---------------------------------------------------------------------------


def _assert_map_equal(t, j):
    for f in ("contig_id", "contig_from", "contig_to", "query_from",
              "query_to", "strand", "mismatch"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)


@pytest.mark.parametrize("case", ["exact", "mismatches"])
def test_mapper_matches_jax(case):
    rng = np.random.default_rng(77)
    if case == "exact":
        genome = rng.integers(0, 4, size=2000).astype(np.uint8)
        contigs = [genome[:1000].copy(), genome[1000:].copy()]
        reads = []
        for s in range(0, 1900, 37):
            r = genome[s:s + 100]
            reads.append(packing.revcomp_codes(r) if rng.random() < 0.5
                         else r.copy())
    else:
        genome = rng.integers(0, 4, size=1200).astype(np.uint8)
        contigs = [genome.copy()]
        r = genome[200:300].copy()
        r[10] = (r[10] + 1) % 4
        r[90] = (r[90] + 2) % 4
        reads = [r]
    ji = jmap.build_seed_index(contigs)
    ti = tmap.build_seed_index(contigs, device="cpu")
    for f in ("keys", "contig_id", "offset", "strand", "contig_lens"):
        np.testing.assert_array_equal(getattr(ti, f), getattr(ji, f), f)
    flat, starts = packing.pack_many(reads)
    t = tmap.map_reads(flat, starts, ti, device="cpu")
    _assert_map_equal(t, jmap.map_reads(flat, starts, ji))
    assert t.valid.any()


def _same_contigs(t, j):
    assert sorted(t) == sorted(j)
    for g in j:
        assert len(t[g]) == len(j[g])
        for a, b in zip(t[g], j[g]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["single_group", "large_k_rungs"])
def test_mini_assemble_matches_jax(case):
    rng = np.random.default_rng(77)
    if case == "single_group":
        genome = rng.integers(0, 4, size=500).astype(np.uint8)
        groups = [[genome[i:i + 100].copy() for i in range(0, 400, 4)]]
        ends, maxk = [genome[:100].copy()], 41
    else:
        genome = rng.integers(0, 4, 900).astype(np.uint8)
        groups = [[genome[s:s + 200].copy()
                   for s in range(0, len(genome) - 200, 9)]]
        ends, maxk = [genome[:250].copy()], 131
    j = jmini.mini_assemble(groups, ends, mink=11, maxk=maxk, step=6)
    t = tmini.mini_assemble(groups, ends, mink=11, maxk=maxk, step=6)
    _same_contigs(t, j)
    assert t[0]


def test_local_assembly_matches_jax():
    rng = np.random.default_rng(77)
    genome = rng.integers(0, 4, size=1500).astype(np.uint8)
    c1, c2 = genome[:600].copy(), genome[900:].copy()
    insert, rl = 300, 100
    seqs = []
    for s in range(0, len(genome) - insert + 1, 2):
        frag = genome[s:s + insert]
        seqs.append(frag[:rl].copy())
        seqs.append(packing.revcomp_codes(frag[-rl:]))
    flat, starts = packing.pack_many(seqs)
    outs = []
    for lib_cls, rec, run, kw in (
            (JLib, JRecord, jlocal.run_local_assembly, {}),
            (TLib, TRecord, tlocal.run_local_assembly, {"device": "cpu"})):
        lib = lib_cls(flat, starts, [(0, len(seqs), True)])
        contigs = [rec(c1, 21, 0, 0, 10.0), rec(c2, 21, 1, 0, 10.0)]
        outs.append([(c.codes.tobytes(), c.flag, c.cid, c.k, c.multi)
                     for c in run(lib, contigs, local_kmax=41, **kw)])
    assert outs[0] and outs[1] == outs[0]


# ---------------------------------------------------------------------------
# options and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_len,auto_k", [(100, True), (35, True),
                                            (300, True), (100, False)])
def test_drop_large_k_matches_jax(max_len, auto_k):
    res = []
    for cls in (JOptions, TOptions):
        o = cls(se=["x.fa"], auto_k=auto_k)
        o.validate()
        changed = o.drop_large_k(max_len)
        res.append((changed, o.k_list, o.k_min, o.k_max))
    assert res[1] == res[0]


def _contig_files(root: pathlib.Path) -> list[str]:
    names = sorted(str(p.relative_to(root))
                   for p in root.glob("intermediate_contigs/*"))
    return names + ["final.contigs.fa"]


def _assert_runs_equal(j: pathlib.Path, t: pathlib.Path) -> None:
    names = _contig_files(j)
    assert _contig_files(t) == names
    for name in names:
        assert (t / name).read_bytes() == (j / name).read_bytes(), name
    edges = sorted(str(p.relative_to(j)) for p in j.glob("tmp/k*/*.npz"))
    assert sorted(str(p.relative_to(t))
                  for p in t.glob("tmp/k*/*.npz")) == edges
    for name in edges:
        a, b = np.load(j / name), np.load(t / name)
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            np.testing.assert_array_equal(b[f], a[f], f"{name}:{f}")


@pytest.mark.parametrize("flags", [[], ["--no-local"]])
def test_fixture_ladder_byte_identical(flags, tmp_path):
    """--k-list 21,39,59 on the fixtures: key widths W = 2, 3 and 4."""
    args = ["--test", "--k-list", "21,39,59", "--keep-tmp-files"] + flags
    assert jax_main(args + ["-o", str(tmp_path / "jax")]) == 0
    assert torch_main(args + ["--device", "cpu",
                              "-o", str(tmp_path / "torch")]) == 0
    _assert_runs_equal(tmp_path / "jax", tmp_path / "torch")
    assert (tmp_path / "torch/final.contigs.fa").read_bytes().count(b">")


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """Illumina-like pairs of a 12 kbp genome at 20x (the repo's
    generator): the ladder runs iterate and local assembly at every
    rung."""
    d = tmp_path_factory.mktemp("reads")
    subprocess.run([sys.executable, str(ROOT / "scripts/make_realistic.py"),
                    str(d), "--genome-bp", "12000", "--coverage", "20",
                    "--seed", "3"], check=True, capture_output=True,
                   timeout=120)
    return ["-1", str(d / "reads_1.fq.gz"), "-2", str(d / "reads_2.fq.gz")]


def test_realistic_ladder_byte_identical(reads, tmp_path):
    args = reads + ["--k-list", "21,29,39,59", "--keep-tmp-files"]
    assert jax_main(args + ["-o", str(tmp_path / "jax")]) == 0
    assert torch_main(args + ["--device", "cpu",
                              "-o", str(tmp_path / "torch")]) == 0
    _assert_runs_equal(tmp_path / "jax", tmp_path / "torch")
    log = (tmp_path / "torch/log").read_text()
    assert "early termination" not in log
    assert "local contigs" in log and "junction windows" in log


def test_continue_mid_ladder(reads, tmp_path):
    """A run stopped after the k=29 graph's assembly resumes there with
    --continue and ends with the same final.contigs.fa."""
    out = tmp_path / "resume"
    args = reads + ["--k-list", "21,29,39", "--device", "cpu",
                    "-o", str(out)]
    assert torch_main(args) == 0
    want = (out / "final.contigs.fa").read_bytes()
    assert want.count(b">")
    # stages: 0 lib, 1 first graph, 2 assemble 21, 3 local, 4 iterate,
    # 5 assemble 29, 6 local, 7 iterate, 8 assemble 39, 9 merge
    (out / "checkpoints.txt").write_text(
        "".join(f"{i} done\n" for i in range(6)))
    for name in ("final.contigs.fa", "done",
                 "intermediate_contigs/k39.contigs.fa",
                 "intermediate_contigs/k29.local.fa"):
        os.unlink(out / name)
    assert torch_main(["--continue", "--device", "cpu",
                       "-o", str(out)]) == 0
    assert (out / "final.contigs.fa").read_bytes() == want
    log = (out / "log").read_text()
    assert "skipping checkpointed stage 5 (stage_assemble)" in log
    assert "stage 6 (stage_local 29 39)" in log
    assert "stage 8 (stage_assemble 39)" in log
