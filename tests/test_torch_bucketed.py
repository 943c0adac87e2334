"""The port's out-of-core SdBG build (megahit_tpu_torch/graph/
bucketed.py) and its driver routes against megahit_tpu's, on the CPU.

The cases of tests/test_bucketed.py (all but the mesh one and those of
megahit_tpu's per-bucket grid sort, which the port does not have: it
sorts a round in one sort) run through the port with device="cpu";
`_sort_on_host` is patched where a case also runs the card's sort route
on CPU tensors. The same seeded inputs go through both packages' builds
(every Sdbg array equal, "max" and "count" mode) and both CLIs (-m 1000
and --kmin-1pass: final.contigs.fa and the k_min .counting file
byte-identical)."""

import gzip
import os

import numpy as np
import pytest

from megahit_tpu.__main__ import main as jax_main
from megahit_tpu.core import kmerops as jkmer
from megahit_tpu.core import packing
from megahit_tpu.graph import bucketed as jbk
from megahit_tpu.graph.counter import count_canonical_kmers
from megahit_tpu.graph.sdbg import _finalize_sdbg, window_edge_multiset
from megahit_tpu_torch.__main__ import main as torch_main
from megahit_tpu_torch.core import kmerops as tkmer
from megahit_tpu_torch.graph import bucketed as bk
from megahit_tpu_torch.io.contig_io import read_contigs

import torch_test_env  # noqa: F401

RNG = np.random.default_rng(42)


def _random_pool(n_seqs, length, rng=RNG):
    seqs = [rng.integers(0, 4, size=length).astype(np.uint8)
            for _ in range(n_seqs)]
    return packing.pack_many(seqs)


def _reference_build(sources, k):
    """megahit_tpu's in-memory path over the same union multiset."""
    import jax.numpy as jnp

    keys_l, mults_l = [], []
    for src in sources:
        if isinstance(src, bk.PoolSource):
            kk, mm = window_edge_multiset(
                src.flat_codes, src.starts,
                np.asarray(src.mults, np.int32), k)
            keys_l.append(kk)
            mults_l.append(mm)
        else:
            rc = np.asarray(jkmer.revcomp_kmers(jnp.asarray(src.keys), k))
            keys_l.extend([src.keys, rc])
            mults_l.extend([src.counts, src.counts])
    keys = np.concatenate(keys_l, axis=0)
    mults = np.concatenate(mults_l).astype(np.int32)
    return _finalize_sdbg(keys, mults, k, n_windows=len(keys))


def _assert_sdbg_equal(t, j):
    assert (t.k, t.real, t.size) == (j.k, j.real, j.size)
    for name in ("keys", "mult", "valid", "run_start", "nxt_link", "rc"):
        np.testing.assert_array_equal(np.asarray(getattr(t, name)),
                                      np.asarray(getattr(j, name)), name)


@pytest.fixture
def tensor_sort(monkeypatch):
    """Force the card's round sort (one torch sort) on CPU tensors."""
    monkeypatch.setattr(bk, "_sort_on_host", lambda device: False)


def _edge_source(k, n=100, rng=RNG):
    import jax.numpy as jnp

    raw = rng.integers(0, 2**32, (n, jkmer.words_per_kmer(k))).astype(
        np.uint32)
    keys = np.asarray(jkmer.canonical_kmers(jnp.asarray(raw), k)[0])
    keys = np.asarray(jkmer.mask_tail(jnp.asarray(keys), k))
    return keys, rng.integers(1, 100, size=n).astype(np.int32)


# ---------------------------------------------------------------------------
# tests/test_bucketed.py cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [22, 31, 32, 45])
def test_numpy_key_ops_match_jax(k):
    """The host key ops megahit_tpu's bucketed module names np_* (the
    port keeps np_revcomp and calls kmerops on numpy for the rest)."""
    import jax.numpy as jnp

    w = jkmer.words_per_kmer(k)
    keys = RNG.integers(0, 2**32, (257, w)).astype(np.uint32)
    keys = np.asarray(jkmer.mask_tail(jnp.asarray(keys), k))
    dev = jnp.asarray(keys)
    for got, want in (
            (bk.np_revcomp(keys, k), jbk.np_revcomp(keys, k)),
            (tkmer.drop_first_base(keys, k),
             jbk.np_drop_first_base(keys, k)),
            (tkmer.mask_tail(keys, k - 1), jbk.np_mask_tail(keys, k - 1)),
            (tkmer.get_base(keys, 0), jbk.np_get_base(keys, 0)),
            (tkmer.get_base(keys, k - 1), jkmer.get_base(dev, k - 1))):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("k", [22, 32])
def test_bucketed_matches_in_memory(tmp_path, k):
    flat, starts = _random_pool(40, 200)
    mults = RNG.integers(1, 5, size=40).astype(np.int32)
    ekeys, ecounts = _edge_source(k)
    sources = [bk.PoolSource(flat, starts, mults),
               bk.EdgeSource(ekeys, ecounts)]
    ref = _reference_build(sources, k)
    stats = bk.BuildStats()
    budget = 2048  # windows ~ 2*40*(200-k+1) + 200 >> budget
    out = bk.build_sdbg_bucketed(
        sources, k, budget_rows=budget,
        spill_dir=str(tmp_path / f"spill{k}"), stats=stats, device="cpu")
    _assert_sdbg_equal(out, ref)
    assert stats.n_rounds > 4
    # the memory-bounded guarantee: no round loaded more than budget
    assert stats.max_round_rows <= budget


def test_bucketed_high_multiplicity_clamp(tmp_path):
    flat, starts = _random_pool(4, 100)
    mults = np.array([70000, 2, 2, 2], dtype=np.int32)
    sources = [bk.PoolSource(flat, starts, mults)]
    out = bk.build_sdbg_bucketed(sources, 22, budget_rows=1 << 20,
                                 spill_dir=str(tmp_path / "spillm"),
                                 device="cpu")
    _assert_sdbg_equal(out, _reference_build(sources, 22))


def test_bucketed_empty(tmp_path):
    out = bk.build_sdbg_bucketed([], 22, budget_rows=1024,
                                 spill_dir=str(tmp_path / "spill0"),
                                 device="cpu")
    assert not out.valid.any()


def _lexsorted(r):
    return r[np.lexsort(tuple(r[:, i] for i in range(r.shape[1] - 1, -1,
                                                      -1)))]


def test_spill_roundtrip(tmp_path):
    """Appends of rows in bucket order land in their 8-bit prefix file,
    counted; a range reads back exactly its buckets' rows, in bucket
    order."""
    spill = bk.SpillSet(str(tmp_path), "t", 3)
    allrows = []
    for _ in range(5):
        rows = RNG.integers(0, 2**32, (2000, 3)).astype(np.uint32)
        b8 = rows[:, 0] >> np.uint32(24)
        spill.append([(rows[np.argsort(b8, kind="stable")],
                       np.bincount(b8, minlength=bk.N_BUCKETS))])
        allrows.append(rows)
    allrows = np.concatenate(allrows)
    pref = (allrows[:, 0] >> np.uint32(24)).astype(np.int64)
    np.testing.assert_array_equal(
        spill.counts, np.bincount(pref, minlength=bk.N_BUCKETS))
    rows = spill.read_range(0, bk.N_BUCKETS)
    assert len(rows) == len(allrows)
    assert (np.diff((rows[:, 0] >> np.uint32(24)).astype(np.int64))
            >= 0).all()
    np.testing.assert_array_equal(_lexsorted(rows), _lexsorted(allrows))
    mid = spill.read_range(40, 90)
    np.testing.assert_array_equal(
        _lexsorted(mid), _lexsorted(allrows[(pref >= 40) & (pref < 90)]))
    spill.cleanup()
    assert not any(os.path.exists(p) for p in spill.paths)


def _skewed():
    big = np.zeros((5000, 2), np.uint32)
    big[:, 0] = 7 << 16
    big[:, 1] = RNG.integers(0, 2**32, 5000).astype(np.uint32)
    return np.concatenate(
        [big, RNG.integers(0, 2**32, (3000, 2)).astype(np.uint32)])


def _identical_mega_group():
    ident = np.empty((4000, 2), np.uint32)
    ident[:, 0] = (3 << 16) | 5
    ident[:, 1] = 77
    return np.concatenate(
        [ident, RNG.integers(0, 2**32, (3000, 2)).astype(np.uint32)])


def _three_words():
    a = np.zeros((6000, 3), np.uint32)
    a[:, 0] = (1 << 16) | RNG.integers(0, 2**16, 6000).astype(np.uint32)
    a[:, 1] = RNG.integers(0, 2**32, 6000).astype(np.uint32)
    a[:, 2] = RNG.integers(0, 100, 6000).astype(np.uint32)
    return np.concatenate(
        [a, RNG.integers(0, 2**32, (2000, 3)).astype(np.uint32)])


@pytest.mark.parametrize("route", ["host", "tensor"])
@pytest.mark.parametrize("shape", ["uniform", "skewed", "identical",
                                   "three_words"])
def test_sort_rows_matches_global(shape, route, monkeypatch):
    """A round's sort == one global lexicographic sort (and ==
    megahit_tpu's), on the host route and on the card's route run on CPU
    tensors: one giant prefix bucket among small ones, a run of
    identical rows, three words with a small trailing word."""
    rows = {"uniform": lambda: RNG.integers(
                0, 2**32, (30000, 3)).astype(np.uint32),
            "skewed": _skewed, "identical": _identical_mega_group,
            "three_words": _three_words}[shape]()
    if route == "tensor":
        monkeypatch.setattr(bk, "_sort_on_host", lambda device: False)
    out = bk._sort_rows(rows.copy(), "cpu")
    np.testing.assert_array_equal(out, _lexsorted(rows))
    np.testing.assert_array_equal(out, jbk._sort_rows(rows.copy()))


@pytest.mark.parametrize("k", [22, 32])
def test_bucketed_tensor_sort_matches(tmp_path, k, tensor_sort):
    flat, starts = _random_pool(30, 150)
    mults = RNG.integers(1, 5, size=30).astype(np.int32)
    sources = [bk.PoolSource(flat, starts, mults)]
    out = bk.build_sdbg_bucketed(sources, k, budget_rows=1500,
                                 spill_dir=str(tmp_path / "sp"),
                                 device="cpu")
    _assert_sdbg_equal(out, _reference_build(sources, k))


def test_count_mode_palindrome_not_doubled(tmp_path):
    """A palindromic (k1 even) window spills BOTH strand rows into one
    group; count mode must un-double it, or a once-seen palindromic
    edge passes min_count=2."""
    rng = np.random.default_rng(3)
    k1 = 22
    half = rng.integers(0, 4, k1 // 2).astype(np.uint8)
    pal = np.concatenate([half, packing.revcomp_codes(half)])
    reads = [np.concatenate([rng.integers(0, 4, 30).astype(np.uint8), pal,
                             rng.integers(0, 4, 30).astype(np.uint8)])]
    reads += [rng.integers(0, 4, 60).astype(np.uint8) for _ in range(20)]
    flat, starts = packing.pack_many(reads)
    for mc in (1, 2):
        keys, counts = count_canonical_kmers(flat, starts, k1, mc)
        sdbg = bk.build_sdbg_bucketed(
            [bk.PoolSource(flat, starts, np.ones(len(reads), np.int32))],
            k1, budget_rows=1 << 14, spill_dir=str(tmp_path / f"s{mc}"),
            min_count=mc, mult_mode="count", device="cpu")
        canon = sdbg.valid & (np.arange(sdbg.size) <= sdbg.rc)
        np.testing.assert_array_equal(sdbg.keys[canon], keys)
        np.testing.assert_array_equal(sdbg.mult[canon], counts)


def test_unit_mult_spill_path_identical(tmp_path):
    """Unit-multiplicity path (no mult word spilled) == the general
    count path on the same multiset."""
    flat, starts = _random_pool(60, 120)
    ones = np.ones(60, np.int32)
    src_unit = [bk.PoolSource(flat, starts, ones)]
    # an empty EdgeSource disables the unit path without changing the
    # multiset
    src_gen = [bk.PoolSource(flat, starts, ones),
               bk.EdgeSource(np.zeros((0, 2), np.uint32),
                             np.zeros(0, np.int32))]
    for mc in (1, 2):
        a = bk.build_sdbg_bucketed(src_unit, 22, 4096,
                                   str(tmp_path / f"u{mc}"), min_count=mc,
                                   mult_mode="count", device="cpu")
        b = bk.build_sdbg_bucketed(src_gen, 22, 4096,
                                   str(tmp_path / f"g{mc}"), min_count=mc,
                                   mult_mode="count", device="cpu")
        assert a.real == b.real
        np.testing.assert_array_equal(a.keys[:a.real], b.keys[:b.real])
        np.testing.assert_array_equal(a.mult[:a.real], b.mult[:b.real])


def test_unit_mult_disabled_at_16_multiple_k(tmp_path):
    flat, starts = _random_pool(40, 120)
    src = [bk.PoolSource(flat, starts, np.ones(40, np.int32))]
    sdbg = bk.build_sdbg_bucketed(src, 32, 4096, str(tmp_path / "k32"),
                                  min_count=1, mult_mode="count",
                                  device="cpu")
    ref = _reference_build(src, 32)
    np.testing.assert_array_equal(sdbg.keys[:sdbg.real],
                                  ref.keys[:ref.real])
    np.testing.assert_array_equal(sdbg.mult[:sdbg.real],
                                  ref.mult[:ref.real])


# ---------------------------------------------------------------------------
# both packages' builds on the same inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sort", ["host", "tensor"])
@pytest.mark.parametrize("mode,k", [("max", 22), ("max", 45),
                                    ("count", 22), ("count", 32)])
def test_bucketed_matches_jax(tmp_path, mode, k, sort, monkeypatch):
    """Every Sdbg array of the port's build == megahit_tpu's, from mixed
    pool (+ edge, in max mode) sources over several rounds; count mode
    with min_count 2 over reads with repeats."""
    rng = np.random.default_rng(k)
    if sort == "tensor":
        monkeypatch.setattr(bk, "_sort_on_host", lambda device: False)
    if mode == "max":
        flat, starts = _random_pool(30, 160, rng)
        mults = rng.integers(1, 9, size=30).astype(np.int32)
        ekeys, ecounts = _edge_source(k, rng=rng)
        srcs = [(bk.PoolSource(flat, starts, mults),
                 jbk.PoolSource(flat, starts, mults)),
                (bk.EdgeSource(ekeys, ecounts),
                 jbk.EdgeSource(ekeys, ecounts))]
        kw = {}
    else:
        genome = rng.integers(0, 4, 1500).astype(np.uint8)
        reads = [genome[s:s + 90] for s in rng.integers(0, 1410, 160)]
        flat, starts = packing.pack_many(reads)
        ones = np.ones(len(reads), np.int32)
        srcs = [(bk.PoolSource(flat, starts, ones),
                 jbk.PoolSource(flat, starts, ones))]
        kw = dict(mult_mode="count", min_count=2)
    tstats, jstats = bk.BuildStats(), jbk.BuildStats()
    got = bk.build_sdbg_bucketed([t for t, _ in srcs], k, 1500,
                                 str(tmp_path / "t"), stats=tstats,
                                 device="cpu", **kw)
    want = jbk.build_sdbg_bucketed([j for _, j in srcs], k, 1500,
                                   str(tmp_path / "j"), stats=jstats, **kw)
    _assert_sdbg_equal(got, want)
    assert got.real > 0 and tstats.n_rounds == jstats.n_rounds > 1
    assert tstats.round_ranges == jstats.round_ranges


# ---------------------------------------------------------------------------
# the CLI: -m routing and --kmin-1pass, against megahit_tpu's CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pe_reads(tmp_path_factory):
    """Paired reads with 1% substitutions over a genome with a 30-bp
    repeat: the k=21 graph breaks at the repeat (so k=41 runs) and the
    errors leave gaps for mercy to fill."""
    d = tmp_path_factory.mktemp("pe")
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, size=9000).astype(np.uint8)
    genome[6000:6030] = genome[2000:2030]
    p1, p2 = str(d / "r1.fa.gz"), str(d / "r2.fa.gz")
    insert, rl = 250, 100
    with gzip.open(p1, "wt") as f1, gzip.open(p2, "wt") as f2:
        for i, s in enumerate(range(0, len(genome) - insert, 3)):
            frag = genome[s: s + insert].copy()
            m = rng.random(insert) < 0.01
            frag[m] = (frag[m] + rng.integers(1, 4, int(m.sum()))) % 4
            f1.write(f">r{i}/1\n{packing.decode(frag[:rl])}\n")
            f2.write(f">r{i}/2\n"
                     f"{packing.decode(packing.revcomp_codes(frag[-rl:]))}"
                     "\n")
    return p1, p2


def _run(main, root, name, p1, p2, extra, device=True):
    out = root / name
    argv = ["-1", p1, "-2", p2, "-o", str(out), "--k-list", "21,41",
            "--no-local", "--keep-tmp-files", *extra]
    assert main(argv + (["--device", "cpu"] if device else [])) == 0
    return out


def _contig_set(out):
    return sorted((c.length, packing.decode(c.codes))
                  for c in read_contigs(str(out / "final.contigs.fa")))


def _same_files(a, b):
    for rel in ("final.contigs.fa", "tmp/k21/k21.counting"):
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


def test_cli_forced_bucketed_matches_jax(pe_reads, tmp_path):
    """-m 1000 bytes floors the budget at 2^14 rows: both rungs build
    out of core (a spill directory at each k), byte-identical to
    megahit_tpu's run, with the in-memory run's contig set."""
    p1, p2 = pe_reads
    small = _run(torch_main, tmp_path, "small", p1, p2, ["-m", "1000"])
    for k in (21, 41):
        assert (small / "tmp" / f"k{k}" / "spill").is_dir()
    big = _run(torch_main, tmp_path, "big", p1, p2, [])
    assert not (big / "tmp" / "k21" / "spill").exists()
    assert _contig_set(small) == _contig_set(big)
    jax = _run(jax_main, tmp_path, "jax", p1, p2, ["-m", "1000"],
               device=False)
    _same_files(small, jax)


def test_cli_kmin_1pass_matches_jax(pe_reads, tmp_path):
    """--kmin-1pass (read2sdbg S1+S2) gives the 2-pass run's contigs
    and .counting; with mercy on it still writes the k_min edge file;
    byte-identical to megahit_tpu's --kmin-1pass run."""
    p1, p2 = pe_reads
    one = _run(torch_main, tmp_path, "one", p1, p2, ["--kmin-1pass"])
    assert (one / "tmp" / "k21" / "k21.edges.npz").exists()
    two = _run(torch_main, tmp_path, "two", p1, p2, [])
    assert _contig_set(one) == _contig_set(two)
    assert (one / "tmp/k21/k21.counting").read_bytes() == \
        (two / "tmp/k21/k21.counting").read_bytes()
    jax = _run(jax_main, tmp_path, "jax", p1, p2, ["--kmin-1pass"],
               device=False)
    _same_files(one, jax)


def test_kmin_1pass_min_count_1_and_mem_flag_0(tmp_path):
    """min_count 1 implies 1-pass + no mercy: the k_min graph is saved
    directly (no edge file); --mem-flag 0 (pool on disk, smaller
    rounds) gives megahit_tpu's contigs byte for byte."""
    genome = np.random.default_rng(11).integers(0, 4, size=4000).astype(
        np.uint8)
    p1 = str(tmp_path / "r1.fa.gz")
    with gzip.open(p1, "wt") as f1:
        for i, s in enumerate(range(0, len(genome) - 100, 2)):
            f1.write(f">r{i}\n{packing.decode(genome[s:s + 100])}\n")
    outs = []
    for main, name, dev in ((torch_main, "o", ["--device", "cpu"]),
                            (jax_main, "j", [])):
        out = tmp_path / name
        assert main(["-r", p1, "-o", str(out), "--k-list", "21,41",
                     "--min-count", "1", "--no-local", "--keep-tmp-files",
                     "--mem-flag", "0", *dev]) == 0
        outs.append(out)
    tmp = outs[0] / "tmp" / "k21"
    assert not (tmp / "k21.edges.npz").exists()
    assert (tmp / "k21.sdbg.npz").exists()
    finals = read_contigs(str(outs[0] / "final.contigs.fa"))
    assert len(finals) == 1 and finals[0].length >= len(genome) - 10
    _same_files(*outs)
    assert "mem_flag" in (outs[0] / "options.json").read_text()
    assert os.path.getsize(outs[0] / "final.contigs.fa") > 0
