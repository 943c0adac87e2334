"""The plain reference: its k-mer arithmetic against a direct count,
its first graph against megahit_tpu_torch on the CPU, and the control
(the reference with a stated guarantee broken) reading as not
correct."""

import numpy as np
import pytest

import check
import judge
from reference import contigs as rc
from reference import first_graph as ref
from traffic import community

TINY = dict(genomes=5, min_bp=3000, max_bp=6000, min_cov=2.0, max_cov=40.0)


def _naive(c, k):
    out = []
    for i in range(len(c) - k + 1):
        f = int("".join(map(str, c[i:i + k])), 4)
        r = int("".join(str(3 - x) for x in c[i:i + k][::-1]), 4)
        out.append(min(f, r))
    return out


@pytest.mark.parametrize("k", [1, 5, 16, 21, 22, 31, 32])
def test_canonical_kmers(k):
    c = np.random.default_rng(k).integers(0, 4, (3, 60)).astype(np.uint8)
    got = ref.canonical(c, k)
    for row in range(3):
        assert [int(x) for x in got[row]] == _naive(c[row], k)
    rc = ref.revcomp(got[0], k)
    assert np.array_equal(ref.revcomp(rc, k), got[0])


def test_mercy_by_hand():
    """A read whose middle edges are not solid: the gap between the last
    in-only node and the next out-only node becomes mercy edges."""
    k1 = 13
    rng = np.random.default_rng(3)
    read = rng.integers(0, 4, 60).astype(np.uint8)
    edges = ref.canonical(read[None, :], k1)[0]
    # solid: the first 10 and the last 10 edges of the read
    solid = np.unique(np.concatenate([edges[:10], edges[-10:]]))
    fwd, rev = ref.kmers(read[None, :], k1)
    mercy = ref.mercy_edges(fwd, np.minimum(fwd, rev), solid, k1)
    middle = set(edges[10:-10].tolist()) - set(solid.tolist())
    assert len(middle) == len(edges) - 20
    assert set(mercy.tolist()) == middle


def test_edges_differ_counts_each_kind():
    a = np.array([1, 2, 3], np.uint64)
    assert ref.edges_differ(a, [1, 1, 1], a, [1, 1, 1]) == 0
    assert ref.edges_differ(a, [1, 1, 1], a[:2], [1, 1]) == 1
    assert ref.edges_differ(a, [1, 1, 1], a, [1, 2, 1]) == 1
    assert ref.edges_differ(a, [1, 1, 1], np.array([1, 2, 4], np.uint64),
                            [1, 1, 1]) == 2


def _graph(*paths, k1=22):
    """Sorted canonical edges of the given base paths, multiplicity 3."""
    keys = np.unique(np.concatenate([ref.canonical(p[None, :], k1)[0]
                                     for p in paths]))
    return keys, np.full(len(keys), 3, np.int64)


GENOME = np.random.default_rng(2).integers(0, 4, 400).astype(np.uint8)


def test_contig_edges_and_depths():
    keys, mult = _graph(GENOME)
    contig = GENOME[10:250].copy()
    assert rc.edges_foreign([contig], keys, 22) == 0
    assert rc.depths_differ([contig], ["3.0000"], keys, mult, 22) == 0
    assert rc.depths_differ([contig], ["3.0001"], keys, mult, 22) == 1
    contig[100] = (contig[100] + 1) % 4
    assert rc.edges_foreign([contig], keys, 22) == 22
    assert rc.depths_differ([contig], ["3.0000"], keys, mult, 22) == 1


def test_uncleaned_ends_tip_and_bubble():
    """A contig ending where the path forks into a tip or a bubble
    counts; the whole path, or an end at a fork into two long
    branches, does not."""
    tip = np.concatenate([GENOME[80:201], (GENOME[201:211] + 1) % 4])
    bubble = GENOME[250:330].copy()
    bubble[40] = (bubble[40] + 2) % 4
    keys, _ = _graph(GENOME, tip, bubble)
    ends = rc.uncleaned_ends
    assert ends([GENOME], keys, 22, 44) == 0
    assert ends([GENOME[:201]], keys, 22, 44) == 1   # at the tip
    assert ends([GENOME[:290]], keys, 22, 44) == 1   # at the bubble
    assert ends([GENOME[:150]], keys, 22, 44) == 0   # mid-path
    # two long branches: a fork, not a tip
    other = np.concatenate([GENOME[80:201],
                            np.random.default_rng(3).integers(
                                0, 4, 100).astype(np.uint8)])
    keys2, _ = _graph(GENOME, other)
    assert ends([GENOME[:201]], keys2, 22, 44) == 0


def test_control_is_not_correct():
    """The control (the reference with the configuration's control
    settings in the program's place) differs from the reference; the
    reference against itself does not."""
    import harness

    config = harness.load_json(f"{harness.HERE}/configs/megahit-default.json")
    limit = harness.load_json(f"{harness.HERE}/traffic/k21.json")[
        "checks"]["graph_edges_differ"]
    s = community.simulate(7, None, **TINY)
    assert check.control_reading(s, config) > limit
    keys, mult, _ = check.reference_graph(s, config)
    assert ref.edges_differ(keys, mult, keys, mult) == 0


def test_words_round_trip():
    rng = np.random.default_rng(0)
    for k1 in (5, 16, 22, 32):
        keys = rng.integers(0, 4 ** k1, 50, dtype=np.uint64)
        w = -(-k1 // 16)
        bits = np.zeros((50, w), np.uint32)
        for i, v in enumerate(keys):
            v = int(v) << (32 * w - 2 * k1)
            for j in range(w):
                bits[i, w - 1 - j] = (v >> (32 * j)) & 0xFFFFFFFF
        assert np.array_equal(judge.words_to_keys(bits, k1), keys)


def test_port_first_graph_on_cpu():
    """megahit_tpu_torch's count and mercy on the CPU give the
    reference's k_min graph (the count route), and its 1-pass build at
    min_count 1 the reference's singletons-included graph."""
    from megahit_tpu_torch.graph.counter import count_canonical_kmers
    from megahit_tpu_torch.graph.mercy import find_mercy_edges
    from megahit_tpu_torch.io.lib import build_lib

    import os
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        s = community.write_sample(d, 11, None, **TINY)
        lib = build_lib([s["path1"]], [s["path2"]], [], [])
    keys, counts, rare = count_canonical_kmers(
        lib.pool, lib.starts, 22, 2, return_rare=True, device="cpu")
    mercy = find_mercy_edges(lib.pool, lib.starts, keys, 22,
                             rare_keys=rare, device="cpu")
    assert len(mercy) > 0
    pk = np.concatenate([judge.words_to_keys(keys, 22),
                         judge.words_to_keys(mercy, 22)])
    pc = np.concatenate([counts, np.ones(len(mercy), np.int32)])
    reads = ref.codes(np.concatenate([s["r1"], s["r2"]]))
    rk, rm, every = ref.first_graph(reads, 22, 2, True)
    assert ref.edges_differ(rk, rm, pk, pc) == 0
    k1, c1, _ = ref.first_graph(reads, 22, 1, False)
    assert np.array_equal(k1, every)
    assert os.path.basename(s["path1"]) == "reads_1.fa"
