"""MEGAHIT's --kmin-1pass route in the port (the out-of-core k_min build
and mercy's dense scan) against the benchmark's plain NumPy reference,
on the CPU.

A 3-genome community from the benchmark's generator
(`benchmark/traffic/community.py`: 20 to 30 kbp, 6 to 14x, 2x150 bp
pairs) runs through `Pipeline` with `--kmin-1pass --k-list 21` at
min_count 2 (mercy on), under the default -m (one round) and under an
-m that splits the build into 3 or more rounds, with the host's round
sort and with the card's (one torch sort) run on CPU tensors. The job's
`k21.edges.npz` must equal `first_graph(reads, 22, 2, True)` of
`benchmark/reference/first_graph.py` exactly, mercy edges included, and
the edge file of the same job without --kmin-1pass (the count route).
"""

import importlib.util
import pathlib

import numpy as np
import pytest

import torch_test_env  # noqa: F401
from megahit_tpu_torch.__main__ import make_parser, options_from_args
from megahit_tpu_torch.graph import bucketed as bk
from megahit_tpu_torch.pipeline.driver import Pipeline

ROOT = pathlib.Path(__file__).resolve().parents[1]
K1 = 22
SAMPLE = dict(genomes=3, min_bp=20000, max_bp=30000, min_cov=6.0,
              max_cov=14.0)
ROUNDS_MEMORY = "10000000"  # 277,777 rows a round at k1 = 22


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load("kmin1pass_reference", "benchmark/reference/first_graph.py")
community = _load("kmin1pass_community", "benchmark/traffic/community.py")


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    d = tmp_path_factory.mktemp("kmin1pass_sample")
    return community.write_sample(str(d), 1701, **SAMPLE)


@pytest.fixture(scope="module")
def reference(sample):
    """The reference's first graph at min_count 2, with and without the
    mercy edges: {mercy: (keys, multiplicities)}."""
    reads = ref.codes(np.concatenate([sample["r1"], sample["r2"]]))
    return {m: ref.first_graph(reads, K1, 2, m)[:2] for m in (True, False)}


def _job(sample, out, flags):
    """One `Pipeline.run()` as the CLI would run it: (edge keys as
    uint64, counts, the number of 1-pass rounds)."""
    opt = options_from_args(make_parser().parse_args(
        ["-1", sample["path1"], "-2", sample["path2"], "--k-list", "21",
         "--min-count", "2", "--device", "cpu", "-t", "2",
         "--keep-tmp-files", "-o", str(out)] + flags))
    opt.validate()
    out.mkdir()
    spans = Pipeline(opt).run()
    rounds = sum(r.name == "first_graph.1pass_build.round"
                 for r in spans.records)
    with np.load(out / "tmp" / "k21" / "k21.edges.npz") as z:
        words, counts = z["keys"].astype(np.uint64), z["counts"]
    # two words, the first base highest: 16 bases, then 6 in the top
    # bits of the second word
    keys = (words[:, 0] << np.uint64(12)) | (words[:, 1] >> np.uint64(20))
    return keys, counts.astype(np.int64), rounds


@pytest.fixture(scope="module")
def count_route(sample, tmp_path_factory):
    return _job(sample, tmp_path_factory.mktemp("count") / "out", [])


@pytest.mark.parametrize("sort", ["host_sort", "card_sort"])
@pytest.mark.parametrize("memory", [None, ROUNDS_MEMORY],
                         ids=["one_round", "rounds"])
def test_kmin_1pass_equals_reference(memory, sort, sample, reference,
                                     count_route, tmp_path, monkeypatch):
    if sort == "card_sort":
        monkeypatch.setattr(bk, "_sort_on_host", lambda device: False)
    flags = ["--kmin-1pass"] + (["-m", memory] if memory else [])
    keys, counts, rounds = _job(sample, tmp_path / "out", flags)
    if memory is None:
        assert rounds == 1
    else:
        assert rounds >= 3
    assert ref.edges_differ(keys, counts, *reference[True]) == 0
    # the mercy edges are in it: without them the graph differs
    assert ref.edges_differ(keys, counts, *reference[False]) > 0
    ck, cc, crounds = count_route
    assert crounds == 0
    order, corder = np.argsort(keys), np.argsort(ck)
    np.testing.assert_array_equal(keys[order], ck[corder])
    np.testing.assert_array_equal(counts[order], cc[corder])
