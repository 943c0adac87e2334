"""The metagenome preset's route (--presets meta-sensitive: min_count 1,
the 1-pass out-of-core k_min build, no mercy) in the port against the
count route and megahit_tpu, on the CPU.

One 4-genome community from scripts/make_community.py (20 to 60 kbp,
log-uniform 3 to 30x, about 2.5 Mbp of 150 bp pairs) is the input.

- The port's 1-pass count-mode build at min_count 1 must equal the
  port's count_canonical_kmers(min_count=1) + sdbg_from_edges and
  megahit_tpu's build_sdbg_bucketed in every Sdbg array (exact), at
  k1 = 22 (the unit fast path: no multiplicity word is spilled) and
  k1 = 32 (a multiple of 16: the word is spilled), over 3 or more
  rounds, with the host's round sort and the card's (one torch sort)
  run on CPU tensors.
- Both CLIs with --min-count 1 --k-list 21,29 (the preset's first rungs)
  must give byte-identical final.contigs.fa, in one round and under an
  -m that splits the build into 3 or more; the log must show the 1-pass
  build at k=22 and no mercy phase, and options.json must be the
  preset's but for the k list (k_list, auto_k and the k_max derived
  from it).
"""

import json
import pathlib
import re
import subprocess
import sys
from dataclasses import asdict

import numpy as np
import pytest

from megahit_tpu.__main__ import main as jax_main
from megahit_tpu.graph import bucketed as jbk
from megahit_tpu.io.lib import build_lib as jax_build_lib
from megahit_tpu_torch.__main__ import main as torch_main
from megahit_tpu_torch.__main__ import make_parser, options_from_args
from megahit_tpu_torch.graph import bucketed as bk
from megahit_tpu_torch.graph.counter import count_canonical_kmers
from megahit_tpu_torch.graph.sdbg import sdbg_from_edges
from megahit_tpu_torch.io.lib import build_lib

import torch_test_env  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
BUDGET_ROWS = 1 << 20  # about 4M rows at either k1: 4 or 5 rounds


@pytest.fixture(scope="module")
def community(tmp_path_factory):
    d = tmp_path_factory.mktemp("meta_community")
    subprocess.run([sys.executable, str(ROOT / "scripts/make_community.py"),
                    str(d), "--genomes", "4", "--min-bp", "20000",
                    "--max-bp", "60000", "--min-cov", "3", "--max-cov", "30",
                    "--seed", "42"], check=True, capture_output=True,
                   timeout=120)
    return d


@pytest.fixture(scope="module")
def jax_graphs(community, tmp_path_factory):
    """megahit_tpu's 1-pass count-mode graph at k1, built once a k1."""
    lib = jax_build_lib([str(community / "reads_1.fa")],
                        [str(community / "reads_2.fa")], [], [])
    cache = {}

    def get(k1):
        if k1 not in cache:
            cache[k1] = jbk.build_sdbg_bucketed(
                [jbk.PoolSource(lib.pool, lib.starts,
                                np.ones(lib.num_seqs, np.int32))],
                k1, BUDGET_ROWS, str(tmp_path_factory.mktemp("jspill")),
                batch_windows=1 << 20, mult_mode="count", min_count=1)
        return cache[k1]

    return get


def _assert_sdbg_equal(t, j):
    assert (t.k, t.real, t.size) == (j.k, j.real, j.size)
    for name in ("keys", "mult", "valid", "run_start", "nxt_link", "rc"):
        np.testing.assert_array_equal(np.asarray(getattr(t, name)),
                                      np.asarray(getattr(j, name)), name)


@pytest.mark.parametrize("route", ["host_sort", "card_sort"])
@pytest.mark.parametrize("k1", [22, 32])
def test_1pass_min_count_1_matches_count_route(k1, route, community,
                                               jax_graphs, tmp_path,
                                               monkeypatch):
    if route == "card_sort":
        monkeypatch.setattr(bk, "_sort_on_host", lambda device: False)
    units = []
    spill_pool = bk._spill_pool

    def spy(*args, **kwargs):
        units.append(kwargs["unit"])
        return spill_pool(*args, **kwargs)

    monkeypatch.setattr(bk, "_spill_pool", spy)
    lib = build_lib([str(community / "reads_1.fa")],
                    [str(community / "reads_2.fa")], [], [])
    stats = bk.BuildStats()
    got = bk.build_sdbg_bucketed(
        [bk.PoolSource(lib.pool, lib.starts,
                       np.ones(lib.num_seqs, np.int32))],
        k1, BUDGET_ROWS, str(tmp_path / "spill"), batch_windows=1 << 20,
        stats=stats, mult_mode="count", min_count=1, device="cpu")
    assert units == [k1 % 16 != 0]
    assert stats.n_rounds >= 3
    assert stats.max_round_rows <= BUDGET_ROWS

    keys, counts = count_canonical_kmers(lib.pool, lib.starts, k1, 1,
                                         device="cpu")
    # both strands of every window are spilled; each window adds one to
    # its canonical key's count (no count reaches the clip here)
    assert counts.max() < 65535
    assert stats.total_spilled_rows == 2 * int(counts.sum())
    _assert_sdbg_equal(got, sdbg_from_edges(keys, counts, k1, device="cpu"))
    _assert_sdbg_equal(got, jax_graphs(k1))


def _preset_diff(argv, out) -> list[str]:
    """The options.json fields of a run that differ from what the CLI
    makes of the same arguments with --presets meta-sensitive."""
    want = options_from_args(make_parser().parse_args(
        argv + ["--presets", "meta-sensitive"]))
    want.validate()
    got = json.loads((out / "options.json").read_text())
    return sorted(k for k, v in asdict(want).items() if got.get(k) != v)


@pytest.mark.parametrize("extra", [[], ["-m", "50000000"]],
                         ids=["one_round", "rounds"])
def test_meta_first_rungs_byte_identical(extra, community, tmp_path):
    reads = ["-1", str(community / "reads_1.fa"),
             "-2", str(community / "reads_2.fa")] + extra
    args = reads + ["--min-count", "1", "--k-list", "21,29"]
    assert jax_main(args + ["-o", str(tmp_path / "jax")]) == 0
    out = tmp_path / "torch"
    assert torch_main(args + ["--device", "cpu", "-o", str(out)]) == 0
    got = (out / "final.contigs.fa").read_bytes()
    assert got.count(b">")
    assert got == (tmp_path / "jax/final.contigs.fa").read_bytes()
    log = (out / "log").read_text()
    spill = re.search(r"bucketed build k=22: \d+ rows spilled in [0-9.]+s, "
                      r"(\d+) rounds", log)
    assert spill
    assert int(spill.group(1)) >= (3 if extra else 1)
    assert "first_graph.mercy" not in log
    assert "k list: 21,29\n" in log
    assert _preset_diff(reads + ["--device", "cpu", "-o", str(out)],
                        out) == ["auto_k", "k_list", "k_max"]
