"""The port's CLI against megahit_tpu's on a small metagenome community,
on the CPU.

One community from scripts/make_community.py (4 genomes of 20 to 60 kbp,
log-uniform 3 to 30x, 151,909 bp of genome, about 2 Mbp of 150 bp pairs,
a shared 1 kbp mobile element) goes through both packages' CLIs, and
final.contigs.fa must be byte-identical (exact: no tolerance) in four
routes: the count's chunked branch (k1 = 42 > 32 on the CPU, with kernel
1's plain version over 2 chunks under -m 100000000), the default preset
(host u64 count, mercy, ladder, local assembly), the 1-pass route of
--presets meta-sensitive (its own 13 rungs, pruned only by the read
length), and the 1-pass route at the default min_count 2 over many
rounds, with mercy over its graph (megahit_tpu's flags for its 100-genome
run, --k-list 21,41,61 --kmin-1pass)."""

import pathlib
import re
import subprocess
import sys

import pytest

from megahit_tpu.__main__ import main as jax_main
from megahit_tpu_torch.__main__ import main as torch_main

import torch_test_env  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]

CASES = {
    "chunked": ["--k-list", "41,61", "-m", "100000000"],
    "default": ["--k-list", "21,41"],
    # the preset overrides an explicit --k-list (as MEGAHIT's does): it
    # runs its own 13 rungs, which the log must show
    "meta_sensitive": ["--presets", "meta-sensitive"],
    # megahit_tpu's 100-genome flags at the default min_count 2: the
    # 1-pass k=21 build (-m 12000000: 333,333 rows a round, 13 rounds of
    # the 4.2M rows) and then mercy over the 1-pass graph
    "kmin_1pass": ["--k-list", "21,41,61", "--kmin-1pass",
                   "-m", "12000000"],
}


@pytest.fixture(scope="module")
def community(tmp_path_factory):
    d = tmp_path_factory.mktemp("community")
    subprocess.run([sys.executable, str(ROOT / "scripts/make_community.py"),
                    str(d), "--genomes", "4", "--min-bp", "20000",
                    "--max-bp", "60000", "--min-cov", "3", "--max-cov", "30",
                    "--seed", "42"], check=True, capture_output=True,
                   timeout=120)
    return ["-1", str(d / "reads_1.fa"), "-2", str(d / "reads_2.fa")]


@pytest.mark.parametrize("case", list(CASES))
def test_community_byte_identical(case, community, tmp_path):
    args = community + CASES[case]
    assert jax_main(args + ["-o", str(tmp_path / "jax")]) == 0
    assert torch_main(args + ["--device", "cpu",
                              "-o", str(tmp_path / "torch")]) == 0
    got = (tmp_path / "torch/final.contigs.fa").read_bytes()
    assert got.count(b">")
    assert got == (tmp_path / "jax/final.contigs.fa").read_bytes()
    log = (tmp_path / "torch/log").read_text()
    if case == "chunked":
        assert "count (chunked): 2 chunks of " in log
    if case == "kmin_1pass":
        m = re.search(r"bucketed build k=22: \d+ rows spilled in \S+ "
                      r"(\d+) rounds", log)
        assert m and int(m.group(1)) >= 8, m
        assert "phase first_graph.mercy" in log
    if case == "meta_sensitive":
        assert "bucketed build k=22" in log
        assert ("k list: 21,29,39,49,59,69,79,89,99,109,119,129,141\n"
                in log)
