"""The frozen sample generator against scripts/make_community.py."""

import os
import subprocess
import sys

import numpy as np
import pytest

import harness
from traffic import community

SCRIPT = os.path.join(harness.ROOT, "scripts", "make_community.py")


@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_json(
    os.path.join(harness.ROOT, "BENCHMARK.json"))["workloads"]])
def test_byte_identical_to_make_community(cell, tmp_path):
    c = harness.load_cell(cell)
    args = harness.sample_args(c.config, c.traffic)
    assert args.pop("shape_seed") == 42
    subprocess.run(
        [sys.executable, SCRIPT, str(tmp_path / "script"), "--seed", "42"]
        + [f"--{k.replace('_', '-')}={v}" for k, v in args.items()],
        check=True, cwd=os.path.dirname(SCRIPT), capture_output=True)
    s = community.write_sample(str(tmp_path / "frozen"), 42, 42, **args)
    for name in ("reads_1.fa", "reads_2.fa"):
        a = (tmp_path / "script" / name).read_bytes()
        b = (tmp_path / "frozen" / name).read_bytes()
        assert a == b
    assert s["path1"].endswith("reads_1.fa")


def test_same_seed_same_sample_and_same_sizes_across_seeds():
    args = dict(genomes=6, min_bp=2000, max_bp=4000, mobile_share=0.2)
    a = community.simulate(2 ** 31 + 17, 42, **args)
    b = community.simulate(2 ** 31 + 17, 42, **args)
    c = community.simulate(5, 42, **args)
    for key in ("r1", "r2"):
        assert np.array_equal(a[key], b[key])
        assert a[key].shape == c[key].shape
        assert not np.array_equal(a[key], c[key])

    def shapes(s):
        return sorted((len(g), cov, i in s["carriers"])
                      for i, (g, cov) in enumerate(zip(s["genomes"],
                                                       s["covs"])))

    assert shapes(a) == shapes(c)
    assert len(a["carriers"]) == 1


def test_unknown_argument_raises():
    with pytest.raises(ValueError):
        community.simulate(1, genome=3)
