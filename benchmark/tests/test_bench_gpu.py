"""On the card: one whole run of a cell through run.py, traced, comes
out correct with every per-layer metric the cell lists. Skips where
there is no card (decided inside the test)."""

import json
import os
import subprocess
import sys

import pytest

import harness


@pytest.mark.gpu
def test_traced_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "default.k21",
         "--seed", str(2 ** 31 + 99), "--seconds", "1", "--trace", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    cell = harness.load_cell("default.k21")
    assert set(r["metrics"]) == {m["name"] for m in cell.per_layer}
    assert 0 < r["device"]["busy_s"] < r["device"]["window_s"]
    assert 0 < r["metrics"]["k1_roofline_pct"]["value"] <= 105
    assert 0 < r["metrics"]["k2_roofline_pct"]["value"] <= 105
