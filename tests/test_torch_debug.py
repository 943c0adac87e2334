"""Debug mode, the link probe and the MEGAHIT_TPU_TORCH_* overrides.

- check_sdbg_invariants passes on the port's graphs (and on
  megahit_tpu's graph of the same input, which must be the same graph)
  and catches a broken rc pairing and broken candidate tables;
- MEGAHIT_TPU_TORCH_DEBUG=1 arms the checks and leaves the fixtures'
  final.contigs.fa byte-identical;
- each override steers what it names: DEVICE_CLEAN, DEVICE_BUILD,
  ROUND_CAP_ROWS, LINK_MS (above 20 ms the cleaning goes to the host
  engine). Tolerance: exact equality."""

import numpy as np
import pytest
import torch

from megahit_tpu.graph.sdbg import build_sdbg as j_build_sdbg
from megahit_tpu.utils.debug import check_sdbg_invariants as j_check
from megahit_tpu_torch.__main__ import main as torch_main
from megahit_tpu_torch.core import packing
from megahit_tpu_torch.graph import assemble_device, bucketed
from megahit_tpu_torch.graph import sdbg as sdbg_mod
from megahit_tpu_torch.graph.counter import count_canonical_kmers
from megahit_tpu_torch.pipeline import driver
from megahit_tpu_torch.utils import debug, devlink

import torch_test_env  # noqa: F401

CUDA = torch.device("cuda")  # a device name only: nothing runs on it

ENV = ("MEGAHIT_TPU_TORCH_DEBUG", "MEGAHIT_TPU_TORCH_DEVICE_CLEAN",
       "MEGAHIT_TPU_TORCH_DEVICE_BUILD", "MEGAHIT_TPU_TORCH_ROUND_CAP_ROWS",
       "MEGAHIT_TPU_TORCH_LINK_MS")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    """No override leaks in from the environment or out of a test, and
    debug mode's finiteness checks are disarmed afterwards."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(debug, "_finite_armed", False)
    monkeypatch.setattr(devlink, "_cached_ms", None)


def _graph(k=22, n=400, seed=7):
    genome = np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8)
    flat, starts = packing.pack_many([genome])
    keys, counts = count_canonical_kmers(flat, starts, k, 1, device="cpu")
    return sdbg_mod.sdbg_from_edges(keys, counts, k, device="cpu"), \
        (flat, starts)


@pytest.mark.parametrize("k", [22, 32, 33])
def test_invariants_pass_on_valid_graph(k):
    g, (flat, starts) = _graph(k)
    debug.check_sdbg_invariants(g)
    # megahit_tpu's graph of the same genome is the same graph, and its
    # own check passes on it
    jg = j_build_sdbg(flat, starts, np.ones(1, np.int32), k)
    j_check(jg)
    np.testing.assert_array_equal(jg.keys[:jg.real], g.keys[:g.real])
    np.testing.assert_array_equal(jg.rc[:jg.real], g.rc[:g.real])


def test_invariants_catch_broken_rc():
    g, _ = _graph()
    g.rc[0], g.rc[1] = g.rc[1], g.rc[0]  # corrupt the pairing
    with pytest.raises(AssertionError, match="rc"):
        debug.check_sdbg_invariants(g)


@pytest.mark.parametrize("table", ["nxt_link", "run_start"])
def test_invariants_catch_broken_candidates(table):
    """The four candidate tables are views of the navigation core
    (run_start, nxt_link): a row pointing at the wrong run breaks its
    candidate set."""
    g, _ = _graph()
    nav = getattr(g, table).copy()
    rows = np.flatnonzero(nav[:g.real] >= 0)
    row = int(rows[0])
    nav[row] = (nav[row] + 7) % g.real  # point elsewhere
    setattr(g, f"_{table}", nav)
    with pytest.raises(AssertionError, match="candidate set"):
        debug.check_sdbg_invariants(g)


def test_check_finite_armed_only_in_debug_mode():
    bad = torch.tensor([1.0, float("nan")])
    assert debug.check_finite("x", bad) is bad  # disarmed: no-op
    debug.enable_debug_checks()
    debug.check_finite("x", torch.tensor([1.0, 2.0]))
    with pytest.raises(AssertionError, match="non-finite values in x"):
        debug.check_finite("x", bad)
    with pytest.raises(AssertionError):
        debug.check_finite("x", torch.tensor([float("inf")]))


FIXTURE_ARGS = ["--test", "--device", "cpu", "--no-local", "--k-list",
                "21,29"]


@pytest.fixture(scope="module")
def plain_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("plain") / "out"
    assert torch_main(FIXTURE_ARGS + ["-o", str(out)]) == 0
    return out


def test_debug_env_runs_pipeline(plain_run, tmp_path, monkeypatch):
    """The fixtures with the invariant checks armed: same contigs."""
    monkeypatch.setenv("MEGAHIT_TPU_TORCH_DEBUG", "1")
    before = debug.CHECKS["sdbg_invariants"]
    out = tmp_path / "out"
    assert torch_main(FIXTURE_ARGS + ["-o", str(out)]) == 0
    assert debug.CHECKS["sdbg_invariants"] > before
    want = (plain_run / "final.contigs.fa").read_bytes()
    assert want.count(b">") > 0
    assert (out / "final.contigs.fa").read_bytes() == want
    assert "cleaning on device" not in (out / "log").read_text()


def test_device_clean_forced_on_cpu(plain_run, tmp_path, monkeypatch):
    """DEVICE_CLEAN=1 runs the device engine on a CPU graph (with the
    finiteness checks of debug mode on its float passes): same
    contigs."""
    monkeypatch.setenv("MEGAHIT_TPU_TORCH_DEVICE_CLEAN", "1")
    monkeypatch.setenv("MEGAHIT_TPU_TORCH_DEBUG", "1")
    before = debug.CHECKS["finite"]
    out = tmp_path / "out"
    assert torch_main(FIXTURE_ARGS + ["-o", str(out)]) == 0
    assert "cleaning on device (cpu)" in (out / "log").read_text()
    assert debug.CHECKS["finite"] > before
    assert (out / "final.contigs.fa").read_bytes() == \
        (plain_run / "final.contigs.fa").read_bytes()


def test_device_clean_routing(monkeypatch):
    assert not assemble_device.use_device_cleaning("cpu")
    assert assemble_device.use_device_cleaning(CUDA)
    monkeypatch.setenv("MEGAHIT_TPU_TORCH_DEVICE_CLEAN", "0")
    assert not assemble_device.use_device_cleaning(CUDA)
    monkeypatch.setenv("MEGAHIT_TPU_TORCH_DEVICE_CLEAN", "1")
    assert assemble_device.use_device_cleaning("cpu")


def test_device_build_routing(tmp_path, monkeypatch):
    """DEVICE_BUILD forces the contig union's route either way: the
    driver's k=29 rung of the fixtures (reached with local assembly on)
    takes the device-resident build on the CPU when it is 1."""
    assert not sdbg_mod.use_device_build("cpu")
    assert sdbg_mod.use_device_build(CUDA)
    monkeypatch.setenv("MEGAHIT_TPU_TORCH_DEVICE_BUILD", "0")
    assert not sdbg_mod.use_device_build(CUDA)
    monkeypatch.setenv("MEGAHIT_TPU_TORCH_DEVICE_BUILD", "1")
    assert sdbg_mod.use_device_build("cpu")
    calls = []
    real = driver.build_sdbg_device_resident

    def spy(*a, **kw):
        calls.append(kw["device"])
        return real(*a, **kw)

    monkeypatch.setattr(driver, "build_sdbg_device_resident", spy)
    out = tmp_path / "out"
    assert torch_main(["--test", "--device", "cpu", "--k-list", "21,29",
                       "-o", str(out)]) == 0
    assert [d.type for d in calls] == ["cpu"]
    assert "stage_assemble 29" in (out / "log").read_text()


def test_round_cap_rows(monkeypatch):
    counts = np.full(bucketed.N_BUCKETS, 1000, np.int64)
    assert bucketed.round_cap_rows() == 1 << 26
    assert len(bucketed.plan_rounds(counts, 1 << 20)) == 1
    monkeypatch.setenv("MEGAHIT_TPU_TORCH_ROUND_CAP_ROWS", "20000")
    rounds = bucketed.plan_rounds(counts, 1 << 20)
    assert len(rounds) == 13 and rounds[0] == (0, 20)
    # the cap never goes below 2^14 rows
    monkeypatch.setenv("MEGAHIT_TPU_TORCH_ROUND_CAP_ROWS", "1")
    assert len(bucketed.plan_rounds(counts, 1 << 20)) == 16


def test_link_probe(monkeypatch):
    """0.0 without a card (and cached); the override pins it; above 20
    ms the latency-bound passes and the cleaning go to the host engine,
    while the CPU is the host engine whatever the link."""
    if not torch.cuda.is_available():
        assert devlink.link_latency_ms() == 0.0
        assert devlink._cached_ms == 0.0
    monkeypatch.setenv("MEGAHIT_TPU_TORCH_LINK_MS", "12.5")
    assert devlink.link_latency_ms() == 12.5
    assert not devlink.latency_bound_link()
    assert assemble_device.use_device_cleaning(CUDA)
    assert not sdbg_mod.host_graph_passes(CUDA)
    monkeypatch.setenv("MEGAHIT_TPU_TORCH_LINK_MS", "50")
    assert devlink.latency_bound_link()
    assert not devlink.latency_bound_link(threshold_ms=60.0)
    assert not assemble_device.use_device_cleaning(CUDA)
    assert sdbg_mod.host_graph_passes(CUDA)
    assert sdbg_mod.host_graph_passes("cpu")
    # the engine override still decides first
    monkeypatch.setenv("MEGAHIT_TPU_TORCH_DEVICE_CLEAN", "1")
    assert assemble_device.use_device_cleaning(CUDA)
