"""Debug mode, the route rule and the MEGAHIT_TPU_TORCH_* variables.

- check_sdbg_invariants passes on the port's graphs (and on
  megahit_tpu's graph of the same input, which must be the same graph)
  and catches a broken rc pairing and broken candidate tables;
- MEGAHIT_TPU_TORCH_DEBUG=1 arms the checks and leaves the fixtures'
  final.contigs.fa byte-identical;
- utils.device.graph_on_card sends a CPU graph to the host engine and
  a CUDA graph to the card's route; patched to True, it runs the card's
  route (device cleaning engine, device-resident union build) on CPU
  tensors with the same contigs;
- MEGAHIT_TPU_TORCH_ROUND_CAP_ROWS caps the out-of-core rounds.
  Tolerance: exact equality."""

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
from megahit_tpu_torch.pipeline import assemble as tasm
from megahit_tpu_torch.utils import debug
from megahit_tpu_torch.utils import device as devices
from megahit_tpu_torch.utils.log import get_logger

import torch_test_env  # noqa: F401

ENV = ("MEGAHIT_TPU_TORCH_DEBUG", "MEGAHIT_TPU_TORCH_ROUND_CAP_ROWS")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    """No variable leaks in from the environment or out of a test, and
    debug mode's finiteness checks are disarmed afterwards."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(debug, "_finite_armed", False)


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
    """The card's route forced on a CPU graph runs the device engine on
    CPU tensors (with the finiteness checks of debug mode on its float
    passes): same contigs."""
    monkeypatch.setattr(devices, "graph_on_card", lambda device: True)
    monkeypatch.setenv("MEGAHIT_TPU_TORCH_DEBUG", "1")
    before = debug.CHECKS["finite"]
    out = tmp_path / "out"
    assert torch_main(FIXTURE_ARGS + ["-o", str(out)]) == 0
    assert "cleaning on device (cpu)" in (out / "log").read_text()
    assert debug.CHECKS["finite"] > before
    assert (out / "final.contigs.fa").read_bytes() == \
        (plain_run / "final.contigs.fa").read_bytes()


@pytest.mark.parametrize("name, on_card", [("cpu", False),
                                            ("cuda", True)])
def test_route_predicate(name, on_card, monkeypatch):
    """A CPU graph takes the host engine, a CUDA graph the card's route,
    and every caller asks the one predicate: with it answering as for
    `name`, assemble's engine choice follows on a CPU graph."""
    assert devices.graph_on_card(name) is on_card
    assert devices.graph_on_card(torch.device(name)) is on_card
    monkeypatch.setattr(devices, "graph_on_card",
                        lambda device: on_card)
    g, _ = _graph()
    eng = tasm._engine(g, tasm.AssembleOptions(), get_logger())
    assert isinstance(eng, assemble_device.DeviceCleaner) is on_card


def test_device_build_routing(tmp_path, monkeypatch):
    """The card's route forced on the CPU takes the contig union through
    the device-resident build: the driver's k=29 rung of the fixtures
    (reached with local assembly on) calls it once, on the CPU."""
    monkeypatch.setattr(devices, "graph_on_card", lambda device: True)
    calls = []
    real = sdbg_mod.build_sdbg_device_resident

    def spy(*a, **kw):
        calls.append(kw["device"])
        return real(*a, **kw)

    monkeypatch.setattr(sdbg_mod, "build_sdbg_device_resident", spy)
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
