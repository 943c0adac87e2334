"""Reducing a device trace: busy time as the union of device intervals,
idle gaps labelled by the innermost span, and the launch recorder."""

import torch

import devtrace


def test_union_and_gaps():
    ev = [("k1", 10, 20), ("k2", 15, 30), ("m", 50, 60), ("x", 95, 120)]
    spans = [("stage_local", 0, 100), ("first_graph.mercy", 30, 50)]
    r = devtrace.reduce_events(ev, 0, 100, spans)
    assert r["busy_s"] == (20 + 10 + 5) / 1e9
    assert r["window_s"] == 100 / 1e9
    gaps = dict((round(g * 1e9), lab) for lab, g in r["idle_gaps"])
    assert gaps == {20: "first_graph.mercy", 35: "stage_local",
                    10: "stage_local"}
    assert r["device_ops"][0][0] == "x"
    assert devtrace.label([], 5) == "harness"


def test_launch_recorder_restores_the_wrappers():
    from megahit_tpu_torch.core import kernels

    orig = kernels.canonical_all_kmers
    before = orig.launches
    with devtrace.LaunchRecorder(kernels) as rec:
        assert kernels.canonical_all_kmers is not orig
        kernels.canonical_all_kmers(torch.zeros(100, dtype=torch.int32), 22)
        kernels.count_sorted_runs([torch.zeros(10, dtype=torch.int32)], 0)
    assert kernels.canonical_all_kmers is orig
    assert rec.calls["canonical_all_kmers"] == [(100, 22)]
    assert rec.calls["count_sorted_runs"] == [(10, 4)]
    # the CPU path launches nothing
    assert rec.launches == {"canonical_all_kmers": 0,
                            "count_sorted_runs": 0}
    assert orig.launches == before
