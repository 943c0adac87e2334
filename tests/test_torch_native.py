"""The port's native host cores (megahit_tpu_torch/native/): a failed g++
build raises with the compiler's message instead of falling back to the
Python paths, and `checknative` still reports it as 0 and exits 0."""

import pytest

from megahit_tpu_torch import native, stage_cli

import torch_test_env  # noqa: F401

# core -> (source, library, loaded handle, tried flag, loader) names
CORES = {
    "fastxpack": ("_SRC", "_SO", "_lib", "_tried", "get_lib"),
    "graphwalk": ("_GW_SRC", "_GW_SO", "_gw_lib", "_gw_tried",
                  "get_graphwalk"),
    "seedscan": ("_SS_SRC", "_SS_SO", "_ss_lib", "_ss_tried",
                 "get_seedscan"),
}


def _broken_source(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("extern \"C\" int broken( {\n")
    return src


def test_failed_build_raises_with_compiler_message(tmp_path):
    so = tmp_path / "libbroken.so"
    with pytest.raises(native.NativeBuildError) as e:
        native._build_so(str(_broken_source(tmp_path)), str(so),
                         what="broken")
    assert "native build of broken failed" in str(e.value)
    assert "error" in str(e.value)
    assert not list(tmp_path.glob("libbroken.so*"))


@pytest.mark.parametrize("core", list(CORES))
def test_core_build_failure_is_loud(core, tmp_path, monkeypatch, capsys):
    """The core's loader raises on every call (no silent fallback after
    the first failure), native_status reports False, and checknative
    prints 0 and exits 0."""
    src, so, handle, tried, loader = CORES[core]
    monkeypatch.setattr(native, src, str(_broken_source(tmp_path)))
    monkeypatch.setattr(native, so, str(tmp_path / f"lib{core}.so"))
    monkeypatch.setattr(native, handle, None)
    monkeypatch.setattr(native, tried, False)
    for _ in range(2):
        with pytest.raises(native.NativeBuildError, match=core):
            getattr(native, loader)()
    status = native.native_status()
    assert status[core] is False
    assert all(ok for name, ok in status.items() if name != core)
    assert stage_cli.main(["checknative"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == "0"
