"""The port's native host cores (megahit_tpu_torch/native/) are required:
a failed g++ build raises with the compiler's message, a built library
that does not load raises with the loader's, and `checknative` still
reports either as 0 and exits 0."""

import os

import pytest

from megahit_tpu_torch import native, stage_cli

import torch_test_env  # noqa: F401

# core -> (source, library, loaded handle, loader) names
CORES = {
    "fastxpack": ("_SRC", "_SO", "_lib", "get_lib"),
    "graphwalk": ("_GW_SRC", "_GW_SO", "_gw_lib", "get_graphwalk"),
    "seedscan": ("_SS_SRC", "_SS_SO", "_ss_lib", "get_seedscan"),
}


def _broken_source(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("extern \"C\" int broken( {\n")
    return src


def _assert_reported_missing(core, capsys):
    """native_status reports only `core` missing; checknative prints 0
    and exits 0."""
    status = native.native_status()
    assert status[core] is False
    assert all(ok for name, ok in status.items() if name != core)
    assert stage_cli.main(["checknative"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == "0"


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
    src, so, handle, loader = CORES[core]
    monkeypatch.setattr(native, src, str(_broken_source(tmp_path)))
    monkeypatch.setattr(native, so, str(tmp_path / f"lib{core}.so"))
    monkeypatch.setattr(native, handle, None)
    for _ in range(2):
        with pytest.raises(native.NativeBuildError, match=core):
            getattr(native, loader)()
    _assert_reported_missing(core, capsys)


@pytest.mark.parametrize("core", list(CORES))
def test_core_load_failure_is_loud(core, tmp_path, monkeypatch, capsys):
    """A library file that is up to date but is not a library: the
    loader raises NativeBuildError naming the core and quoting the
    loader's error on every call (no None for the callers to work
    around), native_status reports False, and checknative prints 0 and
    exits 0."""
    src, so, handle, loader = CORES[core]
    lib = tmp_path / f"lib{core}.so"
    lib.write_text("not a shared library\n")
    mtime = os.path.getmtime(getattr(native, src)) + 10
    os.utime(lib, (mtime, mtime))
    monkeypatch.setattr(native, so, str(lib))
    monkeypatch.setattr(native, handle, None)
    for _ in range(2):
        with pytest.raises(native.NativeBuildError,
                           match=f"native {core}: .* does not load"):
            getattr(native, loader)()
    assert getattr(native, handle) is None
    assert lib.read_text() == "not a shared library\n"  # not rebuilt
    _assert_reported_missing(core, capsys)
