"""The port's count kernels (megahit_tpu_torch.core.kernels).

On the CPU the wrappers take the plain PyTorch versions, which are held
here to megahit_tpu's Pallas kernels (interpret mode) and jnp
references with exact equality. The CUDA kernels themselves are held to
the plain versions by tests/test_torch_kernels_gpu.py (marked `gpu`,
skipped without a card) and by chip_smoke.py on the card."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megahit_tpu.core import kmerops as jk
from megahit_tpu.core import pallas_kernels as pk
from megahit_tpu_torch.core import kernels as tkern
from megahit_tpu_torch.core import kmerops as tk

import torch_test_env  # noqa: F401


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(
        np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("k", [15, 22, 31, 42])
def test_canonical_plain_matches_pallas(k):
    rng = np.random.default_rng(99 + k)
    packed = rng.integers(0, 2 ** 32, 4096 + 3, dtype=np.uint32)
    ref = np.asarray(pk.canonical_all_kmers_reference(
        jnp.asarray(packed), k))
    pal = np.asarray(pk.canonical_all_kmers_pallas(
        jnp.asarray(packed), k, interpret=True))
    got = _u32(tkern.canonical_all_kmers(_i32(packed), k))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pal)
    assert tkern.q_padded(len(packed), k) * 16 == got.shape[1]


@pytest.mark.parametrize("k", [56, 64, 255])
def test_canonical_plain_wide_keys(k):
    """Any k up to 255 (W up to 16) and a pool that is not a multiple
    of the 2048-start block."""
    rng = np.random.default_rng(k)
    packed = rng.integers(0, 2 ** 32, 2100, dtype=np.uint32)
    ref = np.asarray(pk.canonical_all_kmers_reference(
        jnp.asarray(packed), k))
    got = _u32(tkern.canonical_all_kmers_plain(_i32(packed), k))
    np.testing.assert_array_equal(got, ref)


def test_phase_grouped_mask_matches():
    rng = np.random.default_rng(3)
    n = 5 * 2048 * 16 + 7 * 16
    mask = rng.random(n) < 0.3
    np.testing.assert_array_equal(tkern.phase_grouped_mask(mask),
                                  pk.phase_grouped_mask(mask))
    vals = np.arange(n, dtype=np.int64)
    np.testing.assert_array_equal(tkern.phase_grouped_mask(vals),
                                  pk.phase_grouped_mask(vals))


@pytest.mark.parametrize("k", [22, 24, 31, 42, 56])
def test_narrow_widen_tail_plane(k):
    rng = np.random.default_rng(k)
    w = jk.words_per_kmer(k)
    keys = np.asarray(jk.mask_tail(
        rng.integers(0, 2 ** 32, (256, w), dtype=np.uint32), k))
    jcols = tuple(jnp.asarray(keys[:, i]) for i in range(w))
    tcols = tuple(tk.to_torch(keys[:, i], "cpu") for i in range(w))
    jn = pk.narrow_tail_plane(jcols, k)
    tn = tkern.narrow_tail_plane(tcols, k)
    narrowed = jn[-1].dtype == jnp.uint16
    assert narrowed == (tn[-1].dtype == torch.int16)
    if narrowed:
        np.testing.assert_array_equal(
            tn[-1].numpy().view(np.uint16), np.asarray(jn[-1]))
    for a, b in zip(tkern.widen_tail_plane(tn), pk.widen_tail_plane(jn)):
        np.testing.assert_array_equal(tk.to_numpy(a), np.asarray(b))


def _runs_case(rng, n, dup, ninv):
    hi = np.sort(rng.integers(0, dup, n)).astype(np.uint32)
    lo = rng.integers(0, 2 ** 16, n).astype(np.uint16)
    valid = np.ones(n, bool)
    if ninv:
        hi[-ninv:] = 0xFFFFFFFF
        lo[-ninv:] = 0xFFFF
        valid[-ninv:] = False
    order = np.lexsort((lo, hi))
    return hi[order], lo[order], valid[order]


@pytest.mark.parametrize("n,dup,ninv", [
    (32768, 1, 0), (98304, 40, 333), (65536, 65536, 9), (32768, 3, 1),
])
def test_count_plain_matches_pallas(n, dup, ninv):
    hi, lo, valid = _runs_case(np.random.default_rng(n + dup), n, dup,
                               ninv)
    h0, c0 = pk.count_sorted_runs_pallas(
        (jnp.asarray(hi), jnp.asarray(lo)), jnp.int32(ninv),
        interpret=True)
    h1, c1 = tkern.count_sorted_runs(
        (_i32(hi), _i32(lo.astype(np.uint32))), ninv)
    np.testing.assert_array_equal(h1.numpy(), np.asarray(h0))
    np.testing.assert_array_equal(c1.numpy(), np.asarray(c0))


@pytest.mark.parametrize("n,dup,ninv", [
    (1, 1, 0), (1000, 1000, 7), (40_001, 30, 333), (70_007, 70_007, 1),
    (33_000, 5, 33_000 - 1),
])
def test_count_plain_any_n(n, dup, ninv):
    """n not a multiple of 32768, sentinel tails, one run spanning the
    whole array, a pool that is nearly all sentinels."""
    hi, lo, valid = _runs_case(np.random.default_rng(n), n, dup, ninv)
    h0, c0 = jk.count_sorted_runs_soa(
        (jnp.asarray(hi), jnp.asarray(lo)), jnp.asarray(valid))
    h1, c1 = tkern.count_sorted_runs((_i32(hi), _i32(lo)), ninv)
    np.testing.assert_array_equal(h1.numpy(), np.asarray(h0))
    np.testing.assert_array_equal(c1.numpy(), np.asarray(c0))


def test_wrappers_check_operands():
    with pytest.raises(TypeError):
        tkern.canonical_all_kmers(torch.zeros(100, dtype=torch.int64), 21)
    with pytest.raises(ValueError):
        tkern.canonical_all_kmers(torch.zeros((10, 10), dtype=torch.int32),
                                  21)
    with pytest.raises(ValueError):
        tkern.canonical_all_kmers(torch.zeros(100, dtype=torch.int32), 256)
    with pytest.raises(ValueError):
        tkern.count_sorted_runs(
            (torch.zeros(10, dtype=torch.int32),
             torch.zeros(11, dtype=torch.int32)), 0)
    with pytest.raises(ValueError):
        tkern.count_sorted_runs((torch.zeros(0, dtype=torch.int32),), 0)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrappers compute the plain version and launch
    nothing: the launch counters stay put."""
    before = (tkern.canonical_all_kmers.launches,
              tkern.count_sorted_runs.launches)
    rng = np.random.default_rng(5)
    packed = rng.integers(0, 2 ** 32, 300, dtype=np.uint32)
    got = tkern.canonical_all_kmers(_i32(packed), 22)
    want = tkern.canonical_all_kmers_plain(_i32(packed), 22)
    assert torch.equal(got, want)
    tkern.count_sorted_runs((got[0],), 0)
    assert (tkern.canonical_all_kmers.launches,
            tkern.count_sorted_runs.launches) == before


_CUDA_SOURCES = sorted(f[:-3] for f in os.listdir(tkern._CSRC)
                       if f.endswith(".cu"))


def _includes(path: str) -> set:
    with open(path) as fh:
        return set(re.findall(r'^\s*#include\s+"([^"]+)"', fh.read(), re.M))


@pytest.mark.parametrize("name", _CUDA_SOURCES)
def test_build_cache_sees_every_include(name):
    """Every csrc/*.cu is built (SOURCES), and HEADERS lists exactly the
    headers it includes, directly or through another header, so that an
    edit to one rebuilds it."""
    assert name in tkern.SOURCES
    want, todo = set(), [f"{name}.cu"]
    while todo:
        for h in _includes(os.path.join(tkern._CSRC, todo.pop())) - want:
            assert os.path.exists(os.path.join(tkern._CSRC, h)), h
            want.add(h)
            todo.append(h)
    assert set(tkern.HEADERS.get(name, ())) == want


def test_header_edit_rebuilds_its_sources(tmp_path, monkeypatch):
    """A library older than its source or a header it includes is
    stale; the others are not."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    headers = {h for hs in tkern.HEADERS.values() for h in hs}
    for f in [f"{n}.cu" for n in tkern.SOURCES] + sorted(headers):
        (csrc / f).write_text("")
        os.utime(csrc / f, (100, 100))
    monkeypatch.setattr(tkern, "_CSRC", str(csrc))
    monkeypatch.setattr(tkern, "BUILD_DIR", str(build))
    assert all(tkern._stale(n) for n in tkern.SOURCES)  # nothing built
    for n in tkern.SOURCES:
        (build / f"lib{n}.so").write_text("")
        os.utime(build / f"lib{n}.so", (200, 200))
    assert not any(tkern._stale(n) for n in tkern.SOURCES)
    os.utime(csrc / "merge_common.cuh", (300, 300))
    assert [n for n in tkern.SOURCES if tkern._stale(n)] == [
        "merge_pairs", "merge_path"]
    os.utime(csrc / "count_runs.cu", (300, 300))
    assert [n for n in tkern.SOURCES if tkern._stale(n)] == [
        "count_runs", "merge_pairs", "merge_path"]
