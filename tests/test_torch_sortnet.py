"""The port's merge sort of the (u32, u16) key planes against
megahit_tpu's Pallas version (core/sortnet.py), on the CPU.

The same seeded numpy keys go through both packages: megahit_tpu's
kernels in Pallas interpret mode, the port's plain versions (which its
wrappers take for CPU tensors). Exact equality throughout; the CUDA
kernels themselves are held to the plain versions on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from megahit_tpu.core import sortnet as jsort
from megahit_tpu_torch.core import sortnet as tsort

import torch_test_env  # noqa: F401


def mk(rng, n, dup=False):
    """tests/test_sortnet.py::mk: real keys keep the low 4 bits of lo
    zero; dup=True is the duplicate-heavy case."""
    hi = rng.integers(0, 2**32, n, dtype=np.uint32)
    lo = (rng.integers(0, 2**12, n, dtype=np.uint32) << 4).astype(np.uint16)
    if dup:
        hi = (hi % 7).astype(np.uint32)
        lo = ((lo.astype(np.uint32) % 3) << 4).astype(np.uint16)
    return hi, lo


def key64(hi, lo):
    return (np.asarray(hi).astype(np.uint32).astype(np.uint64)
            << np.uint64(16)) | np.asarray(lo).astype(np.uint16)


def planes(hi, lo):
    return (torch.from_numpy(hi.view(np.int32).copy()),
            torch.from_numpy(lo.view(np.int16).copy()))


def as_u(th, tl):
    return th.numpy().view(np.uint32), tl.numpy().view(np.uint16)


def sorted_runs(rng, n, run, dup):
    hi, lo = mk(rng, n, dup)
    k = np.sort(key64(hi, lo).reshape(-1, run), axis=1).reshape(-1)
    return ((k >> np.uint64(16)).astype(np.uint32),
            (k & np.uint64(0xFFFF)).astype(np.uint16))


@pytest.mark.parametrize("dup", [False, True])
def test_sort_planes_matches_jax(dup):
    hi, lo = mk(np.random.default_rng(7), 8192, dup)
    jh, jl = jsort.sort_planes(jnp.asarray(hi), jnp.asarray(lo),
                               init_run=512, max_tile=1024, interpret=True)
    th, tl = tsort.sort_planes(*planes(hi, lo), init_run=512,
                               max_tile=1024)
    got_h, got_l = as_u(th, tl)
    np.testing.assert_array_equal(got_h, np.asarray(jh))
    np.testing.assert_array_equal(got_l, np.asarray(jl))
    np.testing.assert_array_equal(key64(got_h, got_l),
                                  np.sort(key64(hi, lo)))


@pytest.mark.parametrize("dup", [False, True])
def test_aligned_level_matches_jax(dup):
    n, run = 4096, 512
    hi, lo = sorted_runs(np.random.default_rng(11), n, run, dup)
    jh, jl = jsort._merge_level_aligned(jnp.asarray(hi), jnp.asarray(lo),
                                        run, interpret=True)
    th, tl = tsort.merge_pairs(*planes(hi, lo), run)
    got_h, got_l = as_u(th, tl)
    np.testing.assert_array_equal(got_h, np.asarray(jh))
    np.testing.assert_array_equal(got_l, np.asarray(jl))


@pytest.mark.parametrize("dup", [False, True])
def test_path_level_matches_jax(dup):
    n, run, tile = 4096, 1024, 512
    hi, lo = sorted_runs(np.random.default_rng(13), n, run, dup)
    jh, jl = jsort._merge_level_path(jnp.asarray(hi), jnp.asarray(lo), run,
                                     tile, interpret=True)
    th, tl = tsort.merge_path_level(*planes(hi, lo), run, tile)
    got_h, got_l = as_u(th, tl)
    np.testing.assert_array_equal(got_h, np.asarray(jh))
    np.testing.assert_array_equal(got_l, np.asarray(jl))


@pytest.mark.parametrize("dup", [False, True])
def test_merge_path_splits_match_jax(dup):
    n, run, tile = 4096, 1024, 256
    hi, lo = sorted_runs(np.random.default_rng(17), n, run, dup)
    want = jsort._merge_path_splits(jnp.asarray(hi), jnp.asarray(lo), run,
                                    tile, n)
    # megahit_tpu also returns each tile's pair start and offset in it
    a_from, a_to = tsort.merge_path_splits(*planes(hi, lo), run, tile)
    np.testing.assert_array_equal(a_from.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(a_to.numpy(), np.asarray(want[1]))


def test_merge_levels_follow_jax_dispatch():
    # megahit_tpu's sort_planes: the aligned kernel while 2 * run fits
    # max_tile, the path kernel after; none below 2 * init_run or off a
    # power of two
    levels = tsort.merge_levels(8192, init_run=512, max_tile=1024)
    assert [(run, m.func.__name__) for run, m in levels] == [
        (512, "merge_pairs"), (1024, "merge_path_level"),
        (2048, "merge_path_level"), (4096, "merge_path_level")]
    assert tsort.merge_levels(1023, 256, 1024) == []
    assert tsort.merge_levels(1024, 512, 1024) != []
    assert tsort.merge_levels(1024, 1024, 1024) == []


def test_sort_planes_fallback_non_pow2():
    hi, lo = mk(np.random.default_rng(19), 1000)
    jh, jl = jsort.sort_planes(jnp.asarray(hi), jnp.asarray(lo))
    got_h, got_l = as_u(*tsort.sort_planes(*planes(hi, lo)))
    np.testing.assert_array_equal(got_h, np.asarray(jh))
    np.testing.assert_array_equal(got_l, np.asarray(jl))


def test_wrappers_check_operands():
    hi, lo = planes(*mk(np.random.default_rng(23), 1024))
    with pytest.raises(TypeError):
        tsort.merge_pairs(hi.long(), lo, 256)
    with pytest.raises(ValueError):
        tsort.merge_pairs(hi, lo, 300)
    with pytest.raises(ValueError):
        tsort.merge_path_level(hi, lo, 256, 512)
    with pytest.raises(ValueError):
        tsort.merge_path_splits(hi, lo, 256, 384)
    before = (tsort.merge_pairs.launches, tsort.merge_path_level.launches)
    tsort.sort_planes(hi, lo, init_run=128, max_tile=256)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (tsort.merge_pairs.launches,
            tsort.merge_path_level.launches) == before
