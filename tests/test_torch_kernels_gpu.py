"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test is marked `gpu` and skips without a CUDA device.

This file imports neither JAX nor megahit_tpu, so it also runs on a
machine that has only PyTorch; there, skip the JAX test setup in
tests/conftest.py:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from megahit_tpu_torch.core import kernels as tkern

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(
        np.int32))


def _sorted_cols(rng, n, dup, ninv):
    """(hi, lo) columns sorted lexicographically, the last ninv rows
    all-ones sentinels."""
    hi = np.sort(rng.integers(0, dup, n)).astype(np.uint32)
    lo = rng.integers(0, 2 ** 16, n).astype(np.uint32)
    if ninv:
        hi[-ninv:] = 0xFFFFFFFF
        lo[-ninv:] = 0xFFFFFFFF
    order = np.lexsort((lo, hi))
    return hi[order], lo[order]


@pytest.mark.parametrize("k", [15, 22, 32, 42, 56, 255])
def test_canonical_kernel_matches_plain(k):
    rng = np.random.default_rng(k)
    packed = _i32(rng.integers(0, 2 ** 32, (1 << 16) + 37,
                               dtype=np.uint32)).cuda()
    before = tkern.canonical_all_kmers.launches
    got = tkern.canonical_all_kmers(packed, k)
    assert tkern.canonical_all_kmers.launches == before + 1
    assert torch.equal(got, tkern.canonical_all_kmers_plain(packed, k))


@pytest.mark.parametrize("n,dup,ninv,w", [
    (1, 1, 0, 1), (1_000_003, 40, 333, 2), (3_000_017, 3_000_017, 9, 1),
    (98_305, 3, 1, 3), (33_000, 5, 32_999, 2),
])
def test_count_kernel_matches_plain(n, dup, ninv, w):
    hi, lo = _sorted_cols(np.random.default_rng(n), n, dup, ninv)
    cols = [_i32(hi), _i32(lo)] + [_i32(lo)] * (w - 2)
    cols = tuple(c.cuda() for c in cols[:w])
    before = tkern.count_sorted_runs.launches
    h1, c1 = tkern.count_sorted_runs(cols, ninv)
    assert tkern.count_sorted_runs.launches == before + 1
    h0, c0 = tkern.count_sorted_runs_plain(cols, ninv)
    assert torch.equal(h1, h0) and torch.equal(c1, c0)


def test_wrappers_refuse_bad_cuda_operands():
    with pytest.raises(TypeError):
        tkern.count_sorted_runs(
            (torch.zeros(10, dtype=torch.int64, device="cuda"),), 0)
    with pytest.raises(ValueError):
        tkern.canonical_all_kmers(
            torch.zeros(64, dtype=torch.int32, device="cuda")[::2], 21)


def _sorted_runs(rng, n, run, dup):
    """48-bit (hi int32, lo int16) planes on the card, sorted in runs of
    `run` keys; dup=True is the duplicate-heavy case."""
    from megahit_tpu_torch.core import sortnet

    hi = rng.integers(0, 7 if dup else 2 ** 32, n).astype(np.uint32)
    lo = (rng.integers(0, 3 if dup else 2 ** 12, n) << 4).astype(np.uint16)
    key = (hi.astype(np.int64) << 16) | lo
    key = np.sort(key.reshape(-1, run), axis=1).reshape(-1)
    return sortnet.unpack_key(torch.from_numpy(key).cuda())


@pytest.mark.parametrize("n,run,dup", [(1 << 20, 2048, False),
                                       (1 << 20, 4096, True),
                                       (8192, 512, False)])
def test_merge_pairs_kernel_matches_plain(n, run, dup):
    from megahit_tpu_torch.core import sortnet

    hi, lo = _sorted_runs(np.random.default_rng(run), n, run, dup)
    before = sortnet.merge_pairs.launches
    gh, gl = sortnet.merge_pairs(hi, lo, run)
    assert sortnet.merge_pairs.launches == before + 1
    ph, pl = sortnet.merge_pairs_plain(hi, lo, run)
    assert torch.equal(gh, ph) and torch.equal(gl, pl)


@pytest.mark.parametrize("n,run,tile,dup", [(1 << 20, 1 << 16, 8192, False),
                                            (1 << 20, 1 << 19, 8192, True),
                                            (8192, 1024, 1024, False)])
def test_merge_path_kernel_matches_plain(n, run, tile, dup):
    from megahit_tpu_torch.core import sortnet

    hi, lo = _sorted_runs(np.random.default_rng(run + 1), n, run, dup)
    before = sortnet.merge_path_level.launches
    gh, gl = sortnet.merge_path_level(hi, lo, run, tile)
    assert sortnet.merge_path_level.launches == before + 1
    ph, pl = sortnet.merge_pairs_plain(hi, lo, run)
    assert torch.equal(gh, ph) and torch.equal(gl, pl)


@pytest.mark.parametrize("n,run,tile,dup", [(1 << 20, 1 << 16, 8192, False),
                                            (1 << 20, 1 << 19, 8192, True),
                                            (8192, 1024, 256, True)])
def test_merge_path_splits_kernel_matches_plain(n, run, tile, dup):
    from megahit_tpu_torch.core import sortnet

    hi, lo = _sorted_runs(np.random.default_rng(run + 2), n, run, dup)
    got = sortnet.merge_path_splits(hi, lo, run, tile)
    want = sortnet.merge_path_splits_plain(hi, lo, run, tile)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
