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
