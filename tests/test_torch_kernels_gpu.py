"""The port's CUDA kernels against their plain PyTorch versions, and its
device cleaning engine against the host engine, on the card. Every test
is marked `gpu` and skips without a CUDA device.

This file imports neither JAX nor megahit_tpu, so it also runs on a
machine that has only PyTorch; there, skip the JAX test setup in
tests/conftest.py:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from megahit_tpu_torch.core import kernels as tkern

import cleaning_cases

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


def _canonical_case(packed, k):
    """One call of kernel 1 (one launch) against its plain version."""
    before = tkern.canonical_all_kmers.launches
    got = tkern.canonical_all_kmers(packed, k)
    assert tkern.canonical_all_kmers.launches == before + 1
    assert torch.equal(got, tkern.canonical_all_kmers_plain(packed, k))


# every key width W = 1..16, each at k = 16W (16W - 1 at W = 16) and
# 16W - 7
_CANON_KS = [15, 22, 32, 42, 56, 255] + [
    k for w in range(1, 17) for k in (min(16 * w, 255), 16 * w - 7)
    if k not in (15, 22, 32, 42, 56, 255)]


@pytest.mark.parametrize("k", _CANON_KS)
def test_canonical_kernel_matches_plain(k):
    rng = np.random.default_rng(k)
    packed = _i32(rng.integers(0, 2 ** 32, (1 << 16) + 37,
                               dtype=np.uint32)).cuda()
    _canonical_case(packed, k)


@pytest.mark.parametrize("k", [9, 22, 56, 144, 255])
@pytest.mark.parametrize("starts", ["one", 1, 2047, 0])
@pytest.mark.parametrize("offset", [0, 1])
def test_canonical_kernel_ragged_pools(k, starts, offset):
    """Pools whose window starts P - W are 1, 2047 or 0 (mod 2048) (no
    padding) or a single one (P = W + 1), starting on a 16-B boundary or
    4 B past it (a view buf[1:P+1])."""
    w = (k + 15) // 16
    p = w + (1 if starts == "one" else 3 * 2048 + starts)
    rng = np.random.default_rng(p + offset)
    buf = _i32(rng.integers(0, 2 ** 32, p + offset, dtype=np.uint32)).cuda()
    packed = buf[offset:]
    assert (packed.data_ptr() % 16 == 0) == (offset == 0)
    _canonical_case(packed, k)


@pytest.mark.parametrize("offset", [0, 1])
def test_canonical_kernel_count_chunk(offset):
    """The count's 2^26-base chunk at k1 = 22: 2^22 + 3 words."""
    p = (1 << 22) + 3
    rng = np.random.default_rng(22)
    buf = _i32(rng.integers(0, 2 ** 32, p + offset, dtype=np.uint32)).cuda()
    _canonical_case(buf[offset:], 22)


def _count_cols(n, dup, ninv, w, kind, offset):
    """w int32 key columns on the card for count_sorted_runs: "random"
    (_sorted_cols), "one_run" (every row one key) or "tile_runs" (a run
    per kernel tile, so runs end on tile boundaries); the
    last ninv rows all-ones sentinels. Column c starts offset[c] int32
    words past the start of its allocation (16-B aligned)."""
    if kind == "random":
        hi, lo = _sorted_cols(np.random.default_rng(n), n, dup, ninv)
    else:
        hi = (np.arange(n) // tkern.count_runs_tile() if kind == "tile_runs"
              else np.zeros(n)).astype(np.uint32)
        lo = np.zeros(n, np.uint32)
        if ninv:
            hi[-ninv:] = 0xFFFFFFFF
            lo[-ninv:] = 0xFFFFFFFF
    cols = ([hi, lo] + [lo] * (w - 2))[:w]
    offs = offset if isinstance(offset, tuple) else (offset,) * w
    return tuple(
        _i32(np.concatenate([np.zeros(o, np.uint32), a])).cuda()[o:]
        for a, o in zip(cols, offs))


@pytest.mark.parametrize("n,dup,ninv,w,kind,offset", [
    (1, 1, 0, 1, "random", 0), (1_000_003, 40, 333, 2, "random", 0),
    (3_000_017, 3_000_017, 9, 1, "random", 0),
    (98_305, 3, 1, 3, "random", 0),
    (33_000, 5, 32_999, 2, "random", 0),
    # every tile but the first headless: the longest look-ahead chain
    (4_000_000, 1, 0, 2, "one_run", 0),
    (4_000_000, 1, 4_000_000, 2, "one_run", 0),  # n_inv = n
    (3 * 4096, 1, 0, 2, "tile_runs", 0),
    (5 * 4096 + 7, 1, 7, 2, "tile_runs", 0),
    (4095, 30, 0, 2, "random", 0), (4096, 30, 0, 2, "random", 0),
    (4097, 30, 0, 2, "random", 0), (10_001, 300, 5, 2, "random", 0),
    # columns 4 B past a 16-B boundary, all of them or one of two
    (100_003, 50, 11, 2, "random", 1), (100_003, 50, 11, 2, "random", (0, 1)),
    (50_000, 20, 3, 16, "random", 0),  # W = 16
])
def test_count_kernel_matches_plain(n, dup, ninv, w, kind, offset):
    cols = _count_cols(n, dup, ninv, w, kind, offset)
    before = tkern.count_sorted_runs.launches
    # two launches back to back on one stream: each zeroes its own
    # descriptors and ticket
    got = [tkern.count_sorted_runs(cols, ninv) for _ in range(2)]
    assert tkern.count_sorted_runs.launches == before + 2
    h0, c0 = tkern.count_sorted_runs_plain(cols, ninv)
    for h1, c1 in got:
        assert torch.equal(h1, h0) and torch.equal(c1, c0)


def test_wrappers_refuse_bad_cuda_operands():
    with pytest.raises(TypeError):
        tkern.count_sorted_runs(
            (torch.zeros(10, dtype=torch.int64, device="cuda"),), 0)
    with pytest.raises(ValueError):
        tkern.canonical_all_kmers(
            torch.zeros(64, dtype=torch.int32, device="cuda")[::2], 21)
    # the count's launch refuses a scratch shorter than its tiles need
    n = 3 * tkern.count_runs_tile() + 1
    col = torch.zeros(n, dtype=torch.int32, device="cuda")
    head = torch.empty(n, dtype=torch.uint8, device="cuda")
    counts = torch.empty(n, dtype=torch.int32, device="cuda")
    scratch = torch.empty(4, dtype=torch.int64, device="cuda")
    ptrs = (tkern.ctypes.c_void_p * 1)(col.data_ptr())
    err = tkern._lib("count_runs").count_sorted_runs_launch(
        ptrs, 1, n, 0, head.data_ptr(), counts.data_ptr(),
        scratch.data_ptr(), 4, torch.cuda.current_stream().cuda_stream)
    assert err == 1  # cudaErrorInvalidValue
    # kernel 1's launch refuses an output too short for the pool's
    # window starts
    pool = torch.zeros(2048 + 3, dtype=torch.int32, device="cuda")
    out = torch.empty((2, 2048 * 16), dtype=torch.int32, device="cuda")
    err = tkern._lib("canonical_kmers").canonical_all_kmers_launch(
        pool.data_ptr(), pool.shape[0], out.data_ptr(), out.shape[1], 22,
        torch.cuda.current_stream().cuda_stream)
    assert err == 1
    # kernel 3 takes pairs of at most 32768 keys
    from megahit_tpu_torch.core import sortnet

    hi = torch.zeros(1 << 16, dtype=torch.int32, device="cuda")
    lo = torch.zeros(1 << 16, dtype=torch.int16, device="cuda")
    with pytest.raises(RuntimeError):
        sortnet.merge_pairs(hi, lo, 1 << 15)


def _sorted_runs(rng, n, run, kind, skip=0):
    """48-bit (hi int32, lo int16) planes on the card, sorted in runs of
    `run` keys: "uniform", "dup" (duplicate-heavy), "a_below" / "b_below"
    (in every pair, one run's keys all below the other's, so a tile's
    window is all A or all B) or "equal" (one key: ties go to A). With
    skip, views of the planes past their first `skip` keys (the runs
    start there)."""
    from megahit_tpu_torch.core import sortnet

    dup = kind == "dup"
    hi = rng.integers(0, 7 if dup else 2 ** 32, n).astype(np.uint32)
    lo = (rng.integers(0, 3 if dup else 2 ** 12, n) << 4).astype(np.uint16)
    key = (hi.astype(np.int64) << 16) | lo
    if kind in ("a_below", "b_below"):
        key = key >> 1  # below 2^47
        first = ((np.arange(n) - skip) // run) % 2 == (kind == "b_below")
        key = np.where(first, key, key + (1 << 47))
    elif kind == "equal":
        key = np.full(n, 0x123456789AB, np.int64)
    key[skip:] = np.sort(key[skip:].reshape(-1, run), axis=1).reshape(-1)
    hi, lo = sortnet.unpack_key(torch.from_numpy(key).cuda())
    return hi[skip:], lo[skip:]


@pytest.mark.parametrize("n,run,kind,offset", [
    (1 << 20, 2048, "uniform", 0), (1 << 20, 4096, "dup", 0),
    (8192, 512, "uniform", 0),
    # in every pair one run below the other, and all keys equal
    (1 << 20, 2048, "a_below", 0), (1 << 20, 4096, "b_below", 0),
    (1 << 20, 4096, "equal", 0),
    # pairs shorter than a thread's 32 ranks, and one pair a thread
    (1 << 16, 1, "uniform", 0), (1 << 16, 4, "dup", 0),
    (1 << 18, 16, "uniform", 0), (1 << 20, 512, "dup", 0),
    # a partial last slot: whole pairs, a part of a thread's 32 ranks,
    # a tail below one 16-B store
    (6 * 2048, 2048, "uniform", 0), (3 * 8192 + 24, 4, "uniform", 0),
    (8192 + 12, 2, "dup", 0), (8192 + 2, 1, "uniform", 0),
    # fewer slots than the grid has blocks
    (2, 1, "uniform", 0), (4096, 2048, "uniform", 0),
    # planes that start one key past 16 B
    (1 << 20, 2048, "uniform", 1), (8192 + 12, 2, "uniform", 1),
    # pairs longer than a slot of 8192: two slots in the ring, then one
    (1 << 18, 8192, "uniform", 0), (3 * 32768, 16384, "dup", 0),
    (3 * 32768, 16384, "uniform", 1)])
def test_merge_pairs_kernel_matches_plain(n, run, kind, offset):
    from megahit_tpu_torch.core import sortnet

    hi, lo = _sorted_runs(np.random.default_rng(run + n), n + offset, run,
                          kind, skip=offset)
    assert hi.shape[0] == n
    before = sortnet.merge_pairs.launches
    # two launches back to back on one stream
    got = [sortnet.merge_pairs(hi, lo, run) for _ in range(2)]
    assert sortnet.merge_pairs.launches == before + 2
    ph, pl = sortnet.merge_pairs_plain(hi, lo, run)
    for gh, gl in got:
        assert torch.equal(gh, ph) and torch.equal(gl, pl)


@pytest.mark.parametrize("n,run,tile,kind", [
    (1 << 20, 1 << 16, 8192, "uniform"), (1 << 20, 1 << 19, 8192, "dup"),
    (8192, 1024, 1024, "uniform"), (1 << 20, 1 << 16, 8192, "a_below"),
    (1 << 20, 1 << 16, 8192, "b_below"), (1 << 20, 1 << 16, 8192, "equal"),
    (1 << 20, 8192, 8192, "uniform"),  # run_len == tile
    (4096, 16, 4, "uniform"), (8192, 64, 32, "dup")])
def test_merge_path_kernel_matches_plain(n, run, tile, kind):
    from megahit_tpu_torch.core import sortnet

    hi, lo = _sorted_runs(np.random.default_rng(run + 1), n, run, kind)
    if kind == "uniform" and n // tile >= 64:
        # the tiles' A and B windows start at every residue mod 8 (the
        # bulk copies take their 16-B aligned supersets)
        a_from, _ = sortnet.merge_path_splits_plain(hi, lo, run, tile)
        t = torch.arange(n // tile, device=a_from.device) * tile
        ps = t // (2 * run) * (2 * run)
        starts = torch.cat([ps + a_from, ps + run + (t - ps) - a_from])
        assert len(set((starts % 8).tolist())) == 8
    before = sortnet.merge_path_level.launches
    gh, gl = sortnet.merge_path_level(hi, lo, run, tile)
    assert sortnet.merge_path_level.launches == before + 1
    ph, pl = sortnet.merge_pairs_plain(hi, lo, run)
    assert torch.equal(gh, ph) and torch.equal(gl, pl)


@pytest.mark.parametrize("n,run,tile,kind", [
    (1 << 20, 1 << 16, 8192, "uniform"), (1 << 20, 1 << 19, 8192, "dup"),
    (8192, 1024, 256, "dup"), (1 << 20, 1 << 16, 8192, "a_below"),
    (1 << 20, 1 << 16, 8192, "b_below"), (1 << 20, 1 << 16, 8192, "equal")])
def test_merge_path_splits_kernel_matches_plain(n, run, tile, kind):
    from megahit_tpu_torch.core import sortnet

    hi, lo = _sorted_runs(np.random.default_rng(run + 2), n, run, kind)
    got = sortnet.merge_path_splits(hi, lo, run, tile)
    want = sortnet.merge_path_splits_plain(hi, lo, run, tile)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# the device cleaning engine on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=sorted(cleaning_cases.CASES))
def cleaning_case(request):
    """(name, Sdbg factory by device, AssembleOptions kwargs): the small
    graphs of tests/cleaning_cases.py, counted on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    from megahit_tpu_torch.core import packing
    from megahit_tpu_torch.graph.counter import count_canonical_kmers
    from megahit_tpu_torch.graph.sdbg import sdbg_from_edges

    reads, min_count, opt = cleaning_cases.CASES[request.param]()
    flat, starts = packing.pack_many(reads)
    keys, counts = count_canonical_kmers(flat, starts, 22, min_count,
                                         device="cpu")

    def factory(device):
        return sdbg_from_edges(keys, counts, 22, device=device)

    return request.param, factory, opt


def _alive_signature(g):
    a = np.asarray(g.alive)
    return sorted(zip(g.length[a].tolist(), g.total_depth[a].tolist(),
                      g.is_loop[a].tolist()))


def test_device_engine_passes_match_host_engine(cleaning_case):
    """Every pass of the device engine on cuda against the host engine
    (graph/cleaning.py) on the same graph on the CPU: the count, the
    bubble records, the alive vertices and the edge validity (the host
    engine may put a vertex in another slot)."""
    from megahit_tpu_torch.graph import assemble_device as tad
    from megahit_tpu_torch.graph.cleaning import infer_min_depth
    from megahit_tpu_torch.graph.sdbg import remove_tips_sdbg
    from megahit_tpu_torch.graph.unitig import build_unitig_graph
    from megahit_tpu_torch.pipeline.assemble import _HostEngine

    name, factory, _ = cleaning_case
    hs, ds = factory("cpu"), factory("cuda")
    k = hs.k - 1
    remove_tips_sdbg(hs, 2 * k)
    remove_tips_sdbg(ds, 2 * k)
    min_depth = infer_min_depth(hs)
    host = _HostEngine(build_unitig_graph(hs))
    dev = tad.DeviceCleaner(build_unitig_graph(ds))
    assert dev.state.valid.b[0].is_cuda
    hrec, drec = [], []
    removed = 0
    for (step, hstep), (_, dstep) in zip(
            cleaning_cases.engine_steps(host, k, min_depth, hrec),
            cleaning_cases.engine_steps(dev, k, min_depth, drec)):
        n_h, n_d = hstep(), dstep()
        assert n_d == n_h, step
        removed += n_h[0] if isinstance(n_h, tuple) else n_h
        # both engines keep depths in float64: the records are equal,
        # depths included
        assert drec == hrec, step
        gh, gd = host.to_host(), dev.to_host()
        assert _alive_signature(gd) == _alive_signature(gh), step
        np.testing.assert_array_equal(gd.sdbg.valid, gh.sdbg.valid, step)
    assert removed > 0 or name in cleaning_cases.CLEAN


def test_device_engine_cuda_matches_cpu_tensors(cleaning_case,
                                                monkeypatch):
    """The device engine on cuda against itself on CPU tensors, from the
    same graph built by the torch passes on both devices: every
    to_host() array equal after every pass (scatters with duplicate
    indices included)."""
    from megahit_tpu_torch import convert
    from megahit_tpu_torch.graph import assemble_device as tad
    from megahit_tpu_torch.graph import sdbg as tsd
    from megahit_tpu_torch.graph.cleaning import infer_min_depth
    from megahit_tpu_torch.graph.unitig import build_unitig_graph

    from megahit_tpu_torch.utils import device as devices

    monkeypatch.setattr(devices, "graph_on_card", lambda device: True)
    _, factory, _ = cleaning_case
    engines, recs = [], []
    for device in ("cpu", "cuda"):
        s = factory(device)
        tsd.remove_tips_sdbg(s, 2 * (s.k - 1))
        engines.append(tad.DeviceCleaner(build_unitig_graph(s)))
        recs.append([])
    k = s.k - 1
    min_depth = infer_min_depth(s)
    for (step, cstep), (_, gstep) in zip(
            cleaning_cases.engine_steps(engines[0], k, min_depth, recs[0]),
            cleaning_cases.engine_steps(engines[1], k, min_depth, recs[1])):
        assert gstep() == cstep(), step
        assert recs[1] == recs[0], step
        gc, gg = engines[0].to_host(), engines[1].to_host()
        for f in convert.UNITIG_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(gg, f)),
                                          np.asarray(getattr(gc, f)),
                                          f"{step}: {f}")


def test_assemble_on_cuda_matches_cpu(cleaning_case):
    """assemble() of a cuda graph (device engine) gives the records and
    stats of the same graph on the CPU (host engine)."""
    from megahit_tpu_torch.pipeline.assemble import (
        AssembleOptions, assemble,
    )

    _, factory, opt = cleaning_case
    want = assemble(factory("cpu"), AssembleOptions(**opt))
    got = assemble(factory("cuda"), AssembleOptions(**opt))
    assert cleaning_cases.records(got) == cleaning_cases.records(want)
    assert got.stats == want.stats
