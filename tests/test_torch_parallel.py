"""The port's sharded count and sample sort (megahit_tpu_torch/parallel/)
against megahit_tpu's single-device pieces, on the CPU.

megahit_tpu's mesh programs are not run here: its own tests hold them
equal to the single-device functions. The port runs over its own
one-process meshes, Mesh(["cpu"] * n): the hash and the routing buffer
must equal megahit_tpu's kmer_hash and _route_to_buffer (jitted on one
CPU device) bit for bit, the sharded count must equal megahit_tpu's
count_canonical_kmers (the ports of tests/test_parallel.py's three cases,
k1 = 32 and a repeated read that forces the retry), and the sharded sort
must equal np.lexsort, shard by shard sorted and ascending. Exact
equality throughout."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megahit_tpu.core import packing
from megahit_tpu.graph import counter as jcounter
from megahit_tpu.parallel import shuffle as jsh
from megahit_tpu_torch.core import kmerops as tk
from megahit_tpu_torch.parallel import shuffle as tsh
from megahit_tpu_torch.parallel.multihost import (
    Mesh, fetch_global, put_global,
)

import torch_test_env  # noqa: F401

M32 = 0xFFFFFFFF


def _mesh(n):
    return Mesh(["cpu"] * n)


def _u32(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("w", [1, 2, 3])
def test_kmer_hash_bit_equal(w):
    rng = np.random.default_rng(100 + w)
    keys = _u32(rng, (4096, w))
    keys[:8] = M32
    keys[8:16] = 0
    keys[16:24, 0] = M32
    want = np.asarray(jax.jit(jsh.kmer_hash)(jnp.asarray(keys)))
    got = tsh.kmer_hash(tk.to_torch(keys, "cpu")).numpy()
    assert got.min() >= 0 and got.max() <= M32
    np.testing.assert_array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_route_to_buffer_equal(n_dev):
    """Buffer and overflow count equal megahit_tpu's, with a capacity
    small enough to overflow."""
    rng = np.random.default_rng(n_dev)
    b, w = 1000, 3
    keys = _u32(rng, (b, w))
    keys[:, -1] = 1  # the counter's validity column
    valid = rng.random(b) < 0.9
    capacity = int(0.8 * b / n_dev)
    fn = jax.jit(functools.partial(jsh._route_to_buffer, n_dev=n_dev,
                                   capacity=capacity))
    jbuf, jover = fn(jnp.asarray(keys), jnp.asarray(valid))
    tbuf, tover = tsh._route_to_buffer(tk.to_torch(keys, "cpu"),
                                       torch.from_numpy(valid), n_dev,
                                       capacity)
    assert int(tover) == int(jover) > 0
    np.testing.assert_array_equal(tk.to_numpy(tbuf), np.asarray(jbuf))


def test_count_local_equal():
    rng = np.random.default_rng(5)
    keys = _u32(rng, (512, 2)) % np.uint32(7)
    valid = rng.random(512) < 0.8
    jk, jc, jh = jax.jit(jsh._count_local)(jnp.asarray(keys),
                                          jnp.asarray(valid))
    tk_, tc, th = tsh._count_local(tk.to_torch(keys, "cpu"),
                                   torch.from_numpy(valid))
    np.testing.assert_array_equal(tk.to_numpy(tk_), np.asarray(jk))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tc.numpy()[th.numpy()],
                                  np.asarray(jc)[np.asarray(jh)])


# ---------------------------------------------------------------------------
# sharded count
# ---------------------------------------------------------------------------


def _random_reads(rng, n, length):
    return [rng.integers(0, 4, size=length).astype(np.uint8)
            for _ in range(n)]


def _case(name):
    """(reads, n_dev, k1, min_count, return_rare, retry expected)."""
    rng = np.random.default_rng(7)
    if name == "single_device_8":
        return _random_reads(rng, 64, 80), 8, 22, 1, False, False
    if name == "min_count_4":
        reads = _random_reads(rng, 16, 60)
        return reads + [reads[0].copy() for _ in range(3)], 4, 22, 2, \
            False, False
    if name == "return_rare_4":
        reads = _random_reads(rng, 20, 70)
        return reads + [reads[1].copy() for _ in range(2)], 4, 22, 2, \
            True, False
    if name == "k32_rare_8":
        reads = _random_reads(rng, 40, 90)
        reads[0][10:60] = 3  # T runs: all-T windows, canonical all-A
        return reads + [reads[2].copy() for _ in range(2)], 8, 32, 2, \
            True, False
    # one 24-bp read repeated: 3 distinct 22-mers, so every source shard
    # sends nearly all its rows to at most 3 owners and overflows 2x
    read = rng.integers(0, 4, size=24).astype(np.uint8)
    return [read.copy() for _ in range(200)], 8, 22, 2, True, True


@pytest.mark.parametrize("name", ["single_device_8", "min_count_4",
                                  "return_rare_4", "k32_rare_8",
                                  "repeated_read_retry"])
def test_sharded_count_matches_single_device(name, monkeypatch):
    reads, n_dev, k1, min_count, rare, retry = _case(name)
    flat, starts = packing.pack_many(reads)
    want = jcounter.count_canonical_kmers(flat, starts, k1, min_count,
                                          return_rare=rare)
    factors = []
    make = tsh.make_sharded_counter

    def counting(mesh, k1, capacity_factor=2.0):
        factors.append(capacity_factor)
        return make(mesh, k1, capacity_factor)

    monkeypatch.setattr(tsh, "make_sharded_counter", counting)
    got = tsh.sharded_count_kmers(flat, starts, k1, min_count,
                                  _mesh(n_dev), return_rare=rare)
    assert factors == ([2.0, float(n_dev)] if retry else [2.0])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) > 0
    if rare:
        assert len(got[2]) > 0 or name == "repeated_read_retry"


def test_window_positions_match():
    rng = np.random.default_rng(3)
    reads = [rng.integers(0, 4, size=int(n)).astype(np.uint8)
             for n in rng.integers(1, 60, size=50)]
    _, starts = packing.pack_many(reads)
    for k in (1, 22, 32):
        np.testing.assert_array_equal(
            tsh.window_positions(starts, k),
            jcounter.window_positions(starts, k))


# ---------------------------------------------------------------------------
# sharded sort
# ---------------------------------------------------------------------------


def _sort_input(kind, n, w, rng):
    keys = _u32(rng, (n, w))
    if kind == "all_equal":
        keys[:] = np.arange(1, w + 1, dtype=np.uint32)
    elif kind == "clustered":
        # already sorted: each source shard holds one key range, so it
        # sends its rows to one owner and overflows the 2.5x capacity
        keys = keys[np.lexsort(keys.T[::-1])]
    elif kind == "sentinel_padded":
        keys[rng.random(n) < 0.1] = M32
    return keys


@pytest.mark.parametrize("kind,n_dev,retry", [
    ("uniform", 8, False), ("all_equal", 8, False),
    ("clustered", 4, True), ("sentinel_padded", 8, False),
])
def test_sharded_sort_matches_lexsort(kind, n_dev, retry):
    rng = np.random.default_rng(len(kind))
    n, w = 4099, 2
    keys = _sort_input(kind, n, w, rng)
    real = keys[~np.all(keys == M32, axis=1)]
    want = real[np.lexsort(real.T[::-1])]
    mesh = _mesh(n_dev)
    np.testing.assert_array_equal(tsh.sharded_sort_kmers(keys, mesh), want)

    # shard by shard: sorted, ascending across shards, within capacity
    npad = -(-n // n_dev) * n_dev
    kp = np.full((npad, w), M32, np.uint32)
    kp[:n] = keys
    vp = np.zeros(npad, dtype=bool)
    vp[:n] = ~np.all(keys == M32, axis=1)
    kd, vd = put_global(kp, mesh), put_global(vp, mesh)
    out_k, out_v, n_over = tsh.make_sharded_sorter(mesh, w)(kd, vd)
    assert (n_over > 0) == retry
    if retry:
        out_k, out_v, n_over = tsh.make_sharded_sorter(
            mesh, w, capacity_factor=float(n_dev))(kd, vd)
        assert n_over == 0
    cap_rows = out_k[0].shape[0]
    shards = [tk.to_numpy(k[v]) for k, v in zip(out_k, out_v)]
    assert sum(len(s) for s in shards) == len(want)
    assert all(len(s) <= cap_rows for s in shards)
    for s in shards:
        np.testing.assert_array_equal(s, s[np.lexsort(s.T[::-1])])
    filled = [s for s in shards if len(s)]
    for a, b in zip(filled, filled[1:]):
        assert tuple(a[-1]) <= tuple(b[0])
    if kind == "all_equal":
        assert len(filled) == n_dev  # ties spread over every shard
    np.testing.assert_array_equal(
        fetch_global([k[v] for k, v in zip(out_k, out_v)],
                     mesh).astype(np.uint32), want)


def test_put_fetch_roundtrip():
    mesh = _mesh(4)
    a = np.arange(40, dtype=np.uint32).reshape(20, 2) + np.uint32(M32 - 50)
    blocks = put_global(a, mesh)
    assert len(blocks) == 4 and all(b.shape == (5, 2) for b in blocks)
    assert all(b.dtype == torch.int64 for b in blocks)
    np.testing.assert_array_equal(fetch_global(blocks, mesh), a)
    rep = put_global(a, mesh, replicate=True)
    assert len(rep) == 4 and all(r.shape == (20, 2) for r in rep)
    flags = put_global(np.arange(8) % 3 == 0, mesh)
    assert [f.tolist() for f in flags] == [[True, False], [False, True],
                                           [False, False], [True, False]]
    uneven = [b[:i] for i, b in enumerate(blocks)]
    np.testing.assert_array_equal(fetch_global(uneven, mesh),
                                  np.concatenate([a[0:0], a[5:6], a[10:12],
                                                  a[15:18]]))
    with pytest.raises(ValueError):
        put_global(np.zeros(7), mesh)


def test_single_process_mesh(monkeypatch):
    """Without a coordinator or WORLD_SIZE > 1, init_distributed starts
    nothing, and the CPU mesh is one in-process shard."""
    import torch.distributed as dist

    from megahit_tpu_torch.parallel import multihost

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    multihost.init_distributed(device="cpu")
    assert not dist.is_initialized()
    mesh = multihost.global_shard_mesh("cpu")
    assert (mesh.size, mesh.local, mesh.distributed) == (1, [0], False)
    assert mesh.transport == "in-process copies"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost.global_shard_mesh("cuda")


def test_parallel_imports_no_jax():
    """No module of megahit_tpu_torch/parallel/ imports jax or
    megahit_tpu (checked in a fresh interpreter)."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import megahit_tpu_torch.parallel.multihost\n"
        "import megahit_tpu_torch.parallel.shuffle\n"
        "import megahit_tpu_torch.graph.bucketed\n"
        "import megahit_tpu_torch.graph.assemble_device\n"
        "import megahit_tpu_torch.pipeline.driver\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'megahit_tpu' or "
        "m.startswith('megahit_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
