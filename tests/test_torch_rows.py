"""The row-block exchanges of the mesh cleaner (megahit_tpu_torch/
parallel/rows.py) and Mesh.all_to_all_v, held exactly against plain
indexing, index_put_, index_add_ and scatter_reduce_ on the whole
tensor.

Every case is made from a seed with numpy, as a whole tensor plus each
shard's requests; ``run_cases`` checks this process's shards only, so
the same function runs over one-process meshes Mesh(["cpu"] * n) (every
shard local, exchanges as copies), over Rows with no mesh (one block,
no exchange), and in each of two gloo ranks (one shard a rank)."""

import os

import numpy as np
import pytest
import torch

from megahit_tpu_torch.parallel import rows as R
from megahit_tpu_torch.parallel.multihost import Mesh
from megahit_tpu_torch.parallel.rows import Blocks, Rows

import torch_test_env  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
ROWS = 96  # divisible by 1, 2, 4 and 8


def _requests(kind: str, n: int, rng) -> list[np.ndarray]:
    """Each shard's global row ids for one request pattern."""
    b = ROWS // n
    out = []
    for i in range(n):
        m = int(rng.integers(0, 40))
        if kind == "uniform":
            r = rng.integers(0, ROWS, m)
        elif kind == "empty":
            r = rng.integers(0, ROWS, m if i % 2 else 0)
        elif kind == "none":
            r = np.zeros(0, np.int64)
        elif kind == "one_owner":
            r = rng.integers((n - 1) * b, ROWS, m + 5)
        elif kind == "edges":
            r = np.array([0, ROWS - 1] + [j * b + d for j in range(1, n)
                                          for d in (-1, 0)], np.int64)
            r = np.tile(r, 2)
        elif kind == "repeats":
            r = np.full(m + 30, int(rng.integers(0, ROWS)))
        else:
            raise ValueError(kind)
        out.append(np.asarray(r, np.int64))
    return out


KINDS = ("uniform", "empty", "none", "one_owner", "edges", "repeats")


def _sources(rng):
    """Whole source tensors of every dtype an exchange carries."""
    f = rng.standard_normal(ROWS).astype(np.float32)
    f[:4] = [-0.0, np.inf, -np.inf, np.nan]
    d = rng.standard_normal(ROWS)
    d[:4] = [-0.0, np.inf, -np.inf, np.nan]
    return [
        torch.from_numpy(rng.integers(-2**40, 2**40, ROWS)),
        torch.from_numpy(rng.integers(-2**31, 2**31, ROWS).astype(
            np.int32)),
        torch.from_numpy(rng.random(ROWS) < 0.5),
        torch.from_numpy(f),
        torch.from_numpy(d),
        torch.from_numpy(rng.integers(0, 2, ROWS).astype(np.int8)),
        torch.from_numpy(rng.integers(-9, 9, (ROWS, 4))),
    ]


def _blocks(rows: Rows, full: torch.Tensor) -> Blocks:
    b = full.shape[0] // rows.n
    return Blocks(full[i * b: (i + 1) * b].clone() for i in rows.local)


def _local(rows: Rows, per_shard) -> Blocks:
    return Blocks(per_shard[i] for i in rows.local)


def _same(a: torch.Tensor, b: torch.Tensor, what) -> None:
    """Bit-exact equality (floats compared by bit pattern)."""
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    assert torch.equal(a, b), what


def check_take(rows: Rows, seed: int) -> None:
    rng = np.random.default_rng(seed)
    srcs = _sources(rng)
    for kind in KINDS:
        reqs = _requests(kind, rows.n, rng)
        shaped = [torch.from_numpy(r).reshape(-1, 2) if len(r) % 2 == 0
                  else torch.from_numpy(r) for r in reqs]
        got = rows.take([_blocks(rows, s) for s in srcs],
                        _local(rows, shaped))
        for c, (src, g) in enumerate(zip(srcs, got)):
            for j, i in enumerate(rows.local):
                _same(g.b[j], src[shaped[i]], (kind, c, i))


def _scatter_want(full, reqs, vals, op, pad):
    """The whole-tensor write: every shard's requests in shard order,
    masked ids to a pad row that is dropped."""
    t = torch.cat([full, torch.full((1,), pad, dtype=full.dtype)])
    for r, v in zip(reqs, vals):
        r = torch.from_numpy(r)
        tgt = torch.where((r >= 0) & (r < ROWS), r, ROWS)
        if op == "put":
            t[tgt] = v
        elif op == "add":
            t.index_add_(0, tgt, v)
        else:
            t.scatter_reduce_(0, tgt, v, reduce="amin")
    return t[:ROWS]


def check_scatter(rows: Rows, seed: int) -> None:
    rng = np.random.default_rng(seed)
    for kind in KINDS:
        reqs = _requests(kind, rows.n, rng)
        # masked ids on either side of the rows
        reqs = [np.where(rng.random(len(r)) < 0.2,
                         rng.choice([-1, ROWS, ROWS + 7], len(r)), r)
                for r in reqs]
        # put: one value per target row (the first request of each row
        # over all shards), so any order of writes gives the same rows
        seen = set()
        uniq = []
        for r in reqs:
            keep = []
            for x in r.tolist():
                ok = x not in seen or not 0 <= x < ROWS
                keep.append(ok)
                seen.add(x)
            uniq.append(r[np.array(keep, bool)] if len(r) else r)
        base = torch.from_numpy(rng.integers(-50, 50, ROWS))
        vals = [torch.from_numpy(rng.integers(-99, 99, len(r)))
                for r in uniq]
        flags = [torch.from_numpy(rng.random(len(r)) < 0.5) for r in uniq]
        got = rows.scatter(
            [_blocks(rows, base), _blocks(rows, torch.zeros(ROWS,
                                                           dtype=bool)),
             _blocks(rows, torch.zeros(ROWS, dtype=bool))],
            _local(rows, [torch.from_numpy(r) for r in uniq]),
            [_local(rows, vals), _local(rows, flags), True], "put")
        wants = [_scatter_want(base, uniq, vals, "put", 0),
                 _scatter_want(torch.zeros(ROWS, dtype=bool), uniq, flags,
                               "put", False),
                 _scatter_want(torch.zeros(ROWS, dtype=bool), uniq,
                               [True] * len(uniq), "put", False)]
        _compare(rows, got, wants, (kind, "put"))
        # add (int32) and amin (int64): duplicates and every shard's
        # writes to one row accumulate
        adds = [torch.from_numpy(rng.integers(-9, 9, len(r)).astype(
            np.int32)) for r in reqs]
        got = rows.scatter(
            [_blocks(rows, torch.zeros(ROWS, dtype=torch.int32)),
             _blocks(rows, torch.zeros(ROWS, dtype=torch.int32))],
            _local(rows, [torch.from_numpy(r) for r in reqs]),
            [_local(rows, adds), 1], "add")
        ones = [torch.ones(len(r), dtype=torch.int32) for r in reqs]
        _compare(rows, got, [
            _scatter_want(torch.zeros(ROWS, dtype=torch.int32), reqs, adds,
                          "add", 0),
            _scatter_want(torch.zeros(ROWS, dtype=torch.int32), reqs, ones,
                          "add", 0)], (kind, "add"))
        mins = [torch.from_numpy(rng.integers(0, 1000, len(r)))
                for r in reqs]
        base = torch.full((ROWS,), 500, dtype=torch.int64)
        (got,) = rows.scatter(
            [_blocks(rows, base)],
            _local(rows, [torch.from_numpy(r) for r in reqs]),
            [_local(rows, mins)], "amin")
        _compare(rows, [got], [_scatter_want(base, reqs, mins, "amin",
                                             500)], (kind, "amin"))


def _compare(rows, got, wants, what):
    b = ROWS // rows.n
    for c, (g, w) in enumerate(zip(got, wants)):
        for j, i in enumerate(rows.local):
            _same(g.b[j], w[i * b: (i + 1) * b], (what, c, i))


def check_total(rows: Rows) -> None:
    x = Blocks(torch.tensor(i + 1) for i in rows.local)
    y = Blocks(torch.tensor(i % 2 == 0) for i in rows.local)
    n = rows.n
    assert rows.total(x, y) == [n * (n + 1) // 2, (n + 1) // 2]


def run_cases(rows: Rows, seed: int) -> None:
    check_take(rows, seed)
    check_scatter(rows, seed + 1)
    check_total(rows)


def _layouts(n):
    if n == 0:
        return Rows(None, "cpu")
    return Rows(Mesh(["cpu"] * n))


@pytest.mark.parametrize("n", [0, 1, 2, 4, 8])
def test_take_scatter_total_match_plain(n):
    """n = 0: no mesh (one block, plain indexing); n >= 1: one process
    owning n shards, every exchange through Mesh.all_to_all_v."""
    rows = _layouts(n)
    run_cases(rows, 100 + n)
    if n > 1:
        assert rows.exchanges > 0 and rows.bytes > 0
    else:
        assert rows.bytes == 0


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_all_to_all_v_in_process(n):
    """Uneven splits, empty sends and an all-empty exchange: shard j
    receives every shard's rows for j, in shard order."""
    rng = np.random.default_rng(n)
    mesh = Mesh(["cpu"] * n)
    for empty in (False, True):
        splits = [[0 if empty else int(rng.integers(0, 5)) for _ in
                   range(n)] for _ in range(n)]
        sends = [torch.from_numpy(rng.integers(0, 99, (sum(s), 3)))
                 for s in splits]
        recvs, got = mesh.all_to_all_v(sends, splits)
        for j in range(n):
            offs = [int(np.sum(splits[i][:j])) for i in range(n)]
            want = torch.cat([sends[i][offs[i]: offs[i] + splits[i][j]]
                              for i in range(n)])
            assert torch.equal(recvs[j], want)
            assert got[j] == [splits[i][j] for i in range(n)]


def test_take_rejects_rows_out_of_range():
    """A take of a row the mesh does not hold raises, on every route
    (with no mesh it is plain indexing, where -1 is the last row)."""
    for rows, bads in ((Rows(None, "cpu"), (ROWS,)),
                       (Rows(Mesh(["cpu"] * 4)), (ROWS, -1))):
        src = _blocks(rows, torch.arange(ROWS))
        for bad in bads:
            with pytest.raises((IndexError, RuntimeError)):
                rows.take([src], _local(rows, [torch.tensor([bad])] * 4))


def test_blocks_refuse_row_indexing_and_truth():
    x = Blocks([torch.arange(4), torch.arange(4)])
    with pytest.raises(TypeError):
        x[x]
    with pytest.raises(TypeError):
        bool(x > 1)
    y = R.where(x > 1, x, -1) + 1
    assert [t.tolist() for t in y.b] == [[0, 0, 3, 4]] * 2


RANK_WORKER = r"""
import os, sys
import torch
torch.set_num_threads(1)
port, rank = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, sys.argv[4])
from megahit_tpu_torch.parallel.multihost import (
    global_shard_mesh, init_distributed,
)
from megahit_tpu_torch.parallel.rows import Rows
init_distributed(coordinator=f"localhost:{port}", num_processes=2,
                 process_id=rank, device="cpu")
mesh = global_shard_mesh("cpu")
assert (mesh.size, mesh.local, mesh.transport) == (2, [rank], "gloo")
import test_torch_rows as t
rows = Rows(mesh)
t.run_cases(rows, 102)
recvs, got = mesh.all_to_all_v([torch.zeros((0, 2), dtype=torch.int64)],
                               [[0, 0]])
assert recvs[0].shape == (0, 2) and got == [[0, 0]]
torch.distributed.destroy_process_group()
print("WORKER_DONE", rank, flush=True)
"""


def test_take_scatter_on_two_gloo_ranks(tmp_path):
    """The same cases in each of two gloo ranks, one shard a rank: the
    exchanges go through all_to_all_single with uneven and empty
    splits."""
    from test_torch_multiprocess import _run_ranks

    _run_ranks(tmp_path, RANK_WORKER, HERE)
