"""Row blocks: how a row-sharded device pass reads and writes its rows.

A sharded capacity of N rows is split over the mesh's n shards in equal
blocks: shard i owns rows [i*N/n, (i+1)*N/n). A tensor of such rows is a
``Blocks``: this process's blocks, one per local shard (n of them in one
process, one per rank under torch.distributed), each on its shard's
device. Elementwise math maps over the blocks (operators, tensor
methods and ``bmap``/``where``/``minimum``/``stack``); a row of another
shard is read or written only through the two exchanges of ``Rows``:

- ``take(srcs, idx)``: each shard sends the global row ids it needs to
  their owners (sorted by owner, with the split sizes exchanged first),
  the owners index their blocks and send the values back in request
  order. Several columns read at the same rows go in one exchange.
- ``scatter(dsts, idx, vals, op)``: each shard sends (row id, value)
  pairs to the owners, which apply them to their blocks with ``put``
  (``index_put_``), ``add`` (``index_add_``) or ``amin``
  (``scatter_reduce_``). Row ids outside [0, N) write nothing, as a
  masked write to a pad row does in a whole-tensor pass.

Values travel as int64 columns: integers and bools by value, float32 as
its int32 bit pattern and float64 as its int64 one, so an exchange is
exact and gloo (which has no uint32 or bool) carries it. Every shard calls every exchange, with an
empty send when it has nothing to send.

With no mesh the layout is one block holding every row: ``take`` is
plain indexing and ``scatter`` an indexed write through a pad row,
with no exchange, so a whole-tensor engine runs the same pass code.
"""

from __future__ import annotations

import operator

import numpy as np
import torch

from .multihost import fetch_global

I32 = torch.int32
I64 = torch.int64
# floats travel as the integers of their bit patterns
_BITS = {torch.float32: I32, torch.float64: I64}


def _at(x, i):
    """x with every Blocks in it replaced by its i-th block."""
    if isinstance(x, Blocks):
        return x.b[i]
    if isinstance(x, (list, tuple)):
        return type(x)(_at(v, i) for v in x)
    if isinstance(x, dict):
        return {k: _at(v, i) for k, v in x.items()}
    return x


def _count(x) -> int | None:
    """The block count of the first Blocks in x, or None."""
    if isinstance(x, Blocks):
        return len(x.b)
    if isinstance(x, (list, tuple)):
        for v in x:
            n = _count(v)
            if n is not None:
                return n
    if isinstance(x, dict):
        return _count(list(x.values()))
    return None


def _wrap(results):
    if isinstance(results[0], tuple):
        return tuple(Blocks(col) for col in zip(*results))
    return Blocks(results)


def bmap(fn, *args, **kw):
    """fn applied block by block (args holding Blocks pass their block,
    anything else passes as is)."""
    n = _count((args, kw))
    return _wrap([fn(*_at(args, i), **_at(kw, i)) for i in range(n)])


def where(cond, a, b):
    return bmap(torch.where, cond, a, b)


def minimum(a, b):
    return bmap(torch.minimum, a, b)


def stack(xs, dim: int = 0):
    return bmap(torch.stack, list(xs), dim)


class Blocks:
    """One row-sharded tensor: this process's blocks, in the order of
    the layout's local shards."""

    __slots__ = ("b",)
    __hash__ = None

    def __init__(self, blocks):
        self.b = list(blocks)

    def __bool__(self):
        raise TypeError("a row-sharded tensor has no truth value; "
                        "reduce it with Rows.total")

    def __getattr__(self, name):
        attrs = [getattr(t, name) for t in self.b]
        if not callable(attrs[0]):
            return Blocks(attrs)

        def call(*args, **kw):
            return _wrap([f(*_at(args, i), **_at(kw, i))
                          for i, f in enumerate(attrs)])

        return call

    def __getitem__(self, key):
        if _count(key) is not None:
            raise TypeError("rows of a sharded tensor are read with "
                            "Rows.take")
        return Blocks(t[key] for t in self.b)


def _binary(op, reflected=False):
    if reflected:
        return lambda self, o: Blocks(op(_at(o, i), t)
                                      for i, t in enumerate(self.b))
    return lambda self, o: Blocks(op(t, _at(o, i))
                                  for i, t in enumerate(self.b))


for _name, _op in (("and", operator.and_), ("or", operator.or_),
                   ("add", operator.add), ("sub", operator.sub),
                   ("mul", operator.mul), ("truediv", operator.truediv)):
    setattr(Blocks, f"__{_name}__", _binary(_op))
    setattr(Blocks, f"__r{_name}__", _binary(_op, reflected=True))
for _name in ("eq", "ne", "lt", "le", "gt", "ge"):
    setattr(Blocks, f"__{_name}__", _binary(getattr(operator, _name)))
Blocks.__invert__ = lambda self: Blocks(~t for t in self.b)
Blocks.__neg__ = lambda self: Blocks(-t for t in self.b)


def _pack(cols, n: int) -> torch.Tensor:
    """(n, sum of widths) int64 from columns with n leading rows."""
    out = []
    for c in cols:
        if c.dtype in _BITS:
            c = c.view(_BITS[c.dtype])
        w = int(np.prod(c.shape[1:], dtype=np.int64))
        out.append(c.reshape(n, w).to(I64))
    return out[0] if len(out) == 1 else torch.cat(out, 1)


def _unpack(p: torch.Tensor, like) -> list[torch.Tensor]:
    """Inverse of _pack: columns shaped (rows,) + each like's trailing
    shape, in each like's dtype."""
    out, o = [], 0
    for t in like:
        tail = tuple(t.shape[1:])
        w = int(np.prod(tail, dtype=np.int64))
        c = p[:, o: o + w]
        o += w
        if t.dtype in _BITS:
            c = c.to(_BITS[t.dtype]).view(t.dtype)
        else:
            c = c.to(t.dtype)
        out.append(c.reshape((p.shape[0],) + tail))
    return out


class Rows:
    """This process's row layout: the mesh's equal row blocks, one per
    local shard, or (mesh None) one block of every row on `device`.
    Counts the exchanges it runs and the bytes its shards send to other
    shards (row ids and values; a shard's rows to itself are free)."""

    def __init__(self, mesh=None, device=None):
        self.mesh = mesh
        if mesh is None:
            self.n, self.local = 1, [0]
            self.devices = [torch.device(device)]
        else:
            self.n, self.local = mesh.size, list(mesh.local)
            self.devices = mesh.local_devices()
        self.exchanges = 0
        self.bytes = 0

    # -- blocks from nothing, from the host, to the host -------------------

    def const(self, value, dtype) -> Blocks:
        """A 0-d tensor of value on every local device."""
        return Blocks(torch.tensor(value, dtype=dtype, device=d)
                      for d in self.devices)

    def arange(self, rows: int) -> Blocks:
        """Global row ids of this process's blocks of `rows` rows."""
        b = rows // self.n
        return Blocks(torch.arange(i * b, (i + 1) * b, device=d)
                      for i, d in zip(self.local, self.devices))

    def full(self, rows: int, fill, dtype) -> Blocks:
        b = rows // self.n
        return Blocks(torch.full((b,), fill, dtype=dtype, device=d)
                      for d in self.devices)

    def put(self, arr, rows: int, dtype, fill=0) -> Blocks:
        """This process's blocks of a host array of up to `rows` rows
        (shorter arrays pad with `fill`): each uploads only its own
        host rows."""
        b = rows // self.n
        out = []
        for i, d in zip(self.local, self.devices):
            chunk = np.asarray(arr[i * b: (i + 1) * b])
            if chunk.shape[0] < b:
                full = np.full((b,) + chunk.shape[1:], fill, chunk.dtype)
                full[: chunk.shape[0]] = chunk
                chunk = full
            out.append(torch.from_numpy(np.ascontiguousarray(chunk)).to(
                d, dtype))
        return Blocks(out)

    def fetch(self, x: Blocks) -> np.ndarray:
        """Every row of x as one host array."""
        if self.mesh is None:
            return x.b[0].cpu().numpy()
        return fetch_global(x.b, self.mesh)

    def total(self, *xs: Blocks) -> list[int]:
        """Global sums of per-block integer scalars, one host sync."""
        vec = [torch.stack([x.b[j].to(I64) for x in xs])
               for j in range(len(self.local))]
        if self.mesh is None:
            return vec[0].tolist()
        return self.mesh.psum_vec(vec)

    # -- exchanges -------------------------------------------------------

    def _owners(self, flat: torch.Tensor, block: int) -> torch.Tensor:
        """Each global row id's owner shard; n for an id outside the
        rows."""
        ok = (flat >= 0) & (flat < self.n * block)
        return torch.where(ok, torch.div(flat, block, rounding_mode="floor"),
                           self.n)

    def _counts(self, per_shard: list[torch.Tensor]) -> list[list[int]]:
        """(n + 1,) per-owner counts of every local shard, with one host
        sync for all of them."""
        dev = per_shard[0].device
        return torch.stack([c.to(dev) for c in per_shard]).tolist()

    def _bins(self, owner: torch.Tensor) -> torch.Tensor:
        """(n + 1,) count of each owner (a histogram kernel: an
        index_add_ of ones would contend on n + 1 atomics)."""
        return torch.bincount(owner, minlength=self.n + 1)

    def _account(self, splits, width: int) -> None:
        """Count the rows of `width` int64 columns the local shards
        send to other shards."""
        for j, s in enumerate(splits):
            me = self.local[j]
            self.bytes += 8 * width * (sum(s) - s[me])

    def take(self, srcs, idx: Blocks) -> list[Blocks]:
        """srcs[c] at the global row ids idx (any shape, every id in
        range): one Blocks per source, of idx's shape plus the source's
        trailing shape. Each shard asks for each distinct row once, so
        many reads of one row (clamped masked ids, pointers converging
        on a chain's end) cost its owner one row."""
        srcs = list(srcs)
        if self.mesh is None:
            i = idx.b[0]
            return [Blocks([s.b[0][i]]) for s in srcs]
        block = srcs[0].b[0].shape[0]
        plans, bins = [], []
        for t in idx.b:
            uniq, inv = torch.unique(t.reshape(-1), sorted=True,
                                     return_inverse=True)
            owner = self._owners(uniq, block)
            bins.append(self._bins(owner))
            plans.append((uniq, inv, owner))
        counts = self._counts(bins)
        if any(c[self.n] for c in counts):
            raise IndexError(f"row id outside the {self.n * block} rows")
        splits = [c[: self.n] for c in counts]
        # distinct ids in id (so owner) order, as owner-local rows
        recv, rsplits = self.mesh.all_to_all_v(
            [uniq - owner * block for uniq, _, owner in plans], splits)
        reply = [_pack([s.b[j][q] for s in srcs], q.shape[0])
                 for j, q in enumerate(recv)]
        back, _ = self.mesh.all_to_all_v(reply, rsplits,
                                         recv_splits=splits)
        self.exchanges += 1
        self._account(splits, 1)
        self._account(rsplits, reply[0].shape[1])
        outs = [[] for _ in srcs]
        for j, ((_, inv, _), got) in enumerate(zip(plans, back)):
            for c, col in enumerate(_unpack(got[inv],
                                            [s.b[j] for s in srcs])):
                outs[c].append(col.reshape(
                    tuple(idx.b[j].shape) + tuple(col.shape[1:])))
        return [Blocks(o) for o in outs]

    def scatter(self, dsts, idx: Blocks, vals, op: str = "put"
                ) -> list[Blocks]:
        """New blocks of each 1-D dsts[c] with vals[c] (a Blocks of
        idx's shape, or one Python scalar for every write) written at
        the global row ids idx by `op`: "put", "add" or "amin". Ids
        outside the rows write nothing. Every op is order-free or, for
        "put", must write one value per row (or the same value)."""
        dsts = list(dsts)
        block = dsts[0].b[0].shape[0]
        out = [[] for _ in dsts]
        if self.mesh is None:
            flat = idx.b[0].reshape(-1)
            tgt = torch.where((flat >= 0) & (flat < block), flat, block)
            for c, (d, v) in enumerate(zip(dsts, vals)):
                base = d.b[0]
                pad = torch.cat([base, base.new_zeros(1)])
                v = v.b[0].reshape(-1) if isinstance(v, Blocks) else v
                out[c].append(_apply(pad, tgt, v, op)[:block])
            return [Blocks(o) for o in out]
        tensors = [c for c, v in enumerate(vals) if isinstance(v, Blocks)]
        plans, bins = [], []
        for t in idx.b:
            flat = t.reshape(-1)
            owner = self._owners(flat, block)
            bins.append(self._bins(owner))
            plans.append((flat, owner, torch.argsort(owner, stable=True)))
        splits = [c[: self.n] for c in self._counts(bins)]
        sends = []
        for j, ((flat, owner, order), split) in enumerate(zip(plans,
                                                              splits)):
            order = order[: sum(split)]  # ids outside the rows go last
            cols = [flat[order] - owner[order] * block] + [
                vals[c].b[j].reshape(-1)[order] for c in tensors]
            sends.append(_pack(cols, order.shape[0]))
        recv, _ = self.mesh.all_to_all_v(sends, splits)
        self.exchanges += 1
        self._account(splits, sends[0].shape[1])
        for j, r in enumerate(recv):
            cols = _unpack(r, [r[:, 0]] + [
                vals[c].b[j].reshape(-1) for c in tensors])
            loc, got = cols[0], dict(zip(tensors, cols[1:]))
            for c, d in enumerate(dsts):
                v = got.get(c, vals[c])
                out[c].append(_apply(d.b[j].clone(), loc, v, op))
        return [Blocks(o) for o in out]


def _apply(t: torch.Tensor, rows: torch.Tensor, v, op: str):
    """t with v written at rows by op, in place."""
    if op == "put":
        t[rows] = v.to(t.dtype) if isinstance(v, torch.Tensor) else v
        return t
    if not isinstance(v, torch.Tensor):
        v = torch.full(rows.shape, v, dtype=t.dtype, device=t.device)
    if op == "add":
        return t.index_add_(0, rows, v.to(t.dtype))
    if op == "amin":
        return t.scatter_reduce_(0, rows, v.to(t.dtype), reduce="amin")
    raise ValueError(f"unknown scatter op {op!r}")
