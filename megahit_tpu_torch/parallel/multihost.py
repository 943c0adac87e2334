"""Multi-process initialisation and the shard mesh.

``jax.sharding.Mesh`` is single-controller: one process may own many
devices. The port's counterpart is the small ``Mesh`` class below: an
ordered list of shard devices on one axis, ``"shard"``, in one of two
modes.

- **One process, n local shards.** The devices may repeat
  (``["cpu"] * 8``, ``["cuda:0"] * 8``): the routing, capacity and
  splitter logic of every mesh program then runs over n virtual shards
  of one device, as the JAX tests run it over 8 virtual CPU devices.
  The collectives are tensor copies: ``all_to_all`` of the per-shard
  ``(n, cap, ...)`` send stacks transposes their first two axes,
  ``all_gather`` concatenates, ``psum`` sums. With several cards in
  one process they are per-pair ``.to(device)`` copies.
- **torch.distributed, one shard per rank** (the rank's device). The
  collectives are ``all_to_all_single``, ``all_gather_into_tensor`` and
  ``all_reduce``, on NCCL when the shard device is a card and on gloo on
  the CPU. gloo rejects ``torch.uint32``: key words travel as the port's
  int64 u32 values (core/kmerops.py).

A mesh program is SPMD: every process runs it on its own shards
(``Mesh.local``), calls the same collectives in the same order, and
takes every host decision (a retry, an assert) from a globally reduced
value.

Counterpart of megahit_tpu/parallel/multihost.py.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from ..utils.log import get_logger


class Mesh:
    """A 1-D mesh of shard devices (axis "shard").

    distributed: shard i is rank i of the default torch.distributed
    process group, and this process owns only its own shard; else this
    process owns every shard. The mesh holds no reference to the group,
    so destroy_process_group() really ends it."""

    axis_names = ("shard",)

    def __init__(self, devices, distributed: bool = False):
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        if self.size < 1:
            raise ValueError("a mesh needs at least one shard")
        self.distributed = distributed
        if not distributed:
            self.local = list(range(self.size))
        else:
            if dist.get_world_size() != self.size:
                raise ValueError(
                    f"mesh of {self.size} shards over a process group of "
                    f"{dist.get_world_size()} ranks")
            self.local = [dist.get_rank()]

    @property
    def transport(self) -> str:
        """How the collectives move data: the process group's backend,
        or in-process copies."""
        if not self.distributed:
            return "in-process copies"
        return str(dist.get_backend())

    def local_devices(self) -> list[torch.device]:
        return [self.devices[i] for i in self.local]

    # -- collectives over this process's per-shard blocks ----------------

    def all_to_all(self, sends: list[torch.Tensor]) -> list[torch.Tensor]:
        """sends[j]: local shard j's (n, ...) stack, row i bound for
        shard i. Returns, per local shard, the (n, ...) stack whose row
        i came from shard i."""
        if not self.distributed:
            return [torch.stack([sends[i][j].to(self.devices[j])
                                 for i in range(self.size)])
                    for j in range(self.size)]
        (send,) = sends
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send.contiguous())
        return [out]

    def all_gather(self, blocks: list[torch.Tensor],
                   device=None) -> torch.Tensor:
        """Every shard's equal-sized block, concatenated in shard order
        on `device` (default: this process's first shard device)."""
        device = self.devices[self.local[0]] if device is None \
            else torch.device(device)
        if not self.distributed:
            return torch.cat([b.to(device) for b in blocks])
        (b,) = blocks
        b = b.contiguous()
        out = b.new_empty((self.size * b.shape[0],) + tuple(b.shape[1:]))
        dist.all_gather_into_tensor(out, b)
        return out.to(device)

    def psum(self, values) -> int:
        """Sum of one integer per local shard over every shard."""
        total = sum(int(v) for v in values)
        if not self.distributed:
            return total
        t = torch.tensor([total], dtype=torch.int64,
                         device=self.devices[self.local[0]])
        dist.all_reduce(t)
        return int(t.item())


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device="cuda") -> None:
    """Initialise torch.distributed for a multi-process run: NCCL when
    `device` is a card (with this process's card set from LOCAL_RANK or
    its rank), gloo on the CPU. A no-op without a coordinator
    ("host:port") or torchrun's WORLD_SIZE > 1, and when a process group
    is already up. A card run never falls back to gloo: without NCCL it
    raises."""
    if dist.is_initialized():
        return
    if coordinator is None:
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return
        init_method = "env://"  # torchrun's MASTER_ADDR/PORT, RANK
    else:
        init_method = f"tcp://{coordinator}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("torch.distributed has no NCCL backend; "
                               "a card mesh needs it")
        backend = "nccl"
        rank = process_id if process_id is not None \
            else int(os.environ.get("RANK", "0"))
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    else:
        backend = "gloo"
    # -1: torchrun's environment gives them
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)
    get_logger().info(
        "distributed: process %d/%d, %s backend, 1 local / %d global "
        "devices", dist.get_rank(), dist.get_world_size(), backend,
        dist.get_world_size())


def global_shard_mesh(device="cuda") -> Mesh:
    """The mesh of every shard of this run: one per rank when a process
    group is up (its backend must suit `device`: NCCL for a card, gloo
    for the CPU), else one per visible card, or one CPU shard."""
    dev = resolve_device(device)
    if dist.is_initialized():
        backend = str(dist.get_backend())
        want = "nccl" if dev.type == "cuda" else "gloo"
        if backend != want:
            raise RuntimeError(
                f"a {dev.type} mesh needs the {want} backend; the process "
                f"group runs {backend}")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        rank, n = dist.get_rank(), dist.get_world_size()
        # only this rank's own device is ever used
        return Mesh([dev if r == rank else torch.device(dev.type)
                     for r in range(n)], distributed=True)
    if dev.type == "cuda":
        return Mesh([torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())])
    return Mesh(["cpu"])


def put_global(arr: np.ndarray, mesh: Mesh,
               replicate: bool = False) -> list[torch.Tensor]:
    """This process's shard blocks of identical host data, each on its
    shard's device: the i-th of `mesh.size` equal row blocks of `arr`
    (whose row count the mesh size divides), or, with replicate, the
    whole array. uint32 arrays arrive as int64 u32 values."""
    a = np.ascontiguousarray(arr)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    t = torch.from_numpy(a)
    if replicate:
        return [t.to(d) for d in mesh.local_devices()]
    if t.shape[0] % mesh.size:
        raise ValueError(f"{t.shape[0]} rows do not split into "
                         f"{mesh.size} shards")
    blocks = t.reshape((mesh.size, -1) + tuple(t.shape[1:]))
    return [blocks[i].to(mesh.devices[i]) for i in mesh.local]


def fetch_global(blocks: list[torch.Tensor], mesh: Mesh) -> np.ndarray:
    """Every shard's block (row counts may differ), concatenated in
    shard order as one host array."""
    if not mesh.distributed:
        return torch.cat([b.cpu() for b in blocks]).numpy()
    (b,) = blocks
    b = b.contiguous()
    n = torch.tensor([b.shape[0]], dtype=torch.int64, device=b.device)
    sizes = n.new_empty(mesh.size)
    dist.all_gather_into_tensor(sizes, n)
    sizes = sizes.tolist()
    pad = max(sizes) - b.shape[0]
    if pad:
        b = torch.cat([b, b.new_zeros((pad,) + tuple(b.shape[1:]))])
    out = b.new_empty((mesh.size * b.shape[0],) + tuple(b.shape[1:]))
    dist.all_gather_into_tensor(out, b)
    out = out.reshape((mesh.size, -1) + tuple(b.shape[1:])).cpu()
    return torch.cat([out[i, :s] for i, s in enumerate(sizes)]).numpy()
