"""The port's mesh across two processes: torch.distributed on gloo, one
CPU shard a rank.

The ports of tests/test_multiprocess.py's two tests. Each child process
runs init_distributed(coordinator, 2, rank, device="cpu") with one
torch thread, on a free localhost port of its own (not megahit_tpu's
fixed ones: xdist runs the files side by side), under a timeout of 120 s.
The sharded counter and sorter must give every rank the single-process
results (and megahit_tpu's count, and np.lexsort); the full pipeline with --mesh on both ranks must write
final.contigs.fa byte-identical to the port's single-process run and to
megahit_tpu's."""

import os
import socket
import subprocess
import sys

import numpy as np

from megahit_tpu.core import packing

import torch_test_env  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 120

PREAMBLE = r"""
import os, sys
import torch
torch.set_num_threads(1)
port, rank, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
from megahit_tpu_torch.parallel.multihost import (
    global_shard_mesh, init_distributed,
)
init_distributed(coordinator=f"localhost:{port}", num_processes=2,
                 process_id=rank, device="cpu")
mesh = global_shard_mesh("cpu")
assert (mesh.size, mesh.local, mesh.transport) == (2, [rank], "gloo")
"""

WORKER = PREAMBLE + r"""
import numpy as np
from megahit_tpu_torch.core import packing
from megahit_tpu_torch.parallel import shuffle

factors = []
make = shuffle.make_sharded_counter
def counting(mesh, k1, capacity_factor=2.0):
    factors.append(capacity_factor)
    return make(mesh, k1, capacity_factor)
shuffle.make_sharded_counter = counting

rng = np.random.default_rng(11)
reads = [rng.integers(0, 4, size=90).astype(np.uint8) for _ in range(48)]
flat, starts = packing.pack_many(reads)
keys, counts = shuffle.sharded_count_kmers(flat, starts, 22, 1, mesh)
skeys = rng.integers(0, 2**32, (1001, 2)).astype(np.uint32)
sorted_keys = shuffle.sharded_sort_kmers(skeys, mesh)
# one repeated 24-bp read: every row goes to at most 3 owners (at two
# shards the 2x capacity is a whole shard, so it fits without a retry)
rep = [reads[0][:24].copy() for _ in range(64)]
rflat, rstarts = packing.pack_many(rep)
rkeys, rcounts, rrare = shuffle.sharded_count_kmers(
    rflat, rstarts, 22, 2, mesh, return_rare=True)
np.savez(os.path.join(outdir, f"result{rank}.npz"), keys=keys,
         counts=counts, sorted_keys=sorted_keys, rkeys=rkeys,
         rcounts=rcounts, rrare=rrare, factors=np.array(factors))
torch.distributed.destroy_process_group()
print("WORKER_DONE", rank, flush=True)
"""

PIPELINE_WORKER = PREAMBLE + r"""
from megahit_tpu_torch.__main__ import main
reads1, reads2 = sys.argv[4], sys.argv[5]
rc = main(["-1", reads1, "-2", reads2, "-o",
           os.path.join(outdir, f"p{rank}"), "--k-list", "21,41",
           "--no-local", "--mesh", "--device", "cpu"])
assert rc == 0
torch.distributed.destroy_process_group()
print("WORKER_DONE", rank, flush=True)
"""


ENV_WORKER = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
rank = int(sys.argv[2])
os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=sys.argv[1],
                  RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2")
from megahit_tpu_torch.parallel.multihost import (
    global_shard_mesh, init_distributed,
)
from megahit_tpu_torch.parallel.shuffle import sharded_sort_kmers
init_distributed(device="cpu")  # from torchrun's environment
mesh = global_shard_mesh("cpu")
assert (mesh.size, mesh.local, mesh.transport) == (2, [rank], "gloo")
keys = np.random.default_rng(5).integers(0, 2**32, (999, 3)).astype(
    np.uint32)
got = sharded_sort_kmers(keys, mesh)
assert np.array_equal(got, keys[np.lexsort(keys.T[::-1])])
torch.distributed.destroy_process_group()
print("WORKER_DONE", rank, flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(tmp_path, source: str, *args: str, **env_extra) -> None:
    script = tmp_path / "worker.py"
    script.write_text(source)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               **env_extra)
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(script), port, str(rank), str(tmp_path),
         *args], env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
        assert f"WORKER_DONE {rank}" in out


def test_two_process_mesh_counter_and_sorter(tmp_path):
    from megahit_tpu.graph import counter as jcounter
    from megahit_tpu_torch.parallel import shuffle
    from megahit_tpu_torch.parallel.multihost import Mesh

    _run_ranks(tmp_path, WORKER)
    z0, z1 = (np.load(tmp_path / f"result{r}.npz") for r in range(2))
    for f in z0.files:
        np.testing.assert_array_equal(z0[f], z1[f], f)
    np.testing.assert_array_equal(z0["factors"], [2.0, 2.0])

    rng = np.random.default_rng(11)
    reads = [rng.integers(0, 4, size=90).astype(np.uint8)
             for _ in range(48)]
    flat, starts = packing.pack_many(reads)
    want = jcounter.count_canonical_kmers(flat, starts, 22, min_count=1)
    single = shuffle.sharded_count_kmers(flat, starts, 22, 1,
                                         Mesh(["cpu"] * 2))
    for got, s, w in zip((z0["keys"], z0["counts"]), single, want):
        np.testing.assert_array_equal(got, s)
        np.testing.assert_array_equal(got, w)
    skeys = rng.integers(0, 2**32, (1001, 2)).astype(np.uint32)
    np.testing.assert_array_equal(z0["sorted_keys"],
                                  skeys[np.lexsort(skeys.T[::-1])])
    rep = [reads[0][:24].copy() for _ in range(64)]
    rflat, rstarts = packing.pack_many(rep)
    want = jcounter.count_canonical_kmers(rflat, rstarts, 22, 2,
                                          return_rare=True)
    for f, w in zip(("rkeys", "rcounts", "rrare"), want):
        np.testing.assert_array_equal(z0[f], w, f)


def test_two_process_from_torchrun_environment(tmp_path):
    """init_distributed with no arguments starts the group from
    torchrun's variables (MASTER_ADDR/PORT, RANK, WORLD_SIZE)."""
    _run_ranks(tmp_path, ENV_WORKER)


def _write_pairs(tmp_path):
    """tests/test_multiprocess.py's pairs (12 kbp genome, 2x100 bp every
    9 bp), with a 30-bp repeat and 1% substitutions so that the k=21
    graph breaks and the k=41 rung runs."""
    rng = np.random.default_rng(31)
    genome = rng.integers(0, 4, size=12_000).astype(np.uint8)
    genome[8000:8030] = genome[3000:3030]
    r1, r2 = tmp_path / "r1.fa", tmp_path / "r2.fa"
    with open(r1, "w") as f1, open(r2, "w") as f2:
        for i, s in enumerate(range(0, len(genome) - 300, 9)):
            frag = genome[s:s + 300].copy()
            m = rng.random(300) < 0.01
            frag[m] = (frag[m] + rng.integers(1, 4, int(m.sum()))) % 4
            mate = packing.revcomp_codes(frag[200:])
            f1.write(f">a{i}\n{packing.decode(frag[:100])}\n")
            f2.write(f">b{i}\n{packing.decode(mate)}\n")
    return str(r1), str(r2)


def test_two_process_full_pipeline(tmp_path):
    """The full pipeline with --mesh across two gloo ranks (the count,
    the k=41 build's round sorts and the cleaning state sharded): both
    ranks' final.contigs.fa byte-identical to the port's single-process
    run (no mesh) and to megahit_tpu's."""
    from megahit_tpu.__main__ import main as jax_main
    from megahit_tpu_torch.__main__ import main as torch_main

    r1, r2 = _write_pairs(tmp_path)
    # the device cleaning engine on CPU tensors, so that its state
    # shards over the two ranks (a CPU graph otherwise cleans on the
    # host engine)
    _run_ranks(tmp_path, PIPELINE_WORKER, r1, r2,
               MEGAHIT_TPU_TORCH_DEVICE_CLEAN="1")
    base = ["-1", r1, "-2", r2, "--k-list", "21,41", "--no-local"]
    assert torch_main(base + ["-o", str(tmp_path / "ref"),
                              "--device", "cpu"]) == 0
    assert jax_main(base + ["-o", str(tmp_path / "jax"),
                            "--platform", "cpu"]) == 0
    ref = (tmp_path / "ref" / "final.contigs.fa").read_bytes()
    assert len(ref) > 1000
    assert (tmp_path / "jax" / "final.contigs.fa").read_bytes() == ref
    for rank in range(2):
        out = tmp_path / f"p{rank}"
        assert (out / "final.contigs.fa").read_bytes() == ref, rank
        log = (out / "log").read_text()
        assert "mesh counting over 2 devices (gloo)" in log
        assert "stage_assemble 41" in log
        assert "k=41: ~" in log  # the k=41 build took the bucketed route
        assert "2-device mesh" in log  # the sharded cleaning state
