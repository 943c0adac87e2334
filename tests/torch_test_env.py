"""Shared set-up and helpers of the port's test files
(tests/test_torch_*.py).

Each test_torch_*.py imports this module first. The test run puts
several xdist workers on one host, and JAX tests (megahit_tpu's mesh
tests rendezvous 8 virtual CPU devices in XLA collectives) can share a
worker with the port's tests. torch's intra-op pool defaults to one
thread per core in every worker; capping it keeps the port's tests from
oversubscribing the cores that those collectives wait on.
"""

import os

import numpy as np
import torch

TORCH_THREADS = 2

torch.set_num_threads(TORCH_THREADS)


def assert_same_files(a, b) -> list[str]:
    """Every file of directory a equals its namesake in b, and the names
    agree: .npz files array by array (names, dtypes, shapes, values; the
    zip members carry timestamps, so their bytes differ), any other file
    byte for byte. Returns the names."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".npz"):
            za, zb = np.load(pa), np.load(pb)
            assert sorted(za.files) == sorted(zb.files), name
            for f in za.files:
                assert za[f].dtype == zb[f].dtype, (name, f)
                np.testing.assert_array_equal(za[f], zb[f], f"{name}:{f}")
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), name
    return names
