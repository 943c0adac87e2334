"""The torch device of an entry point.

Every public entry point takes `device` and runs on "cuda" unless the
caller asks for "cpu". A request for "cuda" with no visible GPU raises
here, so nothing carries on on the CPU in its place.
"""

from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    """The torch device named by `name` (a string or a torch.device):
    "cuda" needs a visible GPU; "cpu" is taken only when asked for."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu (or "
            'device="cpu") to run on the CPU')
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


def graph_on_card(device) -> bool:
    """Where a graph's passes run, decided by the graph's device alone.

    On a CUDA card: whole-graph torch passes (tip removal, simple-path
    links and ranks, the contig walk), the device cleaning engine
    (graph/assemble_device.py) and the device-resident contig-union
    build (sdbg.build_sdbg_device_resident). On the CPU: the host
    engine (graph/cleaning.py) over the native cores (native/), and the
    union as window_edge_multiset + one finalize. Tests patch this one
    name to run the card's route on CPU tensors."""
    return torch.device(device).type == "cuda"
