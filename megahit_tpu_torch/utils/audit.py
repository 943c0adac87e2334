"""Tensor-size audit: the largest tensor any torch op creates.

``SizeAudit`` is a ``TorchDispatchMode`` that records the element count
of every tensor an op returns (views included: a view is never larger
than its base). Around a sharded pass it shows whether any shard built
a tensor of the whole graph's rows: compare its ``largest`` with the
same pass's on the unsharded engine. Dispatch modes are per thread, and
ops run while the mode is active are slower; it is a check, not a
meter.

    with SizeAudit() as audit:
        engine.remove_tips(40)
    print(audit.largest, audit.op)
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class SizeAudit(TorchDispatchMode):
    """Records the largest tensor (by element count) that an op run
    under it returns, and the op that returned it."""

    def __init__(self):
        super().__init__()
        self.largest = 0
        self.op = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.numel() > self.largest:
                self.largest = t.numel()
                self.op = str(func)
        return out
