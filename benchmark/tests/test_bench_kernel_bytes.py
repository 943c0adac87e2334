"""The count kernels' byte counts: against PERF.md's kernel table and
against the sizes of the port's own operands and outputs (its plain
versions on the CPU have the kernels' shapes)."""

import torch

from metrics import kernel_bytes as kb


def test_kernel_table_numbers():
    # the isolate's pool, padded to q_padded + W words
    assert kb.k1_bytes(477_186, 22) == 62_988_296
    # the isolate's pool as the redesigned kernel 1 reads it, unpadded
    assert kb.k1_bytes(476_432, 22) == 62_985_280
    # a 2^26-base chunk of the community's count
    assert kb.k1_bytes((1 << 26) // 16 + 3, 22) == 553_910_284
    # kernel 2 over the community's 2^28 rows of 2 words
    assert kb.k2_bytes(1 << 28, 8) == 3_489_660_928


def test_bytes_equal_the_port_operands():
    from megahit_tpu_torch.core import kernels

    for p, k in ((5000, 22), (4099, 16), (3000, 41)):
        packed = torch.randint(-2 ** 31, 2 ** 31, (p,), dtype=torch.int32)
        out = kernels.canonical_all_kmers(packed, k)
        assert kb.k1_bytes(p, k) == 4 * p + out.numel() * out.element_size()
    cols = [torch.sort(torch.randint(0, 9, (777,), dtype=torch.int32))[0],
            torch.zeros(777, dtype=torch.int32)]
    head, counts = kernels.count_sorted_runs(cols, 3)
    need = sum(c.numel() * c.element_size() for c in cols) \
        + head.numel() * 1 + counts.numel() * counts.element_size()
    assert kb.k2_bytes(777, 8) == need


class _Run:
    def __init__(self, trace):
        self.trace = trace


def test_roofline_share_and_its_guard():
    t = {"kernels": {"void canon_kernel<2, 4>(...)": [1e-5, 1e-5]},
         "calls": {"canonical_all_kmers": [(5000, 22), (5000, 22)]},
         "launches": {"canonical_all_kmers": 2}}
    pct = kb.roofline_pct(_Run(t), "canonical_all_kmers", "canon_kernel",
                          kb.k1_bytes)
    want = 100 * 2 * kb.k1_bytes(5000, 22) / kb.HBM_BYTES_PER_S / 2e-5
    assert abs(pct - want) < 1e-9
    t["launches"]["canonical_all_kmers"] = 3
    try:
        kb.roofline_pct(_Run(t), "canonical_all_kmers", "canon_kernel",
                        kb.k1_bytes)
    except RuntimeError:
        pass
    else:
        raise AssertionError("a launch the profiler missed went unseen")
    assert kb.roofline_pct(_Run(None), "canonical_all_kmers",
                           "canon_kernel", kb.k1_bytes) is None
