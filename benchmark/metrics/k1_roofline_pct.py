"""k1_roofline_pct: kernel 1 (canon_kernel, canonical_all_kmers) as a
percent of its byte bound over the window's launches."""

from metrics.kernel_bytes import k1_bytes, roofline_pct


def read(run):
    return roofline_pct(run, "canonical_all_kmers", "canon_kernel",
                        k1_bytes)
