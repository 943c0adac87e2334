"""k2_roofline_pct: kernel 2 (count_runs_kernel, count_sorted_runs) as
a percent of its byte bound over the window's launches (the kernel's
own device time; its scratch memset is not counted)."""

from metrics.kernel_bytes import k2_bytes, roofline_pct


def read(run):
    return roofline_pct(run, "count_sorted_runs", "count_runs_kernel",
                        k2_bytes)
