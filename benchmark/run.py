"""The benchmark of megahit_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout on a machine with the cards the cell
asks for (BENCHMARK.json). Set-up (imports, the kernels' and native
libraries' first build, the seed's sample, one warm job) is timed as
setup_s; then whole assemblies of the sample run back to back for S
seconds; then one job, drawn from the seed, is judged against the plain
reference. Standard error gets the jobs' walls, the sample, the bytes
the run wrote and, last, each number compared with its limit; the last
line of standard output is the result (JSON). With --trace 1 the
window runs under torch.profiler and the result holds the per-layer
metrics. Exits 2 without the cards.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)

    # the program builds its kernels and native libraries into its own
    # megahit_tpu_torch/_build/, inside the checkout
    sys.path.insert(0, ROOT)

    import harness

    cell = harness.load_cell(args.workload)
    io0 = harness.io_bytes()
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    io1 = harness.io_bytes()
    print("run wrote "
          + ", ".join(f"{k} {io1[k] - io0.get(k, 0)}"
                      for k in ("wchar", "write_bytes") if k in io1),
          file=sys.stderr)
    # the readers and the reference ran after the window: look again
    found = harness.forbidden_modules()
    if found:
        print(f"modules that no run may load: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
