"""The control's and the faults' readings at a cell's own size, each
judged as a run's judged job is judged (check.py), beside a sound job.

    python3 benchmark/control.py --workload NAME --seeds 1 2 3

For each seed: the control (the reference put in the program's place,
with the configuration's control settings: its stated guarantee
broken), and one job of the program (on the card when there is one) for
the sound run and for each fault: the program run with a step left out
(FLAG_FAULTS), half the reads left out, and the sound job's answer
altered where it is written (ANSWER_FAULTS). Prints each reading beside
its limit; exits 1 if the control or a fault (but those in UNCAUGHT)
comes out correct.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import check  # noqa: E402
import harness  # noqa: E402
import judge  # noqa: E402
from traffic import community  # noqa: E402

# the program's own options that leave a step of cleaning out
FLAG_FAULTS = {
    "bubbles_kept": ["--bubble-level", "0"],
    "tips_kept": ["--max-tip-len", "2"],
}
# faults that are read but that no number of the cell catches: tips_kept
# reads 3 to 10 uncleaned_ends, sound runs up to 2, so no limit parts them
# by the factor of three (PERF.md); a cell without uncleaned_ends (the
# ladder's) catches neither cleaning fault
UNCAUGHT = {"tips_kept"}


def uncaught(limits: dict) -> set:
    """The faults that the cell's numbers (`limits`) are not held to
    catch."""
    return UNCAUGHT if "uncleaned_ends" in limits else \
        UNCAUGHT | set(FLAG_FAULTS)


def _write_contigs(path: str, records) -> None:
    with open(path, "w") as fh:
        for h, c in records:
            fh.write(f">{h}\n{''.join('ACGT'[b] for b in c)}\n")


def base_altered(records):
    """The middle base of the longest contig changed."""
    records = [(h, c.copy()) for h, c in records]
    _, c = max(records, key=lambda r: len(r[1]))
    c[len(c) // 2] = (c[len(c) // 2] + 1) % 4
    return records


def half_contigs(records):
    """Every other contig, longest first, left out."""
    return sorted(records, key=lambda r: -len(r[1]))[1::2]


ANSWER_FAULTS = {"base_altered": base_altered, "half_contigs": half_contigs}


def half_reads(sample: dict, outdir: str) -> list[str]:
    """The first half of each read file."""
    os.makedirs(outdir)
    paths = []
    for p in (sample["path1"], sample["path2"]):
        with open(p) as fh:
            lines = fh.readlines()
        q = os.path.join(outdir, os.path.basename(p))
        with open(q, "w") as fh:
            fh.writelines(lines[: len(lines) // 4 * 2])
        paths.append(q)
    return paths


def readings(cell, seed: int, device: str, work: str) -> dict:
    """{what: checks} for the sound job, the control and each fault."""
    config, limits = cell.config, cell.traffic["checks"]
    sample = community.write_sample(
        os.path.join(work, "sample"), seed,
        **harness.sample_args(config, cell.traffic))
    reference = check.reference_graph(sample, config)
    threads = ["-t", str(config["threads"])]
    base = config["flags"] + cell.traffic.get("flags", []) + threads
    reads = ["-1", sample["path1"], "-2", sample["path2"]]
    h1, h2 = half_reads(sample, os.path.join(work, "half"))
    runs = {"sound": base + reads, "half_reads": base + ["-1", h1, "-2", h2]}
    runs.update({name: base + flags + reads
                 for name, flags in FLAG_FAULTS.items()})
    out, jobs = {}, {}
    for name, argv in runs.items():
        jobs[name] = harness.run_job(
            argv, os.path.join(work, "out_" + name),
            os.path.join(work, "keep_" + name), harness.SpanLog(), device)
        out[name] = check.judge_jobs(sample, config, limits, [jobs[name]],
                                     0, seed, reference)
    sound = judge.read_contigs(jobs["sound"]["contigs"])
    for name, fault in ANSWER_FAULTS.items():
        path = os.path.join(work, name + ".fa")
        _write_contigs(path, fault(sound))
        job = dict(jobs["sound"], contigs=path)
        out[name] = check.judge_jobs(sample, config, limits, [job], 0, seed,
                                     reference)
    out["control"] = {"graph_edges_differ": {
        "value": check.control_reading(sample, config, reference),
        "limit": limits["graph_edges_differ"]}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default=None,
                    help="cuda when a card is there, else cpu")
    args = ap.parse_args(argv)
    import torch

    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    cell = harness.load_cell(args.workload)
    torch.set_num_threads(cell.config["threads"])
    skip = uncaught(cell.traffic["checks"])
    ok = True
    for seed in args.seeds:
        t0 = time.monotonic()
        work = tempfile.mkdtemp(prefix="megahit-control-")
        try:
            got = readings(cell, seed, device, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        for what, checks in got.items():
            correct = check.passed(checks)
            if what not in skip:
                ok &= correct == (what == "sound")
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "device": device, "run": what,
                              "correct": correct, "checks": checks}))
        print(f"seed {seed}: {time.monotonic() - t0:.1f} s", file=sys.stderr)
    found = harness.forbidden_modules()
    if found:
        print(f"modules that no run may load: {found}", file=sys.stderr)
        return 3
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
