"""One run of one cell: set-up, the measured window of whole assemblies
back to back, the check against the reference, and the result.

Everything a cell needs is found by name: the cell's entry in
BENCHMARK.json names its configuration (its file under configs/) and
its traffic (traffic/<name>.json); each per-layer metric is read by
metrics/<name>.py.

The program is megahit_tpu_torch, driven in process through
`Pipeline(opt).run()` with the options `python -m megahit_tpu_torch`
would build from the same flags.
"""

from __future__ import annotations

import importlib.util
import json
import logging
import os
import shutil
import sys
import tempfile
import time
import traceback
from contextlib import nullcontext
from types import SimpleNamespace

import check
from traffic import community

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the warm job's genome lengths, a share of the window's: it runs every
# stage and rung the window's jobs run, in a quarter of their time
WARM_SCALE = 0.25
# the contig files a rung writes (intermediate_contigs/k{K}.<name>.fa)
RUNG_CONTIGS = ("contigs", "final.contigs", "addi", "bubble_seq", "local")
# top-level module names that no run may hold (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "megahit_tpu")


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str, bench: dict | None = None) -> SimpleNamespace:
    """The cell `name` of BENCHMARK.json with its configuration, traffic
    and the metrics it reports."""
    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = by_name[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return SimpleNamespace(
        name=name, chips=w["chips"],
        config=load_json(os.path.join(ROOT, cfg["file"])),
        traffic=load_json(os.path.join(HERE, "traffic",
                                       w["traffic"] + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)])


def sample_args(config: dict, traffic: dict, scale: float = 1.0) -> dict:
    """The generator's arguments: the configuration's community, its
    genome lengths scaled by the traffic's genome_scale (and `scale`)."""
    args = {k: config[k] for k in community.DEFAULTS if k in config}
    scale *= traffic.get("genome_scale", 1)
    args["min_bp"] = int(args["min_bp"] * scale)
    args["max_bp"] = int(args["max_bp"] * scale)
    args["shape_seed"] = config.get("shape_seed")
    return args


def load_reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def io_bytes() -> dict:
    """This process's I/O counters (/proc/self/io), where the kernel
    has them."""
    try:
        with open("/proc/self/io") as fh:
            return {k: int(v) for k, v in
                    (line.split(": ") for line in fh if ": " in line)}
    except OSError:
        return {}


class SpanLog(logging.Handler):
    """The program's spans with their ends, for the idle gaps' labels:
    PhaseTimer logs "phase <name>: <seconds>" at each span's end. A
    traced run fails where a span a job returned matches no such record
    (`check_spans`)."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.spans: list[tuple[str, int, int]] = []

    def emit(self, record):
        if record.msg == "phase %s: %.3fs" and len(record.args) == 2:
            name, dt = record.args
            end = int(record.created * 1e9)
            self.spans.append((name, end - int(dt * 1e9), end))

    def check_spans(self, jobs: list[dict]) -> None:
        """Every span name a job returned was seen in the log."""
        missing = {n for j in jobs for n in j["spans"]} \
            - {n for n, _, _ in self.spans}
        if missing:
            raise RuntimeError(
                f"spans {sorted(missing)} not matched in the log: "
                "PhaseTimer's record has changed")


def run_job(argv: list[str], out: str, keep: str, span_log: SpanLog,
            device: str) -> dict:
    """One whole assembly into `out`, as `python -m megahit_tpu_torch`
    with the same flags would run it; its k_min graph, its contigs and
    every rung's files (`keep_rungs`) are moved to `keep` and `out`
    deleted. Returns {"wall", "spans", "graph", "contigs", "rungs"}."""
    import torch
    from megahit_tpu_torch.__main__ import make_parser, options_from_args
    from megahit_tpu_torch.pipeline.driver import Pipeline
    from megahit_tpu_torch.utils.log import get_logger, setup_logging

    opt = options_from_args(make_parser().parse_args(
        argv + ["-o", out, "--device", device, "--keep-tmp-files"]))
    opt.validate()
    os.makedirs(out)
    # the CLI's logging (a DEBUG log file in the output directory),
    # without its console handler
    setup_logging(os.path.join(out, "log"))
    log = get_logger()
    for h in list(log.handlers):
        if type(h) is logging.StreamHandler:
            log.removeHandler(h)
    log.addHandler(span_log)
    t0 = time.monotonic()
    try:
        spans = Pipeline(opt).run()
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        for h in list(log.handlers):
            log.removeHandler(h)
            if h is not span_log:
                h.close()
    k = opt.k_min
    contigs = os.path.join(out, "final.contigs.fa")
    os.makedirs(keep)
    rungs = keep_rungs(out, opt.k_list, keep)
    graph = rungs.get(k, {}).get("edges")
    if graph is None or not os.path.exists(contigs):
        raise RuntimeError(f"job wrote no k={k} graph or no contigs")
    kept = os.path.join(keep, "final.contigs.fa")
    os.replace(contigs, kept)
    shutil.rmtree(out)
    return {"wall": wall, "spans": spans, "graph": graph, "contigs": kept,
            "rungs": rungs}


def keep_rungs(out: str, k_list: list[int], keep: str) -> dict:
    """Moves every rung's files of the job in `out` to `keep`: its edge
    file (tmp/k{K}/k{K}.edges.npz, or .sdbg.npz where built out of
    core) and its contig files (intermediate_contigs/k{K}.<name>.fa).
    `k_list` is the ladder the job ran (options after auto_k). A rung
    ran where it wrote contigs; the first that did not is where early
    termination stopped the ladder, and keeps only the edges that
    iterate wrote for it. Returns {K: {name: path}} in k order, name
    "edges" or one of RUNG_CONTIGS."""
    rungs = {}
    for k in k_list:
        files = {}
        tmp = os.path.join(out, "tmp", f"k{k}", f"k{k}")
        edges = next((tmp + ext for ext in (".edges.npz", ".sdbg.npz")
                      if os.path.exists(tmp + ext)), None)
        if edges is not None:
            files["edges"] = edges
        prefix = os.path.join(out, "intermediate_contigs", f"k{k}.")
        for name in RUNG_CONTIGS:
            if os.path.exists(prefix + name + ".fa"):
                files[name] = prefix + name + ".fa"
        if files:
            rungs[k] = {name: _move(path, keep)
                        for name, path in files.items()}
        if "contigs" not in files:
            break
    return rungs


def _move(path: str, keep: str) -> str:
    kept = os.path.join(keep, os.path.basename(path))
    os.replace(path, kept)
    return kept


def run_cell(cell: SimpleNamespace, seed: int, seconds: float, trace: bool,
             device: str, t_start: float) -> dict:
    """One run of `cell`: returns the result line's dict (with
    "checks" last). t_start: the process's start (time.monotonic)."""
    work = tempfile.mkdtemp(prefix="megahit-bench-")
    try:
        return _run(cell, seed, seconds, trace, device, t_start, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(cell, seed, seconds, trace, device, t_start, work):
    import torch

    cuda = device == "cuda"

    # the host's thread pools: the program's (-t) and torch's
    threads = cell.config["threads"]
    torch.set_num_threads(threads)

    def write(name, scale=1.0):
        s = community.write_sample(
            os.path.join(work, name), seed,
            **sample_args(cell.config, cell.traffic, scale))
        argv = (cell.config["flags"] + cell.traffic.get("flags", [])
                + ["-t", str(threads), "-1", s["path1"], "-2", s["path2"]])
        return s, argv

    span_log = SpanLog()
    n = 0

    def job(argv):
        nonlocal n
        n += 1
        return run_job(argv, os.path.join(work, f"out{n}"),
                       os.path.join(work, f"keep{n}"), span_log, device)

    # set-up: one warm job on a smaller sample of the same community
    # builds every kernel and library and runs every stage and rung
    _, warm_argv = write("warm", WARM_SCALE)
    warm = job(warm_argv)
    shutil.rmtree(os.path.dirname(warm["contigs"]))
    sample, argv = write("sample")
    bases = 2 * sample["r1"].size
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.monotonic() - t_start
    span_log.spans.clear()

    # the window: jobs back to back; a job starts while less than
    # `seconds` has passed, and the last one is waited for
    jobs, failed = [], 0
    recorder = None
    if trace:
        from devtrace import DeviceTrace, LaunchRecorder
        from megahit_tpu_torch.core import kernels

        recorder = LaunchRecorder(kernels)
    with (DeviceTrace() if trace and cuda else nullcontext()) as dtrace, \
            (recorder or nullcontext()):
        t0 = time.monotonic()
        while True:
            try:
                jobs.append(job(argv))
            except Exception:
                failed += 1
                traceback.print_exc()
            if time.monotonic() - t0 >= seconds:
                break
        window_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules that no run may load: {found}")
    reduced = None
    if trace:
        span_log.check_spans(jobs)
    if trace and cuda:
        reduced = dtrace.reduce(span_log.spans)
    if reduced is not None or recorder is not None:
        reduced = reduced or {}
        reduced["calls"] = recorder.calls
        reduced["launches"] = recorder.launches
    if cuda:
        torch.cuda.empty_cache()

    for i, j in enumerate(jobs):
        stages = ", ".join(f"{k} {v:.3f}" for k, v in j["spans"].items()
                           if k.startswith("stage_"))
        print(f"job {i}: {j['wall']:.3f} s ({stages})", file=sys.stderr)
    print(f"sample: {bases} read bases, {len(sample['genomes'])} genomes, "
          f"{sum(map(len, sample['genomes']))} bp of genome; window "
          f"{window_s:.3f} s, {len(jobs)} jobs done, {failed} failed",
          file=sys.stderr)

    t_ref = time.monotonic()
    checks = check.judge_jobs(sample, cell.config, cell.traffic["checks"],
                              jobs, failed, seed)
    print(f"reference and check: {time.monotonic() - t_ref:.3f} s",
          file=sys.stderr)

    view = SimpleNamespace(jobs=jobs, trace=reduced, bases=bases,
                           window_s=window_s)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = load_reader(m["name"])(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {
            "read_bases_per_s": bases * len(jobs) / window_s,
            "peak_device_gib": peak / 2 ** 30,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": check.passed(checks),
              "attempted": len(jobs) + failed, "failed": failed,
              "metrics": metrics, "device": dev}
    if reduced is not None and "busy_s" in reduced:
        dev["busy_s"] = reduced["busy_s"]
        dev["window_s"] = reduced["window_s"]
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    result["checks"] = checks
    return result
