"""Per-stage subcommands: the analogue of megahit_core's argv mux
(reference src/main.cpp:43-110 - buildlib/count/seq2sdbg/assemble/
local/iterate, plus the toolkit in megahit_tpu_torch.tools).

Each stage reads/writes explicit file artifacts, in the formats
megahit_tpu's stages write, so stages can be run, inspected and resumed
independently of the full driver, and either package can pick up the
other's files:

  python -m megahit_tpu_torch.stage_cli buildlib -1 a_1.fq -2 a_2.fq \
      -o lib.npz
  python -m megahit_tpu_torch.stage_cli count --lib lib.npz -k 21 -m 2 \
      -o k21
  python -m megahit_tpu_torch.stage_cli read2sdbg --lib lib.npz -k 21 \
      -m 2 --need-mercy -o k21.sdbg.npz   # 1-pass, out-of-core
  python -m megahit_tpu_torch.stage_cli seq2sdbg --edges k21.edges.npz \
      -k 21 --need-mercy --lib lib.npz -o k21.sdbg.npz
  python -m megahit_tpu_torch.stage_cli assemble -s k21.sdbg.npz -o k21
  python -m megahit_tpu_torch.stage_cli local -c k21.contigs.fa \
      --lib lib.npz --kmax 41 -o k21.local.fa
  python -m megahit_tpu_torch.stage_cli iterate -c k21.contigs.fa \
      -b k21.bubble_seq.fa --lib lib.npz -k 21 -s 20 -o k41

The device stages (count, read2sdbg, seq2sdbg, assemble, local,
iterate) run on the GPU unless `--device cpu` is given, before or
after the subcommand; without a GPU they stop with an error.
buildlib and the introspection commands never touch a device.
Counterpart of megahit_tpu/stage_cli.py.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .tools import K_MAX
from .utils.device import resolve_device


def cmd_buildlib(args) -> int:
    from .io.lib import build_lib

    def split(v):
        return [x for s in v for x in s.split(",") if x]

    lib = build_lib(split(args.pe1), split(args.pe2), split(args.pe12),
                    split(args.se))
    lib.save(args.output)
    print(f"{lib.num_seqs} seqs, {lib.num_bases} bases -> {args.output}")
    return 0


def cmd_count(args) -> int:
    from .graph.counter import count_canonical_kmers
    from .io.lib import SequenceLib

    dev = resolve_device(args.device)
    lib = SequenceLib.load(args.lib)
    k1 = args.kmer_k + 1
    keys, counts = count_canonical_kmers(
        lib.pool, lib.starts, k1, args.min_count, device=dev)
    np.savez(args.output + ".edges.npz", keys=keys, counts=counts)
    vals, cnts = np.unique(counts, return_counts=True)
    with open(args.output + ".counting", "w") as fh:
        for v, c in zip(vals, cnts):
            fh.write(f"{v} {c}\n")
    print(f"{len(keys)} solid ({args.kmer_k}+1)-mers -> "
          f"{args.output}.edges.npz")
    return 0


def cmd_read2sdbg(args) -> int:
    """1-pass reads -> SdBG through the out-of-core bucketed builder
    (reference read2sdbg = S1 solidity count + S2 graph emission,
    main_sdbg_build.cpp:88-156): the window multiset only ever exists
    in prefix-bucketed spill files, never as one in-memory edge list."""
    import os
    import tempfile

    from .core.kmerops import words_per_kmer
    from .graph.bucketed import (BuildStats, EdgeSource, PoolSource,
                                 build_sdbg_bucketed)
    from .graph.mercy import find_mercy_edges
    from .io.lib import SequenceLib

    dev = resolve_device(args.device)
    lib = SequenceLib.load(args.lib)
    k1 = args.kmer_k + 1
    w = words_per_kmer(k1)
    budget_rows = max(1 << 16, int(args.memory) // (12 * (w + 1)))
    stats = BuildStats()
    with tempfile.TemporaryDirectory(prefix="read2sdbg_") as tmp:
        sdbg = build_sdbg_bucketed(
            [PoolSource(lib.pool, lib.starts,
                        np.ones(lib.num_seqs, np.int32))],
            k1, budget_rows, os.path.join(tmp, "spill"),
            stats=stats, mult_mode="count", min_count=args.min_count,
            device=dev,
        )
    if args.need_mercy:
        idx = np.arange(sdbg.size, dtype=np.int64)
        canon = sdbg.valid & (idx <= sdbg.rc)
        keys, counts = sdbg.keys[canon], sdbg.mult[canon]
        mercy = find_mercy_edges(lib.pool, lib.starts, keys, k1,
                                 device=dev)
        if len(mercy):
            keys = np.concatenate([keys, mercy])
            counts = np.concatenate(
                [counts, np.ones(len(mercy), np.int32)])
            # re-finalize through the bucketed builder too, honoring
            # the same --memory budget (reference S2 mercy merge,
            # read_to_sdbg_s2.cpp:122-268)
            del sdbg
            with tempfile.TemporaryDirectory(prefix="read2sdbg_") as tmp:
                sdbg = build_sdbg_bucketed(
                    [EdgeSource(keys, counts)], k1, budget_rows,
                    os.path.join(tmp, "spill"), mult_mode="max",
                    device=dev,
                )
    sdbg.save(args.output)
    print(f"sdbg k={k1} ({sdbg.num_valid()} edges, "
          f"{stats.n_rounds} rounds) -> {args.output}")
    return 0


def cmd_seq2sdbg(args) -> int:
    """Edge files and/or contig files -> SdBG. The contig windows and
    the edges are unioned before one finalize (sdbg.build_sdbg_union,
    as in the driver)."""
    from .core import packing
    from .graph.mercy import find_mercy_edges
    from .graph.sdbg import build_sdbg_union, sdbg_from_edges
    from .io.contig_io import read_contigs
    from .io.lib import SequenceLib

    dev = resolve_device(args.device)
    km = args.kmer_k + 1
    edge_keys = edge_counts = None
    if args.edges:
        z = np.load(args.edges)
        edge_keys, edge_counts = z["keys"], z["counts"]
        if args.need_mercy:
            if not args.lib:
                print("--need-mercy requires --lib", file=sys.stderr)
                return 1
            lib = SequenceLib.load(args.lib)
            mercy = find_mercy_edges(
                lib.pool, lib.starts, edge_keys, km, device=dev)
            if len(mercy):
                edge_keys = np.concatenate([edge_keys, mercy])
                edge_counts = np.concatenate(
                    [edge_counts, np.ones(len(mercy), np.int32)])

    seqs, mults = [], []
    for path, extend in ((args.contig, True), (args.bubble, False),
                         (args.addi_contig, False),
                         (args.local_contig, False)):
        if not path:
            continue
        for r in read_contigs(
            path, min_len=km,
            extend_loop_k=(args.kmer_from, args.kmer_k) if extend
            else None,
        ):
            seqs.append(r.codes)
            mults.append(r.multi)

    if seqs:
        flat, starts = packing.pack_many(seqs)
        seq_mults = np.floor(np.asarray(mults) + 0.5).astype(np.int32)
        sdbg = build_sdbg_union(flat, starts, seq_mults, km, edge_keys,
                                edge_counts, dev)
    elif edge_keys is not None:
        sdbg = sdbg_from_edges(edge_keys, edge_counts, km, device=dev)
    else:
        print("no inputs (--edges/--contig/...)", file=sys.stderr)
        return 1
    sdbg.save(args.output)
    print(f"sdbg k={km} ({sdbg.num_valid()} edges) -> {args.output}")
    return 0


def cmd_assemble(args) -> int:
    from .graph.sdbg import Sdbg
    from .io.contig_io import write_contigs
    from .pipeline.assemble import AssembleOptions, assemble

    sdbg = Sdbg.load(args.sdbg, device=resolve_device(args.device))
    opt = AssembleOptions(
        min_standalone=args.min_standalone,
        prune_level=args.prune_level,
        min_depth=args.min_depth,
        max_tip_len=args.max_tip_len,
        bubble_level=args.bubble_level,
        merge_len=args.merge_len,
        merge_similar=args.merge_similar,
        cleaning_rounds=args.cleaning_rounds,
        disconnect_ratio=args.disconnect_ratio,
        low_local_ratio=args.low_local_ratio,
        is_final_round=args.is_final_round,
        careful_bubble=args.careful_bubble,
        output_standalone=args.output_standalone,
    )
    res = assemble(sdbg, opt)
    write_contigs(args.output + ".contigs.fa", res.contigs)
    write_contigs(args.output + ".final.contigs.fa", res.final_contigs)
    write_contigs(args.output + ".addi.fa", res.addi_contigs)
    write_contigs(args.output + ".bubble_seq.fa", res.bubbles)
    print(f"{len(res.contigs)} contigs -> {args.output}.contigs.fa")
    return 0


def cmd_local(args) -> int:
    from .io.contig_io import read_contigs, write_contigs
    from .io.lib import SequenceLib
    from .localasm.local_assemble import run_local_assembly

    dev = resolve_device(args.device)
    lib = SequenceLib.load(args.lib)
    contigs = read_contigs(args.contig)
    out = run_local_assembly(lib, contigs, local_kmax=args.kmax, device=dev)
    write_contigs(args.output, out)
    print(f"{len(out)} local contigs -> {args.output}")
    return 0


def cmd_iterate(args) -> int:
    from .graph.iterate import build_flank_index, find_next_kmers
    from .io.contig_io import read_contigs
    from .io.lib import SequenceLib

    dev = resolve_device(args.device)
    lib = SequenceLib.load(args.lib)
    contigs, muls = [], []
    for path in (args.contig, args.bubble):
        if path:
            for r in read_contigs(path):
                contigs.append(r.codes)
                muls.append(r.multi)
    index = build_flank_index(contigs, muls, args.kmer_k, args.step)
    keys, counts = find_next_kmers(lib.pool, lib.starts, index, device=dev)
    np.savez(args.output + ".edges.npz", keys=keys, counts=counts)
    print(f"{len(keys)} junction edges -> {args.output}.edges.npz")
    return 0


def cmd_dumpversion(args) -> int:
    """Print the package version (reference src/main.cpp:43-66
    `dumpversion`)."""
    from . import __version__

    print(__version__)
    return 0


def cmd_kmax(args) -> int:
    """Print the largest supported k (reference `kmax`)."""
    print(K_MAX)
    return 0


# the probe runs in a child that imports only torch: a broken driver
# or a hung card cannot take this process down with it
_CUDA_PROBE = (
    "import torch\n"
    "x = torch.arange(8, device='cuda')\n"
    "print(int(x.sum().item()), torch.cuda.get_device_name(0))\n"
)


def _probe_cuda(deadline: float) -> bool:
    """True iff a CUDA device initializes AND runs a kernel within the
    deadline (in a subprocess with a hard timeout)."""
    import subprocess as sp

    try:
        r = sp.run([sys.executable, "-c", _CUDA_PROBE],
                   capture_output=True, timeout=deadline, text=True)
    except sp.TimeoutExpired:
        print(f"cuda probe: timed out after {deadline}s", file=sys.stderr)
        return False
    out = r.stdout.strip().splitlines()
    ok = r.returncode == 0 and bool(out) and out[-1].startswith("28 ")
    print(f"cuda probe: rc={r.returncode} "
          f"device={out[-1][3:] if ok else '?'}", file=sys.stderr)
    return ok


def cmd_checkcpu(args) -> int:
    """Print 1 if CUDA dispatch is usable, else 0; always exit 0.

    The reference's `checkcpu` gates ONLY hardware-accel dispatch
    (src/main.cpp:43-66, src/utils/cpu_dispatch.h) - a CPU-only
    install is healthy, it just takes the portable path. Here the
    hardware acceleration is the card, so this reports only whether a
    CUDA device works; native host-core health has its own surface,
    `checknative` (a healthy CPU-only install prints checkcpu=0,
    checknative=1; a broken install prints checknative=0)."""
    from .native import native_status

    print(f"native cores: {native_status()}", file=sys.stderr)
    print(1 if _probe_cuda(args.deadline) else 0)
    return 0


def cmd_checknative(args) -> int:
    """Print 1 if every native host core builds/loads, else 0.
    Per-core detail goes to stderr."""
    from .native import native_status

    nat = native_status()
    print(f"native cores: {nat}", file=sys.stderr)
    print(1 if nat and all(nat.values()) else 0)
    return 0


def make_parser() -> argparse.ArgumentParser:
    device_help = "torch device of the stage (default cuda; there is no " \
        "silent CPU fallback)"
    p = argparse.ArgumentParser(prog="megahit_tpu_torch.stage_cli")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help=device_help)
    sub = p.add_subparsers(dest="cmd", required=True)

    def stage(name):
        # --device after the subcommand too; SUPPRESS keeps the
        # top-level value when it is not given here
        sp = sub.add_parser(name)
        sp.add_argument("--device", choices=["cuda", "cpu"],
                        default=argparse.SUPPRESS, help=device_help)
        return sp

    b = sub.add_parser("buildlib")
    b.add_argument("-1", dest="pe1", action="append", default=[])
    b.add_argument("-2", dest="pe2", action="append", default=[])
    b.add_argument("--12", dest="pe12", action="append", default=[])
    b.add_argument("-r", dest="se", action="append", default=[])
    b.add_argument("-o", "--output", required=True)
    b.set_defaults(fn=cmd_buildlib)

    c = stage("count")
    c.add_argument("--lib", required=True)
    c.add_argument("-k", dest="kmer_k", type=int, required=True)
    c.add_argument("-m", dest="min_count", type=int, default=2)
    c.add_argument("-o", "--output", required=True)
    c.set_defaults(fn=cmd_count)

    r = stage("read2sdbg")
    r.add_argument("--lib", required=True)
    r.add_argument("-k", dest="kmer_k", type=int, required=True)
    r.add_argument("-m", dest="min_count", type=int, default=2)
    r.add_argument("--memory", type=float, default=2e9,
                   help="spill budget in bytes (reference -m)")
    r.add_argument("--need-mercy", action="store_true")
    r.add_argument("-o", "--output", required=True)
    r.set_defaults(fn=cmd_read2sdbg)

    s = stage("seq2sdbg")
    s.add_argument("--edges")
    s.add_argument("--contig")
    s.add_argument("--bubble")
    s.add_argument("--addi-contig")
    s.add_argument("--local-contig")
    s.add_argument("--lib")
    s.add_argument("--need-mercy", action="store_true")
    s.add_argument("-k", dest="kmer_k", type=int, required=True)
    s.add_argument("--kmer-from", type=int, default=0)
    s.add_argument("-o", "--output", required=True)
    s.set_defaults(fn=cmd_seq2sdbg)

    a = stage("assemble")
    a.add_argument("-s", "--sdbg", required=True)
    a.add_argument("-o", "--output", required=True)
    a.add_argument("--min-standalone", type=int, default=200)
    a.add_argument("--prune-level", type=int, default=2)
    a.add_argument("--min-depth", type=float, default=-1)
    a.add_argument("--max-tip-len", type=int, default=-1)
    a.add_argument("--bubble-level", type=int, default=2)
    a.add_argument("--merge-len", type=int, default=20)
    a.add_argument("--merge-similar", type=float, default=0.95)
    a.add_argument("--cleaning-rounds", type=int, default=5)
    a.add_argument("--disconnect-ratio", type=float, default=0.1)
    a.add_argument("--low-local-ratio", type=float, default=0.2)
    a.add_argument("--is-final-round", action="store_true")
    a.add_argument("--careful-bubble", action="store_true")
    a.add_argument("--output-standalone", action="store_true")
    a.set_defaults(fn=cmd_assemble)

    lo = stage("local")
    lo.add_argument("-c", "--contig", required=True)
    lo.add_argument("--lib", required=True)
    lo.add_argument("--kmax", type=int, default=41)
    lo.add_argument("-o", "--output", required=True)
    lo.set_defaults(fn=cmd_local)

    it = stage("iterate")
    it.add_argument("-c", "--contig", required=True)
    it.add_argument("-b", "--bubble")
    it.add_argument("--lib", required=True)
    it.add_argument("-k", dest="kmer_k", type=int, required=True)
    it.add_argument("-s", "--step", type=int, required=True)
    it.add_argument("-o", "--output", required=True)
    it.set_defaults(fn=cmd_iterate)

    sub.add_parser("dumpversion").set_defaults(fn=cmd_dumpversion)
    sub.add_parser("kmax").set_defaults(fn=cmd_kmax)
    # reference mux also exposes checkpopcnt/checkbmi2 (main.cpp:43-66);
    # hardware acceleration here is the CUDA probe
    for name in ("checkcpu", "checkpopcnt", "checkbmi2"):
        cc = sub.add_parser(name)
        cc.add_argument("--deadline", type=float, default=60.0,
                        help="CUDA probe deadline (s)")
        cc.set_defaults(fn=cmd_checkcpu)
    sub.add_parser("checknative").set_defaults(fn=cmd_checknative)
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
