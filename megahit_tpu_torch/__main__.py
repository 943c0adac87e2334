"""megahit_tpu_torch command line: MEGAHIT-compatible flags.

Usage mirrors the reference driver (src/megahit:38-104):
  python -m megahit_tpu_torch -1 a_1.fq -2 a_2.fq -r se.fa -o out
  python -m megahit_tpu_torch --12 interleaved.fa.gz -o out --k-list 21,41,61
  python -m megahit_tpu_torch --test --device cpu

Runs on the GPU (``--device cuda``, the default) unless ``--device cpu``
is given; without a GPU it stops with an error. ``--mesh`` shards the
count, the graph builds' sorts and the cleaning state over every visible
card of this process, or, under torchrun (WORLD_SIZE > 1) or after
``parallel.multihost.init_distributed``, over one card (or CPU) a rank;
each rank then needs its own ``-o``. Counterpart of
megahit_tpu/__main__.py.
"""

from __future__ import annotations

import argparse
import os
import sys


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="megahit_tpu_torch",
        description="GPU metagenome assembler in PyTorch/CUDA "
        "(capabilities of MEGAHIT)",
    )
    g = p.add_argument_group("input options")
    g.add_argument("-1", dest="pe1", action="append", default=[],
                   help="comma-separated fasta/q paired-end #1 files")
    g.add_argument("-2", dest="pe2", action="append", default=[],
                   help="comma-separated fasta/q paired-end #2 files")
    g.add_argument("--12", dest="pe12", action="append", default=[],
                   help="comma-separated interleaved fasta/q files")
    g.add_argument("-r", "--read", dest="se", action="append", default=[],
                   help="comma-separated single-end fasta/q files")

    o = p.add_argument_group("output options")
    o.add_argument("-o", "--out-dir", default="./megahit_out")
    o.add_argument("--out-prefix", default="")
    o.add_argument("--min-contig-len", type=int, default=200)
    o.add_argument("--keep-tmp-files", action="store_true")
    o.add_argument("--tmp-dir", default="",
                   help="set temp directory (a megahit_tmp_* dir is "
                   "created inside, reference src/megahit:461)")
    o.add_argument("-f", "--force", action="store_true",
                   help="overwrite an existing output directory")

    h = p.add_argument_group("hardware options")
    h.add_argument("-m", "--memory", type=float, default=0.9,
                   help="memory budget: fraction of RAM if <= 1, else "
                   "bytes; sizes the count batch and routes graph builds "
                   "above it out of core (reference -m)")
    h.add_argument("-t", "--num-cpu-threads", type=int, default=0,
                   help="host thread budget for CPU-bound stages "
                   "(0 = all logical CPUs)")
    h.add_argument("--mem-flag", type=int, default=1, choices=[0, 1, 2],
                   help="SdBG build memory mode: 0 minimum (more, "
                   "smaller rounds), 1 moderate, 2 use all of -m")
    h.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="torch device of the count and graph passes "
                   "(default cuda; there is no silent CPU fallback)")
    h.add_argument("--no-hw-accel", action="store_true",
                   help="reference parity alias for --device cpu")
    h.add_argument("--mesh", dest="use_mesh", action="store_true",
                   help="shard k-mer counting, graph-build sorts and the "
                   "cleaning state over the device mesh (every visible "
                   "card, or one a rank under torch.distributed: NCCL on "
                   "cuda, gloo on cpu)")

    a = p.add_argument_group("assembly options")
    a.add_argument("--presets", choices=["meta-sensitive", "meta-large"])
    a.add_argument("--k-list", default=None,
                   help="comma-separated odd k values")
    a.add_argument("--k-min", type=int, default=-1)
    a.add_argument("--k-max", type=int, default=-1)
    a.add_argument("--k-step", type=int, default=-1)
    a.add_argument("--min-count", type=int, default=2)
    a.add_argument("--no-mercy", action="store_true")
    a.add_argument("--no-local", action="store_true")
    a.add_argument("--kmin-1pass", action="store_true")
    a.add_argument("--prune-level", type=int, default=2)
    a.add_argument("--prune-depth", type=float, default=2)
    a.add_argument("--bubble-level", type=int, default=2)
    a.add_argument("--merge-level", default="20,0.95",
                   help="l,s for complex bubble merging")
    a.add_argument("--disconnect-ratio", type=float, default=0.1)
    a.add_argument("--low-local-ratio", type=float, default=0.2)
    a.add_argument("--cleaning-rounds", type=int, default=5)
    a.add_argument("--max-tip-len", type=int, default=-1)

    p.add_argument("--continue", dest="continue_mode", action="store_true",
                   help="resume from the last checkpoint in -o")
    p.add_argument("--test", dest="test_mode", action="store_true",
                   help="run on a small generated test dataset")
    p.add_argument("-v", "--version", action="store_true",
                   dest="show_version", help="print version and exit")
    p.add_argument("--verbose", action="store_true")
    # deprecated flags the reference accepts and ignores
    # (src/megahit:410-413)
    for flag, nargs in (("--cpu-only", 0), ("-l", 1),
                        ("--max-read-len", 1), ("--no-low-local", 0),
                        ("--use-gpu", 0), ("--gpu-mem", 1)):
        p.add_argument(flag, nargs=None if nargs else 0,
                       action=_Deprecated, help=argparse.SUPPRESS)
    return p


class _Deprecated(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        print(f"option {option_string} is deprecated!", file=sys.stderr)


def _split(vals: list[str]) -> list[str]:
    out: list[str] = []
    for v in vals:
        out.extend(x for x in v.split(",") if x)
    return out


def make_test_data(out_dir: str) -> dict[str, list[str]]:
    """Generate a deterministic toy dataset mirroring the reference's
    bundled test_data matrix (src/megahit:582-587, test_data/): a gz
    AND a bz2 interleaved-PE lib, a plain PE lib, an SE lib, a loop
    (circular) genome lib, and an empty lib - so one `--test` run
    exercises every input format and lib type."""
    import bz2
    import gzip

    import numpy as np

    from megahit_tpu_torch.core import packing

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(20240801)
    genome = rng.integers(0, 4, size=6000).astype(np.uint8)
    insert, rl = 300, 100

    def pairs(start_phase: int, step: int):
        for i, s in enumerate(range(start_phase,
                                    len(genome) - insert, step)):
            frag = genome[s : s + insert]
            r1 = packing.decode(frag[:rl])
            r2 = packing.decode(packing.revcomp_codes(frag[-rl:]))
            yield i, r1, r2

    # interleaved PE, one gz + one bz2 (reference r1.il.fa.gz /
    # r2.il.fa.bz2)
    il_gz = os.path.join(out_dir, "test_il1.fa.gz")
    with gzip.open(il_gz, "wt") as f:
        for i, r1, r2 in pairs(0, 6):
            f.write(f">il1_{i}/1\n{r1}\n>il1_{i}/2\n{r2}\n")
    il_bz2 = os.path.join(out_dir, "test_il2.fa.bz2")
    with bz2.open(il_bz2, "wt") as f:
        for i, r1, r2 in pairs(2, 6):
            f.write(f">il2_{i}/1\n{r1}\n>il2_{i}/2\n{r2}\n")

    # plain PE (reference r3_1.fa / r3_2.fa)
    p1 = os.path.join(out_dir, "test_r1.fa")
    p2 = os.path.join(out_dir, "test_r2.fa")
    with open(p1, "w") as f1, open(p2, "w") as f2:
        for i, r1, r2 in pairs(4, 6):
            f1.write(f">pe_{i}/1\n{r1}\n")
            f2.write(f">pe_{i}/2\n{r2}\n")

    # SE reads (reference r4.fa)
    se = os.path.join(out_dir, "test_se.fa")
    with open(se, "w") as f:
        for i, s in enumerate(range(1, len(genome) - rl, 7)):
            f.write(f">se_{i}\n"
                    f"{packing.decode(genome[s : s + rl])}\n")

    # circular genome fed as long sequences (reference loop.fa: the
    # loop genome itself, two rotations, as an SE lib)
    loop = rng.integers(0, 4, size=550).astype(np.uint8)
    loop_fa = os.path.join(out_dir, "test_loop.fa")
    doubled = np.concatenate([loop, loop])
    with open(loop_fa, "w") as f:
        f.write(f">loop_a\n{packing.decode(doubled[:700])}\n")
        f.write(f">loop_b\n{packing.decode(doubled[275:975])}\n")

    # empty lib (reference test_data/empty.fa)
    empty = os.path.join(out_dir, "test_empty.fa")
    open(empty, "w").close()

    return {
        "pe12": [il_gz, il_bz2],
        "pe1": [p1],
        "pe2": [p2],
        "se": [se, loop_fa, empty],
    }


def options_from_args(args) -> "Options":
    """The run's Options from parsed CLI arguments, before validation:
    the flags, then --k-list, then a preset, which overrides an explicit
    --k-list."""
    from megahit_tpu_torch.pipeline.options import Options

    opt = Options(
        pe1=_split(args.pe1), pe2=_split(args.pe2),
        pe12=_split(args.pe12), se=_split(args.se),
        out_dir=args.out_dir, out_prefix=args.out_prefix,
        min_contig_len=args.min_contig_len,
        min_count=args.min_count,
        no_mercy=args.no_mercy, no_local=args.no_local,
        kmin_1pass=args.kmin_1pass,
        prune_level=args.prune_level, prune_depth=args.prune_depth,
        bubble_level=args.bubble_level,
        disconnect_ratio=args.disconnect_ratio,
        low_local_ratio=args.low_local_ratio,
        cleaning_rounds=args.cleaning_rounds,
        max_tip_len=args.max_tip_len,
        keep_tmp_files=args.keep_tmp_files,
        temp_dir=args.tmp_dir, mem_flag=args.mem_flag,
        test_mode=args.test_mode,
        continue_mode=args.continue_mode,
        verbose=args.verbose,
        k_min=args.k_min, k_max=args.k_max, k_step=args.k_step,
        memory=args.memory, num_cpu_threads=args.num_cpu_threads,
        device=args.device, use_mesh=args.use_mesh,
    )
    if args.k_list:
        opt.k_list = [int(x) for x in args.k_list.split(",")]
        opt.auto_k = False
    if args.presets:
        # the reference applies presets in check_and_correct_option,
        # AFTER parsing: a preset overrides an explicit --k-list and
        # re-enables auto_k read-length pruning (src/megahit:491-505)
        opt.apply_preset(args.presets)
    ml = args.merge_level.split(",")
    opt.merge_len, opt.merge_similar = int(ml[0]), float(ml[1])
    return opt


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    if args.show_version:
        from megahit_tpu_torch import __version__

        print(f"megahit_tpu_torch v{__version__}")
        return 0

    from megahit_tpu_torch.utils.threads import set_num_threads

    set_num_threads(args.num_cpu_threads)

    from megahit_tpu_torch.utils.debug import (
        debug_enabled, enable_debug_checks,
    )

    if debug_enabled():
        enable_debug_checks()
    if args.no_hw_accel:
        args.device = "cpu"

    from megahit_tpu_torch.pipeline.driver import Pipeline, resolve_device
    from megahit_tpu_torch.pipeline.options import Options
    from megahit_tpu_torch.utils.log import setup_logging

    # fail before touching the output directory when the device is
    # missing (never carry on on the CPU instead)
    resolve_device(args.device)
    if args.use_mesh:
        from megahit_tpu_torch.parallel.multihost import init_distributed

        # torchrun's environment starts the process group (NCCL on a
        # card, or an error); a single process is a no-op
        init_distributed(device=args.device)

    if (os.path.isdir(args.out_dir)
            and os.listdir(args.out_dir)
            and not args.continue_mode and not args.force
            and not args.test_mode):
        print(
            f"megahit_tpu_torch: output directory {args.out_dir} exists; "
            "use -f to overwrite or --continue to resume",
            file=sys.stderr,
        )
        return 1
    if args.force and os.path.isdir(args.out_dir) \
            and not args.continue_mode:
        import shutil

        shutil.rmtree(args.out_dir)

    opt = options_from_args(args)

    saved = os.path.join(args.out_dir, "options.json")
    if args.continue_mode and os.path.exists(saved):
        # resume with the options the run started with (reference
        # --continue needs only -o)
        opt = Options.load(saved)
        opt.continue_mode, opt.device = True, args.device
    elif args.test_mode:
        libs = make_test_data(os.path.join(args.out_dir, "test_data"))
        opt.pe12, opt.pe1 = libs["pe12"], libs["pe1"]
        opt.pe2, opt.se = libs["pe2"], libs["se"]
        if args.k_list is None:
            opt.k_list = [21, 39, 59, 79]
            opt.auto_k = False

    os.makedirs(opt.out_dir, exist_ok=True)
    setup_logging(
        os.path.join(opt.out_dir, "log"),
        verbose=opt.verbose,
    )
    try:
        opt.validate()
        for path in opt.pe1 + opt.pe2 + opt.pe12 + opt.se:
            if not os.path.exists(path):
                raise ValueError(f"input file not found: {path}")
        Pipeline(opt).run()
    except ValueError as e:
        print(f"megahit_tpu_torch: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
