#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (megahit_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. the card (nvidia-smi name and power limit) and the torch/CUDA/nvcc
   versions;
2. build the CUDA kernels (one nvcc per source, in parallel) and the
   host C++ helpers from this checkout;
3. a bacterial-isolate read set: Illumina-like paired FASTQ from
   scripts/make_realistic.py (0.25 Mbp genome, 30x, seed 1; cached in
   chip_smoke_data/; cut from 2 Mbp to 1 Mbp for [14] and to 0.25 Mbp
   for [15], to keep the script inside its time limit);
4. kernel parity on the card, each kernel against its plain PyTorch
   version, exact equality: at the main path's shapes (the isolate's
   pool at k1=22), (kernel 1) at k1 in {16, 32, 42, 56, 128, 255} and
   on a ragged pool 4 B past a 16-B boundary, and (kernel 2) the main
   path's n as one run (every tile but the first headless: the longest
   look-ahead chain) and odd n with sentinel rows and one run spanning
   many tiles; with each kernel's time, byte bound and library
   yardstick, and the device work per call (torch.profiler) of kernel 1
   (one kernel launch and nothing else: no fill, no copy) and kernel 2
   (one kernel launch and at most one memset), else the phase fails; and
   the count's chunked branch against its single shot on
   the card. Then the two merge kernels (3, 4) through their path,
   sort_planes: at 2^24 keys (uniform, duplicate-heavy, ascending and
   descending, so that one run of every pair lies below the other, and
   all keys equal) and at init_run=512, max_tile=1024, n=8192 (uniform
   and duplicate-heavy), each sort_planes result against torch.sort,
   then its merge levels one at a time, each against the plain version,
   kernel 4's split search against its plain version, and at kernel 3's
   levels kernel 4 with tile = run_len too; with each kernel's launches
   per call (counters set to 0 just before the uniform 2^24 call), time
   per launch and per level (kernel 3's beside kernel 4's at its
   levels), byte bound, and per level torch.sort of the packed key's
   rows of 2 * run_len (the one call that computes a level; a kernel's
   library time is the mean over its levels); sort_planes' time beside
   torch.sort of the whole packed key, and a copy of the 2^24 planes
   (what one level moves);
5. the make_test_data fixtures on cuda and on cpu, with --k-list 21,
   with the default ladder, and with the default ladder and --no-local:
   each pair of final.contigs.fa must be byte-identical;
6. the main path: the CLI on the isolate with --k-list 21 on cuda, with
   every kernel launch counter set to 0 just before and read just
   after (each must be > 0), per-stage wall times, peak device memory,
   the device's busy time and idle share (torch.profiler, device
   activity only), and contigs checked against the genome (total within
   10%, N50 above 10 kbp);
7. the isolate again with --device cpu: its final.contigs.fa must be
   byte-identical to the cuda run's;
8. the isolate with the default k list (no --k-list) on cuda, with the
   kernel launch counters set to 0 just before and read just after
   (each must be > 0): wall time, per-stage seconds, the rungs reached,
   the device's busy time and idle share, peak device memory, and
   contigs checked against the genome (total within 10%, N50 above 10
   kbp); then the same on cpu, whose final.contigs.fa must be
   byte-identical to the cuda run's.
   In [6] and [8] every cuda rung must log "cleaning on device" and none
   "cleaning on host"; each run's assemble split (sdbg_tips,
   unitig_build, cleaning_rounds, prune_output) is printed summed over
   its rungs, cuda beside cpu;
10. (run after [11]) the cleaning engines: the isolate's k=21 graph
   (from [11]'s edge file: its solid edges and mercy) assembled on cuda by
   the card's route (device engine) and, with utils.device.graph_on_card
   patched to False, by the host route (host engine), with careful bubbles at prune level 2 and 3, final round and
   not: contigs, finals, addi, bubble records and stats must be equal;
   each engine's cleaning_rounds and prune_output seconds;
11. the out-of-core build: the isolate with --k-list 21 --kmin-1pass
   and an -m budget that splits the k=21 build into at least 4 rounds
   (rounds, seconds and each round's sort seconds printed; contig set
   equal to [6]'s; its k=21 edge file kept for [10]), and a 9 kbp
   paired read set with a 30-bp repeat and 1% errors at --k-list 21,39
   --no-local -m 1000 on cuda and cpu (byte-identical, built out of core
   at both k, contig set equal to the in-memory run's). The fixtures stop
   at k=21 under --no-local, so they cannot show the second rung.
12. the stage subcommands (stage_cli.main) on the isolate: buildlib, then
   megahit_tpu's manual chain (count -k 21 -m 2, seq2sdbg with mercy,
   assemble --careful-bubble, local --kmax 41, iterate -k 21 -s 20,
   seq2sdbg -k 41 --kmer-from 21 with the contigs and the local contigs,
   assemble --is-final-round --output-standalone) on cuda, with the
   kernel launch counters set to 0 just before the count stage and read
   just after (each must be > 0) and both assemble stages cleaning on the
   device, and the same chain on cpu: every artifact equal (.npz array by
   array, the rest byte for byte); read2sdbg --need-mercy --memory
   75000000 on cuda equal to count + seq2sdbg (valid keys and
   multiplicities); the k=21 graph (~0.5M rows) through
   save_sharded(rows_per_shard=2^18) (at least 2 shards), load_sharded
   and load_sharded_rows over two bucket ranges, equal; checkcpu and
   checknative each print 1; the fixtures
   (--k-list 21,29 --no-local) on cuda with MEGAHIT_TPU_TORCH_DEBUG=1:
   the invariant and finiteness checks run, and final.contigs.fa is
   byte-identical to the run without. Each step's seconds are printed.
13. the device mesh (megahit_tpu_torch/parallel/): the isolate's count
   (k1=22, min_count 2, with rare keys) over Mesh(["cuda:0"] * 8), eight
   virtual shards of the card, equal to count_canonical_kmers on cuda,
   with both seconds, each shard's received rows (max, mean) and no
   retry; 200,000 copies of one 24-bp read, which must take the retry
   and stay equal; the sample sort of 2^24 uniform two-word rows over
   the 8 shards, then all-equal rows, then the sorted rows (which must
   take the retry), each equal to torch.sort of the packed key, with
   both seconds; [11]'s k=21 graph assembled (careful, prune level 2)
   with the cleaning engine's state over Mesh(["cuda:0"] * 4), which it
   must take, equal to the unsharded engine (contigs, finals, addi,
   bubbles, stats); and the CLI with --mesh --k-list 21,41 --no-local
   in a child process on NCCL at world size 1 (init_distributed with a
   localhost coordinator), whose final.contigs.fa must be byte-identical
   to the same run without --mesh in this process, whose log must show
   the count over NCCL and the k=41 build on the bucketed route; both
   walls, idle shares and kernel 1 and 2 launch counts (0 under --mesh:
   the sharded count is torch ops, as megahit_tpu's mesh count reaches
   no Pallas kernel; 1 each without).
14. the 20-genome community of scripts/make_community.py --seed 42 at
   its defaults (7.13 Mbp of genome, log-uniform 2 to 80x, ~195 Mbp of
   150 bp pairs, a 1 kbp element in 6 genomes; cached in
   chip_smoke_data/): kernel 1 over one 2^26-base chunk of the count's
   chunked branch and kernel 2 over the branch's 2^28 sorted,
   sentinel-padded rows, each against its plain version bit for bit,
   with times, byte bounds, (kernel 2) torch.unique_consecutive and
   (kernel 1) its device work per call, one kernel and nothing else;
   (a) --k-list 21 on cuda, which must log the chunked count in 3 or
   more chunks and launch kernel 1 3 or more times and kernel 2 once
   or more (counters set to 0 just before, read just after), with wall,
   stages, peak device memory, idle share and the count's windows,
   padded rows, distinct and solid keys; (b) the same on cpu, whose
   final.contigs.fa must be byte-identical to (a)'s; (c) the default k
   list on cuda (launches as in (a), every rung cleaned on the device;
   rungs, wall, stages, assemble split, idle share, peak memory), whose
   contigs are held to the genomes by 32-mer recall (each genome at 10x
   or more at 0.90 or more; the contig total at most 1.1 x the genome
   total).
15. the same community under --presets meta-sensitive (min_count 1: the
   1-pass out-of-core k=21 build, no mercy), cut to its first rungs
   (--min-count 1 --k-list 21,29; phase_meta(torch, None) runs the whole
   preset): (b) the CLI on cuda in a child process (its own peak host
   memory), with the kernel counters read around it (0: the 1-pass route
   reaches no kernel, as megahit_tpu's bucketed build reaches no Pallas
   kernel), options.json equal to the preset's but for the k list, the
   log's rows spilled, rounds (rows, seconds, sort seconds), no mercy
   phase, every rung cleaned on the device, stages, assemble split, idle
   share, peak device memory, and the contigs held to the genomes as in
   [14] (c); (a) the k=21 graph that (b) kept (tmp/k21/k21.sdbg.npz)
   against count_canonical_kmers(min_count=1) on cuda (the chunked
   branch; kernel 1 3 or more launches, kernel 2 one or more, counters
   set to 0 just before and read just after) + sdbg_from_edges: every
   Sdbg array equal; and the rows spilled must be 2 x the count's
   windows.
9. (printed last) the script's total seconds and each phase's.

Not in the main run, for their time (each a chip call of its own,
README): phase_meta(torch, None), the whole preset; phase_cpu_ladders(),
[14] (c)'s and [15] (b)'s runs again on cpu, byte-identical to their
cuda runs (after _community_ladder and phase_meta in the same command);
phase_diff(flags), which bisects a cuda/cpu difference by rung;
phase_k1_turns(torch, parent), kernel 1 beside another commit's tree
in turns (parent, this, this, parent); and

16. phase_community100(torch): megahit_tpu's largest run
   (RESULTS.md:120-129) on the 100-genome community of
   scripts/make_community.py --genomes 100 --max-bp 800000 --seed 249
   (45.2 Mbp of genome, 808 Mbp of reads; cached in chip_smoke_data/;
   its genome and read totals and df of its directory printed): (b) the
   CLI with --k-list 21,41,61 --kmin-1pass at the default min_count 2
   on cuda in a child process (its own peak host memory; kernel counters
   read around it), whose log must show 2 x the reads' windows at k1 =
   22 spilled, 21 or more rounds of at most round_cap_rows() rows (each
   round's rows, seconds and sort seconds printed), a first_graph.mercy
   phase, every rung cleaned on the device (the k=21 graph's total edge
   multiplicity printed beside the device engine's 2^31 bound), and the
   contigs held to the genomes as in [14] (c); wall, stages, assemble split,
   idle share, peak memories and contig stats printed beside
   megahit_tpu's record; then (a) count_canonical_kmers(min_count=2) on
   cuda over the same reads, the chunked branch at its 2^30-row ceiling
   (kernel 1 once a chunk, 12 or more; kernel 2 once or more; peak
   device memory), whose solid keys and counts must equal the canonical
   solid rows of (b)'s tmp/k21/k21.edges.npz, and kernels 1 and 2 at
   those shapes against their plain versions, with times, byte bounds
   and unique_consecutive. phase_community100_cpu(k_list) ((c), after
   _community100_cli(torch, comm, k_list) in the same command; k_list
   "21" keeps the pair inside one call) runs (b) on cpu:
   final.contigs.fa byte-identical, k21.edges.npz equal array by array.

It then prints the card line, one JSON line with every kernel's numbers
(kernels 1, 2 with the launches of [6] and, as ladder_launches, of [8]
and, as stage_launches, of [12]'s count stage; kernels 1, 2 again at the
community's shapes, with the launches of [14] (a), as
ladder_launches, of (c) and, as meta_launches, of [15] (a)), and as its
last line
{"ok": true, "device": {...}}. Any failed phase
exits non-zero without that line. Without a GPU it exits non-zero at
once.
"""

from __future__ import annotations

import json
import logging
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "chip_smoke_data")
GENOME_BP = 250_000
COVERAGE = 30
# H100 SXM memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
# batch of the chunked count check (the isolate's pool is 4 batches)
CHUNK = 1 << 21
# -m bytes of the 1-pass run in [11]: 2.1M rows a round at k1=22, so the
# isolate's ~13M spilled rows take more than 4 rounds
ONEPASS_MEMORY = 75_000_000
# [14]: scripts/make_community.py --seed 42 at its defaults (RESULTS.md's
# 20-genome community, 195 Mbp of reads): (cache directory, generator
# arguments)
COMMUNITY = ("community_seed42", ["--seed", "42"])
# [16]: the 100-genome set of megahit_tpu's largest run (RESULTS.md:120-129
# records 45.4 Mbp of genome and 806 Mbp of reads but not the generator's
# arguments; these give 45,223,528 bp and 808,217,400 read bases)
COMMUNITY100 = ("community100_seed249",
                ["--genomes", "100", "--max-bp", "800000", "--seed", "249"])
# the count's chunk at the default -m (0.9 x RAM): the driver's batch is
# max(2^20, min(2^26, budget // 64)) windows, 2^26 above 4.3 GB of RAM
COUNT_CHUNK = 1 << 26
# [14] (c)'s limits, set before the first run on the card
RECALL_MIN, RECALL_MIN_COV, TOTAL_MAX = 0.90, 10.0, 1.1
# [15]: --presets meta-sensitive's first rungs (--min-count 1 --k-list
# 21,29), so that the script stays inside its time limit; the whole
# preset runs in a call of its own (phase_meta(torch, None), README)
META_K_LIST = "21,29"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, iters: int = 10, warm: int = 2) -> float:
    """Mean device milliseconds of fn() over `iters` runs (CUDA events
    around the whole batch, after `warm` warm-up runs)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_card(torch) -> str:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    card = card.splitlines()[0]
    from megahit_tpu_torch.core import kernels

    nvcc = subprocess.run([kernels._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    rel = re.search(r"release ([0-9.]+)", nvcc)
    log(f"[1] card: {card}")
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"nvcc {rel.group(1) if rel else '?'}, "
        f"python {sys.version.split()[0]}, host cores usable "
        f"{len(os.sched_getaffinity(0))} of {os.cpu_count()}")
    return card


def phase_build() -> dict:
    from megahit_tpu_torch import native
    from megahit_tpu_torch.core import kernels

    t0 = time.monotonic()
    secs = kernels.build_kernels(verbose=True)
    t_cuda = time.monotonic() - t0
    log(f"[2] nvcc builds (parallel): "
        + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items())
        + f"; wall {t_cuda:.1f}s")
    t0 = time.monotonic()
    status = native.native_status()
    log(f"[2] host C++ helpers {status}: {time.monotonic() - t0:.1f}s")
    if not all(status.values()):
        fail(f"host C++ helpers did not build: {status}")
    return secs


def phase_data() -> dict:
    os.makedirs(DATA, exist_ok=True)
    d = os.path.join(DATA, f"isolate_{GENOME_BP}_{COVERAGE}x_seed1")
    r1 = os.path.join(d, "reads_1.fq.gz")
    if not os.path.exists(r1):
        t0 = time.monotonic()
        subprocess.run(
            [sys.executable, os.path.join(HERE, "scripts",
                                          "make_realistic.py"),
             d, "--genome-bp", str(GENOME_BP), "--coverage",
             str(COVERAGE), "--seed", "1"], check=True)
        log(f"[3] generated reads in {time.monotonic() - t0:.1f}s")
    log(f"[3] isolate: {GENOME_BP} bp genome, {COVERAGE}x, {d}")
    return {"dir": d, "r1": r1, "r2": os.path.join(d, "reads_2.fq.gz"),
            "genome": os.path.join(d, "genome.fa")}


def _card_words(torch, words_np, offset: int = 0):
    """u32 words as an int32 tensor on the card that starts `offset`
    words past a 16-B boundary."""
    buf = torch.empty(len(words_np) + offset, dtype=torch.int32,
                      device="cuda")
    buf[offset:].copy_(torch.from_numpy(words_np.view("int32")))
    return buf[offset:]


def _parity_k1(torch, words_np, k1: int, offset: int = 0) -> int:
    """kernel 1 vs plain at k1 on the card -> max |difference|; the pool
    starts `offset` words past a 16-B boundary."""
    from megahit_tpu_torch.core import kernels

    packed = _card_words(torch, words_np, offset)
    got = kernels.canonical_all_kmers(packed, k1)
    want = kernels.canonical_all_kmers_plain(packed, k1)
    torch.cuda.synchronize()
    if got.shape != want.shape:
        fail(f"canonical_all_kmers k1={k1}: shape {tuple(got.shape)} "
             f"!= {tuple(want.shape)}")
    return int((got.long() - want.long()).abs().max())


def _device_ops(torch, fn, iters: int = 10) -> list:
    """(name, device ms, count) per call of each kernel or memset that
    fn runs on the card (torch.profiler, device activity only)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.self_device_time_total / 1e3 / iters, e.count / iters)
            for e in prof.key_averages() if e.self_device_time_total > 0]


def _k1_ops(torch, tag: str, packed, k1: int) -> None:
    """Kernel 1's device work per call. Prints what torch.profiler sees
    on the device (_device_ops) and the torch ops that one call
    dispatches. Fails if the profiler saw a device op other than kernel
    1, if the call dispatched a torch op other than the output's
    allocation (torch.empty: no fill, no copy of the pool), or if it
    did not bump the launch counter exactly once. The profiler's
    per-call counts are printed, not held to 1: late in a long process
    it loses device events (9 of 10 calls seen, 6 of 20, none), so a
    session that saw none is taken again, up to 3."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from megahit_tpu_torch.core import kernels

    class Dispatched(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    for session in range(1, 4):
        ops = _device_ops(
            torch, lambda: kernels.canonical_all_kmers(packed, k1), iters=20)
        if ops:
            break
    before = kernels.canonical_all_kmers.launches
    with Dispatched() as mode:
        kernels.canonical_all_kmers(packed, k1)
    launched = kernels.canonical_all_kmers.launches - before
    log(f"{tag} canonical_all_kmers per call on the device: " + ", ".join(
        f"{name[:40]} {ms:.4f} ms x{cnt:g}" for name, ms, cnt in ops)
        + f" (profiler session {session}); torch ops a call: {mode.names}, "
        f"launches a call: {launched}")
    if (any("canon" not in name for name, _, _ in ops) or launched != 1
            or set(mode.names) - {"empty"}):
        fail(f"{tag} canonical_all_kmers is not one kernel launch a call: "
             f"device ops {ops}, torch ops {mode.names}, launches {launched}")


def _parity_k2(torch, cols, n_inv: int) -> int:
    from megahit_tpu_torch.core import kernels

    h1, c1 = kernels.count_sorted_runs(cols, n_inv)
    h0, c0 = kernels.count_sorted_runs_plain(cols, n_inv)
    torch.cuda.synchronize()
    return max(int((h1.long() - h0.long()).abs().max()),
               int((c1.long() - c0.long()).abs().max()))


def phase_kernels(torch, data) -> list[dict]:
    import numpy as np

    from megahit_tpu_torch.core import kernels, kmerops
    from megahit_tpu_torch.graph import counter
    from megahit_tpu_torch.io.lib import build_lib

    k1 = 22
    w = kmerops.words_per_kmer(k1)
    lib = build_lib([data["r1"]], [data["r2"]], [], [])
    starts = lib.starts
    pool = lib.pool
    total_words = pool.n_words + w + 1
    words_np = pool.window_padded(0, total_words)
    n_bases = int(starts[-1])
    log(f"[4] main-path pool: {n_bases} bases, {total_words} words")

    # --- kernel 1 at the main path's shapes (the count's single shot)
    err1 = _parity_k1(torch, words_np, k1)
    packed = torch.from_numpy(words_np.view("int32")).cuda()
    q = total_words - w
    q_pad = kernels.q_padded(total_words, k1)
    n_out = q_pad * 16
    ms1 = cuda_ms(torch, lambda: kernels.canonical_all_kmers(packed, k1))
    plain1 = cuda_ms(
        torch, lambda: kernels.canonical_all_kmers_plain(packed, k1),
        iters=3, warm=1)
    bytes1 = (q_pad + w) * 4 + w * 4 * n_out
    bound1 = bytes1 / HBM_BYTES_PER_S * 1e3
    log(f"[4] canonical_all_kmers k1={k1}: {n_out} offsets, "
        f"max_abs_err {err1}, {ms1:.3f} ms (plain {plain1:.3f} ms), "
        f"bound {bound1:.3f} ms ({bytes1} B), {bound1 / ms1:.1%} of bound")
    _k1_ops(torch, "[4]", packed, k1)
    for kk in (16, 32, 42, 56, 128, 255):
        e = _parity_k1(torch, words_np[: (1 << 20) + 8], kk)
        log(f"[4] canonical_all_kmers k1={kk}: max_abs_err {e}")
        err1 = max(err1, e)
    # a ragged pool (2047 window starts past a 2048 multiple) that starts
    # 4 B past a 16-B boundary
    e = _parity_k1(torch, words_np[: 3 * 2048 + 2047 + w], k1, offset=1)
    log(f"[4] canonical_all_kmers k1={k1}, {3 * 2048 + 2047 + w} words at "
        f"a 4-B offset: max_abs_err {e}")
    err1 = max(err1, e)

    # --- kernel 2 on the sorted keys the main path gives it
    vm = np.zeros(q * 16, dtype=bool)
    span = min(q * 16, n_bases)
    vm[:span] = counter.window_valid_range(starts, k1, 0, span)
    pm = torch.from_numpy(kernels.phase_grouped_mask(vm)).cuda()
    cols1 = kernels.canonical_all_kmers(packed, k1)
    words = [torch.where(pm, kmerops.u32_value(cols1[i]), kmerops.M32)
             for i in range(w)]
    del cols1
    words = counter._sorted_words(words)
    cols = [kmerops.i32_bits(c) for c in words]
    n_inv = int((~pm).sum())
    n = cols[0].shape[0]
    err2 = _parity_k2(torch, cols, n_inv)
    ms2 = cuda_ms(torch, lambda: kernels.count_sorted_runs(cols, n_inv))
    plain2 = cuda_ms(
        torch, lambda: kernels.count_sorted_runs_plain(cols, n_inv),
        iters=3, warm=1)
    packed_key = kmerops.pack_sort_keys(words)[0]
    lib2 = cuda_ms(torch, lambda: torch.unique_consecutive(
        packed_key, return_counts=True))
    bytes2 = w * 4 * n + 5 * n
    bound2 = bytes2 / HBM_BYTES_PER_S * 1e3
    log(f"[4] count_sorted_runs: n={n}, n_inv={n_inv}, max_abs_err "
        f"{err2}, {ms2:.3f} ms (plain {plain2:.3f} ms, "
        f"unique_consecutive {lib2:.3f} ms), bound {bound2:.3f} ms "
        f"({bytes2} B), {bound2 / ms2:.1%} of bound")
    ops = _device_ops(torch, lambda: kernels.count_sorted_runs(cols, n_inv))
    log("[4] count_sorted_runs per call on the device: " + ", ".join(
        f"{name[:40]} {ms:.4f} ms x{cnt:g}" for name, ms, cnt in ops))
    n_set = round(sum(c for name, _, c in ops if "memset" in name.lower()))
    if round(sum(c for _, _, c in ops)) - n_set != 1 or n_set > 1:
        fail("count_sorted_runs is not one kernel launch and at most one "
             f"memset a call: {ops}")
    del words, cols, packed_key
    # the longest look-ahead chain at the same n: every row one run, so
    # every tile but the first is headless
    one = torch.zeros(n, dtype=torch.int32, device="cuda")
    e = _parity_k2(torch, [one, one], 0)
    ms_one = cuda_ms(torch, lambda: kernels.count_sorted_runs([one, one], 0))
    log(f"[4] count_sorted_runs n={n} as one run: max_abs_err {e}, "
        f"{ms_one:.3f} ms, {bound2 / ms_one:.1%} of bound")
    err2 = max(err2, e)
    del one

    # the count's chunked branch (pools above one batch) against its
    # single-shot branch, both on the card
    t0 = time.monotonic()
    fused = counter._count_fused(pool, starts, k1, 2, "cuda")
    chunked = counter._count_chunked(pool, starts, k1, 2, CHUNK, "cuda")
    if fused is None or not all(
            np.array_equal(a, b) for a, b in zip(fused, chunked)):
        fail("count on cuda: the chunked branch differs from the single "
             "shot")
    log(f"[4] count on cuda: chunked ({-(-n_bases // CHUNK)} batches) "
        f"== single shot: {len(fused[0])} solid, {len(fused[2])} rare "
        f"keys ({time.monotonic() - t0:.1f}s)")
    del fused, chunked

    # odd n, sentinel tail, one run spanning many blocks, W = 1..3
    rng = np.random.default_rng(5)
    for n_odd, dup, ninv, ncols in ((1_000_003, 40, 333, 2),
                                    (1_000_003, 1_000_003, 9, 1),
                                    (98_305, 3, 1, 3)):
        hi = np.sort(rng.integers(0, dup, n_odd)).astype(np.uint32)
        hi[n_odd - ninv:] = 0xFFFFFFFF
        extra = [np.zeros(n_odd, np.uint32) for _ in range(ncols - 1)]
        for e_ in extra:
            e_[n_odd - ninv:] = 0xFFFFFFFF
        c = [torch.from_numpy(a.view("int32")).cuda()
             for a in [hi] + extra]
        e = _parity_k2(torch, c, ninv)
        log(f"[4] count_sorted_runs n={n_odd} dup={dup} n_inv={ninv} "
            f"W={ncols}: max_abs_err {e}")
        err2 = max(err2, e)
    if err1 or err2:
        fail(f"kernel parity: canonical_all_kmers {err1}, "
             f"count_sorted_runs {err2}")
    return [
        {"name": "canonical_all_kmers", "route": "cuda",
         "source": "megahit_tpu_torch/csrc/canonical_kmers.cu",
         "replaces": "megahit_tpu/core/pallas_kernels.py:105",
         "launches": 0, "max_abs_err": err1, "ms": ms1,
         "plain_ms": plain1, "bound_ms": bound1, "bound_by": "bytes",
         "library_ms": None},
        {"name": "count_sorted_runs", "route": "cuda",
         "source": "megahit_tpu_torch/csrc/count_runs.cu",
         "replaces": "megahit_tpu/core/pallas_kernels.py:286",
         "launches": 0, "max_abs_err": err2, "ms": ms2,
         "plain_ms": plain2, "bound_ms": bound2, "bound_by": "bytes",
         "library_ms": lib2},
    ]


# kernel 1's shapes in phase_k1_turns: (name, k1, pool words or None
# for the isolate's count pool, words from a 16-B boundary to the pool)
K1_SHAPES = (("isolate", 22, None, 0), ("chunk", 22, (1 << 22) + 3, 0),
             ("chunk_k56", 56, (1 << 22) + 5, 0),
             ("chunk_offset1", 22, (1 << 22) + 3, 1))
_K1_CHILD = """
import importlib.util, json, sys
tree, smoke, d = sys.argv[1:4]
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("chip_smoke_turn", smoke)
c = importlib.util.module_from_spec(spec)
spec.loader.exec_module(c)
import torch
print("K1 " + json.dumps(c._k1_times(torch, d)))
"""


def _k1_times(torch, d: str) -> dict:
    """Kernel 1 of the megahit_tpu_torch first on sys.path, through its
    own wrapper, at K1_SHAPES (pools in `d`): ms a call (CUDA events, 50
    calls), the device ops of a call (torch.profiler) and a digest of the
    output."""
    import hashlib

    import numpy as np

    from megahit_tpu_torch.core import kernels

    kernels.build_kernels()
    res = {"kernels": kernels.__file__}
    for name, k1, _, offset in K1_SHAPES:
        packed = _card_words(
            torch, np.load(os.path.join(d, f"{name}.npy")), offset)
        out = kernels.canonical_all_kmers(packed, k1).cpu().numpy()
        res[name] = {
            "digest": hashlib.sha256(out.tobytes()).hexdigest(),
            "ms": cuda_ms(torch, lambda: kernels.canonical_all_kmers(
                packed, k1), iters=50, warm=5),
            "ops": _device_ops(torch, lambda: kernels.canonical_all_kmers(
                packed, k1), iters=20)}
        del out, packed
    return res


def phase_k1_turns(torch, parent: str) -> list[dict]:
    """Kernel 1 of this tree beside the tree at `parent` (another commit
    unpacked with git archive, e.g. into chip_smoke_data/parent) in
    turns, parent, this, this, parent, each turn a child process that
    imports its tree's package: at the isolate's count pool and at a
    2^26-base chunk of random words at k1 = 22 and 56 (the kernel's work
    does not depend on the words) and at k1 = 22 starting 4 B past a
    16-B boundary, each tree through its own wrapper.
    Fails unless every turn gives the same output. Returns per shape
    and tree the mean ms of its two turns, the kernel's device ms and
    the byte bound."""
    import numpy as np

    from megahit_tpu_torch.core import kmerops
    from megahit_tpu_torch.io.lib import build_lib

    d = os.path.join(DATA, "k1_turns")
    os.makedirs(d, exist_ok=True)
    data = phase_data()
    lib = build_lib([data["r1"]], [data["r2"]], [], [])
    rng = np.random.default_rng(13)
    bounds = {}
    for name, k1, n, _ in K1_SHAPES:
        w = kmerops.words_per_kmer(k1)
        words = (lib.pool.window_padded(0, lib.pool.n_words + w + 1)
                 if n is None else
                 rng.integers(0, 2 ** 32, n, dtype=np.uint32))
        np.save(os.path.join(d, f"{name}.npy"), words)
        n_out = (-(-(len(words) - w) // 2048) * 2048) * 16
        nbytes = len(words) * 4 + w * 4 * n_out
        bounds[name] = (nbytes, nbytes / HBM_BYTES_PER_S * 1e3, n_out)
    turns = []
    for tag, tree in (("parent", parent), ("this", HERE), ("this", HERE),
                      ("parent", parent)):
        p = subprocess.run(
            [sys.executable, "-c", _K1_CHILD, os.path.abspath(tree),
             os.path.abspath(__file__), d],
            capture_output=True, text=True)
        line = next((x for x in p.stdout.splitlines()
                     if x.startswith("K1 ")), None)
        if p.returncode != 0 or line is None:
            fail(f"[k1] {tag} turn ({tree}) failed:\n{p.stdout[-3000:]}"
                 f"\n{p.stderr[-3000:]}")
        r = json.loads(line[3:])
        if not r["kernels"].startswith(os.path.abspath(tree)):
            fail(f"[k1] {tag} turn imported {r['kernels']}, not {tree}'s")
        turns.append((tag, r))
        for name, _, _, _ in K1_SHAPES:
            x = r[name]
            log(f"[k1] {tag} turn {len(turns)} {name}: {x['ms']:.4f} ms a "
                f"call ({bounds[name][1] / x['ms']:.1%} of bound); device "
                "ops a call: " + ", ".join(
                    f"{o[0][:40]} {o[1]:.4f} ms x{o[2]:g}"
                    for o in x["ops"]))
    rows = []
    for name, k1, _, _ in K1_SHAPES:
        if len({r[name]["digest"] for _, r in turns}) != 1:
            fail(f"[k1] {name}: the trees' outputs differ")
        nbytes, bound, n_out = bounds[name]
        row = {"shape": name, "k1": k1, "offsets": n_out, "bytes": nbytes,
               "bound_ms": bound}
        for tag in ("parent", "this"):
            ms = [r[name]["ms"] for t, r in turns if t == tag]
            dev = [sum(o[1] / o[2] for o in r[name]["ops"]
                       if "canon" in o[0]) for t, r in turns if t == tag]
            row[tag] = {"ms": ms, "kernel_device_ms": dev,
                        "ops": [sum(o[2] for o in r[name]["ops"])
                                for t, r in turns if t == tag]}
        rows.append(row)
        log(f"[k1] {name} (k1={k1}, {n_out} offsets, bound {bound:.4f} ms,"
            f" {nbytes} B): parent {np.mean(row['parent']['ms']):.4f} ms "
            f"({bound / np.mean(row['parent']['ms']):.1%}), this "
            f"{np.mean(row['this']['ms']):.4f} ms "
            f"({bound / np.mean(row['this']['ms']):.1%}); kernel alone "
            f"parent {np.mean(row['parent']['kernel_device_ms']):.4f}, this "
            f"{np.mean(row['this']['kernel_device_ms']):.4f} ms")
    log("[k1] " + json.dumps(rows))
    return rows


def _planes(torch, rng, n: int, kind: str):
    """48-bit keys as (hi int32, lo int16) planes on the card, the
    inputs of megahit_tpu's tests/test_sortnet.py::mk: the low 4 bits of
    lo zero. kind: "uniform"; "dup", duplicate-heavy (7 x 3 distinct
    keys); "ascending" / "descending", so that at every merge level one
    run of each pair lies wholly below the other (A below B, or B below
    A: a tile's window is all A or all B); "equal", one key (ties go to
    A)."""
    import numpy as np

    from megahit_tpu_torch.core import sortnet

    hi = rng.integers(0, 2 ** 32, n, dtype=np.uint32)
    lo = (rng.integers(0, 2 ** 12, n, dtype=np.uint32) << 4).astype(
        np.uint16)
    if kind == "dup":
        hi = (hi % 7).astype(np.uint32)
        lo = ((lo.astype(np.uint32) % 3) << 4).astype(np.uint16)
    key = (hi.astype(np.int64) << 16) | lo.astype(np.int64)
    if kind in ("ascending", "descending"):
        key = np.sort(key)
        if kind == "descending":
            key = key[::-1].copy()
    elif kind == "equal":
        key[:] = key[0]
    return sortnet.unpack_key(torch.from_numpy(key).cuda())


def _check_levels(torch, hi, lo, init_run, max_tile, timed):
    """sort_planes' merge levels (sortnet.merge_levels) one at a time:
    each kernel's output against merge_pairs_plain, the plain version
    of both kernels, and at kernel 4's levels its split search against
    merge_path_splits_plain. At kernel 3's levels kernel 4 runs too,
    with tile = run_len, against the same plain version. Returns (max
    |difference|, per kernel a list of per-level times when timed: the
    kernel's ms (CUDA events around 10 launches) and its device time a
    launch (torch.profiler), its plain version's ms, the library's (one
    torch.sort of the packed key's rows of 2 * run_len, which computes
    the level) and, at kernel 3's levels, kernel 4's)."""
    from megahit_tpu_torch.core import sortnet

    pk = sortnet.pack_key
    hi, lo = sortnet.sort_rows(hi, lo, init_run)
    err, times = 0, {"merge_pairs": [], "merge_path_level": []}
    for run, merge in sortnet.merge_levels(hi.shape[0], init_run, max_tile):
        name = merge.func.__name__
        gh, gl = merge(hi, lo)
        ph, pl = sortnet.merge_pairs_plain(hi, lo, run)
        want = pk(ph, pl)
        err = max(err, int((pk(gh, gl) - want).abs().max()))
        if name == "merge_path_level":
            got = sortnet.merge_path_splits(hi, lo, run, max_tile)
            splits = sortnet.merge_path_splits_plain(hi, lo, run, max_tile)
            err = max(err, *(int((g.long() - w.long()).abs().max())
                             for g, w in zip(got, splits)))
        else:
            err = max(err, int((pk(*sortnet.merge_path_level(
                hi, lo, run, run)) - want).abs().max()))
        if timed:
            key = pk(hi, lo).view(-1, 2 * run)
            t = {"run": run,
                 "ms": cuda_ms(torch, lambda: merge(hi, lo)),
                 "plain_ms": cuda_ms(
                     torch, lambda: sortnet.merge_pairs_plain(hi, lo, run),
                     iters=2, warm=1),
                 "library_ms": cuda_ms(
                     torch, lambda: torch.sort(key, dim=1), iters=5, warm=1),
                 "device_ms": sum(ms for _, ms, _ in _device_ops(
                     torch, lambda: merge(hi, lo), iters=5))}
            if name == "merge_pairs":
                t["path_ms"] = cuda_ms(
                    torch, lambda: sortnet.merge_path_level(hi, lo, run, run),
                    iters=5, warm=1)
            times[name].append(t)
            del key
        hi, lo = gh, gl
    return err, times


def phase_sortnet(torch) -> list[dict]:
    """Kernels 3 and 4 through sort_planes on the card."""
    import numpy as np

    from megahit_tpu_torch.core import sortnet

    n = 1 << 24
    rng = np.random.default_rng(7)
    err, launches, times = 0, None, None
    for kind, size, init_run, max_tile in (
            ("uniform", n, sortnet.INIT_RUN, sortnet.MAX_TILE),
            ("dup", n, sortnet.INIT_RUN, sortnet.MAX_TILE),
            ("ascending", n, sortnet.INIT_RUN, sortnet.MAX_TILE),
            ("descending", n, sortnet.INIT_RUN, sortnet.MAX_TILE),
            ("equal", n, sortnet.INIT_RUN, sortnet.MAX_TILE),
            ("uniform", 8192, 512, 1024),
            ("dup", 8192, 512, 1024)):
        hi, lo = _planes(torch, rng, size, kind)
        key = sortnet.pack_key(hi, lo)
        # the path's run: sort_planes as a user calls it, counts from 0
        sortnet.merge_pairs.launches = 0
        sortnet.merge_path_level.launches = 0
        oh, ol = sortnet.sort_planes(hi, lo, init_run, max_tile)
        torch.cuda.synchronize()
        counts = {"merge_pairs": sortnet.merge_pairs.launches,
                  "merge_path_level": sortnet.merge_path_level.launches}
        e = int((sortnet.pack_key(oh, ol) - torch.sort(key).values)
                .abs().max())
        first = launches is None
        e2, t = _check_levels(torch, hi, lo, init_run, max_tile, timed=first)
        log(f"[4] sort_planes n={size} {kind} init_run={init_run} "
            f"max_tile={max_tile}: launches {counts}, result == torch.sort "
            f"(max_abs_err {e}), every level == plain and every split == "
            f"plain (max_abs_err {e2})")
        err = max(err, e, e2)
        if first:
            launches, times = counts, t
            total_ms = cuda_ms(torch, lambda: sortnet.sort_planes(hi, lo),
                               iters=3, warm=1)
            lib_ms = cuda_ms(torch, lambda: torch.sort(key), iters=5,
                             warm=1)
            ch, cl = torch.empty_like(hi), torch.empty_like(lo)
            copy_ms = cuda_ms(torch, lambda: (ch.copy_(hi), cl.copy_(lo)))
            log(f"[4] sort_planes n=2^24: {total_ms:.3f} ms per call; "
                f"torch.sort of the whole packed int64 key {lib_ms:.3f} "
                f"ms; a copy of the planes (12 B a key) {copy_ms:.4f} ms")
            del ch, cl
        del hi, lo, key, oh, ol
    if err:
        fail(f"merge kernels disagree with their plain versions: {err}")
    bound = 12 * n / HBM_BYTES_PER_S * 1e3  # 6 B read + 6 B written a key
    out = []
    for name, src, rep_line in (
            ("merge_pairs", "merge_pairs.cu", 224),
            ("merge_path_level", "merge_path.cu", 363)):
        lv = times[name]
        if launches[name] <= 0 or not lv:
            fail(f"{name} was not launched by sort_planes: {launches}")
        mean = {k: sum(t[k] for t in lv) / len(lv)
                for k in ("ms", "plain_ms", "library_ms")}
        log(f"[4] {name}: {launches[name]} launches per sort_planes call, "
            f"per launch {mean['ms']:.3f} ms, plain {mean['plain_ms']:.3f} "
            f"ms, row torch.sort {mean['library_ms']:.3f} ms, bound "
            f"{bound:.3f} ms ({12 * n} B), {bound / mean['ms']:.1%} of bound")
        for t in lv:
            log(f"[4] {name} run_len {t['run']}: {t['ms']:.3f} ms (on the "
                f"device {t['device_ms']:.3f} ms), torch.sort of rows of "
                f"{2 * t['run']} {t['library_ms']:.3f} ms"
                + (f", merge_path_level with tile {t['run']} "
                   f"{t['path_ms']:.3f} ms" if "path_ms" in t else ""))
        out.append({
            "name": name, "route": "cuda",
            "source": f"megahit_tpu_torch/csrc/{src}",
            "replaces": f"megahit_tpu/core/sortnet.py:{rep_line}",
            "launches": launches[name], "max_abs_err": err,
            "ms": mean["ms"], "plain_ms": mean["plain_ms"],
            "bound_ms": bound, "bound_by": "bytes",
            "library_ms": mean["library_ms"]})
    return out


def _run_cli(argv: list[str]) -> None:
    from megahit_tpu_torch.__main__ import main as cli

    rc = cli(argv)
    if rc != 0:
        fail(f"megahit_tpu_torch {' '.join(argv)} exited {rc}")


def phase_fixtures() -> None:
    for tag, name, flags in (
            ("--k-list 21", "k21", ["--k-list", "21"]),
            ("default ladder", "ladder", []),
            ("default ladder --no-local", "ladder_no_local", ["--no-local"])):
        out = os.path.join(DATA, "fixtures", name)
        t0 = time.monotonic()
        _run_cli(["--test", "--device", "cuda", "-f",
                  "-o", os.path.join(out, "cuda")] + flags)
        t1 = time.monotonic()
        _run_cli(["--test", "--device", "cpu", "-f",
                  "-o", os.path.join(out, "cpu")] + flags)
        t2 = time.monotonic()
        with open(os.path.join(out, "cuda", "final.contigs.fa"), "rb") as f:
            a = f.read()
        with open(os.path.join(out, "cpu", "final.contigs.fa"), "rb") as f:
            b = f.read()
        if a != b or not a:
            fail(f"fixture final.contigs.fa ({tag}) differs between cuda "
                 "and cpu")
        log(f"[5] fixtures {tag}: cuda ({t1 - t0:.1f}s) and cpu "
            f"({t2 - t1:.1f}s) final.contigs.fa byte-identical "
            f"({a.count(b'>')} contigs)")


def _fasta_lengths(path: str) -> list[int]:
    lens, cur = [], 0
    with open(path) as fh:
        for line in fh:
            if line.startswith(">"):
                if cur:
                    lens.append(cur)
                cur = 0
            else:
                cur += len(line.strip())
    if cur:
        lens.append(cur)
    return lens


def _log_stages(tag: str, out: str) -> None:
    """Per-stage wall seconds from a run's `phase ...` log lines."""
    spans = {}
    with open(os.path.join(out, "log")) as fh:
        for line in fh:
            m = re.search(r"phase (\S+): ([0-9.]+)s total", line)
            if m:
                spans[m.group(1)] = float(m.group(2))
    for name, secs in sorted(spans.items(), key=lambda x: -x[1]):
        log(f"{tag}   stage {name}: {secs:.2f}s")


def _device_profile(tag: str, prof, wall: float) -> float:
    ops = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in ops) / 1e6
    log(f"{tag} device busy {busy:.3f}s of {wall:.1f}s wall "
        f"(idle share {1 - busy / wall:.1%}), "
        f"{sum(e.count for e in ops)} device ops")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"{tag}   device {e.self_device_time_total / 1e3:.2f} ms "
            f"x{e.count}: {e.key[:70]}")
    return busy


def _log_rungs(tag: str, out: str) -> list[str]:
    """Prints a ladder run's k list and the rungs it assembled."""
    with open(os.path.join(out, "log")) as fh:
        text = fh.read()
    klist = re.search(r"k list: (\S+)", text).group(1)
    rungs = re.findall(r"stage \d+ \(stage_assemble (\d+)\)", text)
    early = re.search(r"early termination at k=(\d+)", text)
    log(f"{tag} k list {klist}; rungs assembled: {','.join(rungs)}"
        + (f"; early termination at k={early.group(1)}" if early else
           "; no early termination"))
    return rungs


def _check_contigs(tag: str, out: str, data) -> None:
    from megahit_tpu_torch.graph.output import contig_stats

    import numpy as np

    lens = _fasta_lengths(os.path.join(out, "final.contigs.fa"))
    st = contig_stats(np.array(lens, dtype=np.int64))
    genome_len = sum(_fasta_lengths(data["genome"]))
    log(f"{tag} contigs: {st['n']}, total {st['total']} bp (genome "
        f"{genome_len} bp), N50 {st['n50']} bp, max {st['max']} bp")
    if not 0.9 * genome_len <= st["total"] <= 1.1 * genome_len:
        fail(f"{tag} contig total {st['total']} not within 10% of "
             f"{genome_len}")
    if st["n50"] <= 10_000:
        fail(f"{tag} N50 {st['n50']} <= 10 kbp")


def _check_cleaning(tag: str, out: str) -> None:
    """Every rung of a cuda run cleans on the device engine."""
    with open(os.path.join(out, "log")) as fh:
        text = fh.read()
    rungs = re.findall(r"stage \d+ \(stage_assemble (\d+)\)", text)
    on_device = text.count("cleaning on device (cuda)")
    if "cleaning on host" in text or "falling back to host cleaning" in text:
        fail(f"{tag} a cuda rung cleaned on the host")
    if on_device != len(rungs):
        fail(f"{tag} {on_device} of {len(rungs)} rungs cleaned on the "
             "device")
    log(f"{tag} cleaning on device at all {len(rungs)} rungs")


def _assemble_split(out: str) -> dict:
    """The seconds of each rung's assemble split (the spans
    `assemble.k<K>.clean_output.<step>` in a run's closing `phase ...
    total` lines), summed over rungs."""
    split: dict[str, float] = {}
    with open(os.path.join(out, "log")) as fh:
        for line in fh:
            m = re.search(r"phase assemble\.k\d+\.clean_output\.(\w+): "
                          r"([0-9.]+)s total", line)
            if m:
                split[m.group(1)] = split.get(m.group(1), 0.0) + float(
                    m.group(2))
    return split


def _log_split(tag: str, out_cuda: str, out_cpu: str) -> None:
    a, b = _assemble_split(out_cuda), _assemble_split(out_cpu)
    log(f"{tag} assemble split summed over rungs, cuda | cpu: " + ", ".join(
        f"{name} {a.get(name, 0.0):.2f} | {b.get(name, 0.0):.2f}s"
        for name in ("sdbg_tips", "unitig_build", "cleaning_rounds",
                     "prune_output")))


def _cuda_run(torch, argv: list[str]):
    """The CLI on cuda with every kernel launch counter set to 0 just
    before and read just after, under torch.profiler (device activity
    only, CUPTI: the host side runs unrecorded). Returns (wall seconds,
    launches, peak device memory in bytes, the profile)."""
    from megahit_tpu_torch.core import kernels

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.reset_peak_memory_stats()
    kernels.canonical_all_kmers.launches = 0
    kernels.count_sorted_runs.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        _run_cli(argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    launches = {"canonical_all_kmers": kernels.canonical_all_kmers.launches,
                "count_sorted_runs": kernels.count_sorted_runs.launches}
    return wall, launches, torch.cuda.max_memory_allocated(), prof


def phase_main_path(torch, data) -> dict:
    out = os.path.join(DATA, "isolate_out")
    wall, launches, peak, prof = _cuda_run(
        torch, ["-1", data["r1"], "-2", data["r2"], "--k-list", "21", "-f",
                "-o", out])
    log(f"[6] isolate --k-list 21 on cuda: {wall:.1f}s wall, "
        f"launches {launches}, peak device memory {peak / 2**30:.2f} GiB")
    _device_profile("[6]", prof, wall)
    _log_stages("[6]", out)
    _check_cleaning("[6]", out)
    _check_contigs("[6]", out, data)
    if min(launches.values()) <= 0:
        fail(f"a kernel was not launched on the main path: {launches}")
    return launches


def phase_cpu_match(data) -> None:
    """The isolate again with --device cpu: the contigs must be those of
    the cuda run, byte for byte."""
    out = os.path.join(DATA, "isolate_out_cpu")
    t0 = time.monotonic()
    _run_cli(["-1", data["r1"], "-2", data["r2"], "--k-list", "21",
              "--device", "cpu", "-f", "-o", out])
    wall = time.monotonic() - t0
    with open(os.path.join(out, "final.contigs.fa"), "rb") as f:
        a = f.read()
    with open(os.path.join(DATA, "isolate_out", "final.contigs.fa"),
              "rb") as f:
        b = f.read()
    if a != b:
        fail("isolate final.contigs.fa differs between cpu and cuda")
    log(f"[7] isolate --k-list 21 on cpu: {wall:.1f}s wall, "
        f"final.contigs.fa byte-identical to the cuda run")
    _log_stages("[7]", out)
    _log_split("[7]", os.path.join(DATA, "isolate_out"), out)


def phase_ladder(torch, data) -> dict:
    """The isolate with the default k list on cuda, with every kernel
    launch counter set to 0 just before and read just after."""
    out = os.path.join(DATA, "isolate_ladder")
    wall, launches, peak, prof = _cuda_run(
        torch, ["-1", data["r1"], "-2", data["r2"], "-f", "-o", out])
    log(f"[8] isolate, default k list on cuda: {wall:.1f}s wall, "
        f"launches {launches}, peak device memory {peak / 2**30:.2f} GiB")
    rungs = _log_rungs("[8]", out)
    _device_profile("[8]", prof, wall)
    _log_stages("[8]", out)
    _check_cleaning("[8]", out)
    with open(os.path.join(out, "log")) as fh:
        text = fh.read()
    prune = dict(re.findall(r"phase assemble\.k(\d+)\.clean_output\."
                            r"prune_output: ([0-9.]+)s total", text))
    log("[8] local low-depth passes on the device, by rung (the rung's "
        "prune_output seconds): " + ", ".join(
            f"k={k} {n} in {prune.get(k, '?')}s" for k, n in zip(
                rungs, re.findall(
                    r"local low depth: (\d+) passes on the device", text))))
    _check_contigs("[8]", out, data)
    if min(launches.values()) <= 0:
        fail(f"a kernel was not launched on the ladder: {launches}")
    out_cpu = os.path.join(DATA, "isolate_ladder_cpu")
    t0 = time.monotonic()
    _run_cli(["-1", data["r1"], "-2", data["r2"], "--device", "cpu", "-f",
              "-o", out_cpu])
    wall = time.monotonic() - t0
    with open(os.path.join(out, "final.contigs.fa"), "rb") as f:
        a = f.read()
    with open(os.path.join(out_cpu, "final.contigs.fa"), "rb") as f:
        b = f.read()
    if a != b:
        fail("isolate default-ladder final.contigs.fa differs between cpu "
             "and cuda")
    log(f"[8] isolate, default k list on cpu: {wall:.1f}s wall, "
        "final.contigs.fa byte-identical to the cuda run")
    _log_stages("[8] cpu", out_cpu)
    _log_split("[8]", out, out_cpu)
    return launches


def phase_engines(torch) -> None:
    """The isolate's k=21 graph on cuda assembled by each route of
    utils.device.graph_on_card: the card's (device cleaning engine) and,
    with the predicate patched to False, the host's (host engine over
    the native cores); every record must be equal."""
    import numpy as np

    from megahit_tpu_torch.graph.sdbg import sdbg_from_edges
    from megahit_tpu_torch.pipeline.assemble import (
        AssembleOptions, assemble,
    )
    from megahit_tpu_torch.utils import device as devices
    from megahit_tpu_torch.utils.log import setup_logging
    from megahit_tpu_torch.utils.timers import PhaseTimer

    setup_logging()  # console only: the last run's log file stays as is
    edges = os.path.join(DATA, "isolate_1pass", "tmp", "k21",
                         "k21.edges.npz")
    if not os.path.exists(edges):
        fail("[10] no k=21 edge file from [11]'s 1-pass run")
    z = np.load(edges)
    keys, counts = z["keys"], z["counts"]
    on_card = devices.graph_on_card

    def run(engine, prune, final):
        devices.graph_on_card = (
            on_card if engine == "device" else lambda device: False)
        try:
            sdbg = sdbg_from_edges(keys, counts, 22, device="cuda")
            timer = PhaseTimer()
            t0 = time.monotonic()
            with timer.phase("a"):
                res = assemble(sdbg, AssembleOptions(
                    min_standalone=300, prune_level=prune,
                    careful_bubble=True, is_final_round=final))
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        finally:
            devices.graph_on_card = on_card

        def fmt(cs):
            return [(c.codes.tobytes(), c.flag, f"{c.multi:.4f}")
                    for c in cs]

        return ((fmt(res.contigs), fmt(res.final_contigs),
                 fmt(res.addi_contigs), fmt(res.bubbles), res.stats),
                wall, {n[2:]: v for n, v in timer.spans().items()
                       if n.startswith("a.")})

    for prune in (2, 3):
        for final in (False, True):
            dev, dwall, dsplit = run("device", prune, final)
            host, hwall, hsplit = run("host", prune, final)
            names = ("contigs", "finals", "addi", "bubbles", "stats")
            for name, a, b in zip(names, dev, host):
                if a != b:
                    fail(f"[10] prune {prune} final {final}: {name} "
                         "differ between the device and host engines")
            log(f"[10] k=21 careful, prune {prune}, final {final}: "
                f"{len(dev[0])} contigs, {len(dev[1])} finals, "
                f"{len(dev[2])} addi, {len(dev[3])} bubbles equal; "
                f"device engine cleaning_rounds "
                f"{dsplit['cleaning_rounds']:.2f}s prune_output "
                f"{dsplit['prune_output']:.2f}s (assemble {dwall:.2f}s)"
                f" | host engine {hsplit['cleaning_rounds']:.2f}s, "
                f"{hsplit['prune_output']:.2f}s ({hwall:.2f}s)")


def _contig_set(path: str) -> list:
    from megahit_tpu_torch.io.contig_io import read_contigs

    return sorted((c.length, c.codes.tobytes()) for c in read_contigs(path))


def _repeat_pairs(d: str) -> tuple[str, str]:
    """9 kbp genome with a 30-bp repeat, 2x100 bp pairs (insert 250) every
    3 bp with 1% substitutions: the k=21 graph breaks at the repeat, so
    a second rung runs."""
    import gzip

    import numpy as np

    from megahit_tpu_torch.core import packing

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, size=9000).astype(np.uint8)
    genome[6000:6030] = genome[2000:2030]
    p1, p2 = os.path.join(d, "r1.fa.gz"), os.path.join(d, "r2.fa.gz")
    with gzip.open(p1, "wt") as f1, gzip.open(p2, "wt") as f2:
        for i, s in enumerate(range(0, len(genome) - 250, 3)):
            frag = genome[s: s + 250].copy()
            m = rng.random(250) < 0.01
            frag[m] = (frag[m] + rng.integers(1, 4, int(m.sum()))) % 4
            f1.write(f">r{i}/1\n{packing.decode(frag[:100])}\n")
            f2.write(f">r{i}/2\n"
                     f"{packing.decode(packing.revcomp_codes(frag[-100:]))}"
                     "\n")
    return p1, p2


def phase_out_of_core(data) -> None:
    """--kmin-1pass on the isolate under a small -m, and -m 1000 on a
    small two-rung read set, on cuda (and cpu)."""
    out = os.path.join(DATA, "isolate_1pass")
    t0 = time.monotonic()
    # the k=21 edge file (solid edges and mercy) stays for phase [10]
    _run_cli(["-1", data["r1"], "-2", data["r2"], "--k-list", "21",
              "--kmin-1pass", "-m", str(ONEPASS_MEMORY), "--device", "cuda",
              "-f", "--keep-tmp-files", "-o", out])
    wall = time.monotonic() - t0
    with open(os.path.join(out, "log")) as fh:
        text = fh.read()
    spill = re.search(r"bucketed build k=22: (\d+) rows spilled in "
                      r"([0-9.]+)s, (\d+) rounds", text)
    rounds = re.findall(r"bucketed round \d+/\d+ .*: (\d+) rows, (\d+) "
                        r"edges, ([0-9.]+)s \(sort ([0-9.]+)s\)", text)
    if not spill or int(spill.group(3)) < 4:
        fail(f"[11] the 1-pass k=21 build took fewer than 4 rounds")
    log(f"[11] isolate --k-list 21 --kmin-1pass -m {ONEPASS_MEMORY} on "
        f"cuda: {wall:.1f}s wall; {spill.group(1)} rows spilled in "
        f"{spill.group(2)}s, {spill.group(3)} rounds of "
        + ", ".join(f"{r} rows {s}s (sort {t}s)" for r, _, s, t in rounds))
    _log_stages("[11]", out)
    if _contig_set(os.path.join(out, "final.contigs.fa")) != _contig_set(
            os.path.join(DATA, "isolate_out", "final.contigs.fa")):
        fail("[11] the 1-pass contig set differs from the 2-pass run's")
    log("[11] 1-pass contig set equal to [6]'s")

    p1, p2 = _repeat_pairs(os.path.join(DATA, "repeat_pairs"))
    base = ["-1", p1, "-2", p2, "--k-list", "21,39", "--no-local", "-f",
            "--keep-tmp-files"]
    runs = {}
    for name, extra in (("cuda", ["-m", "1000", "--device", "cuda"]),
                        ("cpu", ["-m", "1000", "--device", "cpu"]),
                        ("in_memory", ["--device", "cuda"])):
        runs[name] = os.path.join(DATA, "repeat_pairs", name)
        _run_cli(base + extra + ["-o", runs[name]])
    for name in ("cuda", "cpu"):
        for k in (21, 39):
            if not os.path.isdir(os.path.join(runs[name], "tmp", f"k{k}",
                                              "spill")):
                fail(f"[11] -m 1000 on {name}: k={k} was not built out of "
                     "core")
    with open(os.path.join(runs["cuda"], "final.contigs.fa"), "rb") as f:
        a = f.read()
    with open(os.path.join(runs["cpu"], "final.contigs.fa"), "rb") as f:
        b = f.read()
    if a != b or not a:
        fail("[11] -m 1000 final.contigs.fa differs between cuda and cpu")
    if _contig_set(os.path.join(runs["cuda"], "final.contigs.fa")) != \
            _contig_set(os.path.join(runs["in_memory"], "final.contigs.fa")):
        fail("[11] -m 1000 contig set differs from the in-memory run's")
    log(f"[11] repeat pairs --k-list 21,39 --no-local -m 1000: out of core "
        f"at k=21 and k=39 on cuda and cpu, final.contigs.fa byte-identical "
        f"({a.count(b'>')} contigs), contig set equal to the in-memory run's")


class _Messages(logging.Handler):
    """Keeps every log message of the port (the stage CLI leaves the
    logger's handlers to its caller)."""

    def __init__(self):
        super().__init__()
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _stage(argv: list[str]) -> str:
    """One stage_cli call in this process; its standard output."""
    import contextlib
    import io

    from megahit_tpu_torch.stage_cli import main as stage

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = stage(argv)
    if rc != 0:
        fail(f"stage_cli {' '.join(argv)} exited {rc}")
    return buf.getvalue()


def _equal_artifacts(a: str, b: str) -> list[str]:
    """Names of the files of directory a, each equal to its namesake in
    b: .npz array by array (names, dtypes, shapes, values; the zip
    members carry timestamps), any other file byte for byte."""
    import numpy as np

    names = sorted(os.listdir(a))
    if names != sorted(os.listdir(b)):
        fail(f"[12] artifact names differ: {names} != {sorted(os.listdir(b))}")
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".npz"):
            za, zb = np.load(pa), np.load(pb)
            if sorted(za.files) != sorted(zb.files) or not all(
                    za[f].dtype == zb[f].dtype and za[f].shape == zb[f].shape
                    and np.array_equal(za[f], zb[f]) for f in za.files):
                fail(f"[12] {name} differs between {a} and {b}")
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                if fa.read() != fb.read():
                    fail(f"[12] {name} differs between {a} and {b}")
    return names


def _stage_chain(torch, lib: str, out: str, dev: str, msgs) -> dict:
    """megahit_tpu's manual stage chain (tests/test_stage_cli.py) on
    `dev`, each step's seconds printed; on cuda the count's kernel
    launches are counted from 0 and each kernel must launch."""
    from megahit_tpu_torch.core import kernels

    os.makedirs(out, exist_ok=True)

    def p(name):
        return os.path.join(out, name)

    steps = [
        ("count", ["count", "--lib", lib, "-k", "21", "-m", "2",
                   "-o", p("k21")]),
        ("seq2sdbg k=21", ["seq2sdbg", "--edges", p("k21.edges.npz"),
                           "--need-mercy", "--lib", lib, "-k", "21",
                           "-o", p("k21.sdbg.npz")]),
        ("assemble k=21", ["assemble", "-s", p("k21.sdbg.npz"),
                           "-o", p("k21"), "--careful-bubble"]),
        ("local", ["local", "-c", p("k21.contigs.fa"), "--lib", lib,
                   "--kmax", "41", "-o", p("k21.local.fa")]),
        ("iterate", ["iterate", "-c", p("k21.contigs.fa"),
                     "-b", p("k21.bubble_seq.fa"), "--lib", lib,
                     "-k", "21", "-s", "20", "-o", p("k41")]),
        ("seq2sdbg k=41", ["seq2sdbg", "--edges", p("k41.edges.npz"),
                           "--contig", p("k21.contigs.fa"),
                           "--local-contig", p("k21.local.fa"),
                           "-k", "41", "--kmer-from", "21",
                           "-o", p("k41.sdbg.npz")]),
        ("assemble k=41", ["assemble", "-s", p("k41.sdbg.npz"),
                           "-o", p("k41"), "--is-final-round",
                           "--output-standalone"]),
    ]
    launches = None
    del msgs.messages[:]
    for name, argv in steps:
        if name == "count" and dev == "cuda":
            kernels.canonical_all_kmers.launches = 0
            kernels.count_sorted_runs.launches = 0
        t0 = time.monotonic()
        said = _stage(["--device", dev] + argv).strip().splitlines()
        if dev == "cuda":
            torch.cuda.synchronize()
        secs = time.monotonic() - t0
        if name == "count" and dev == "cuda":
            launches = {
                "canonical_all_kmers": kernels.canonical_all_kmers.launches,
                "count_sorted_runs": kernels.count_sorted_runs.launches}
        log(f"[12] {dev} {name}: {secs:.2f}s ({said[-1] if said else ''})")
    on_device = sum(m == "cleaning on device (cuda)" for m in msgs.messages)
    if on_device != (2 if dev == "cuda" else 0):
        fail(f"[12] {dev}: {on_device} of 2 assemble stages cleaned on the "
             "device")
    return launches


def phase_stages(torch, data) -> dict:
    """[12] the stage subcommands on the isolate, cuda against cpu, with
    read2sdbg, the sharded graph files, checkcpu/checknative and debug
    mode."""
    import numpy as np

    from megahit_tpu_torch.graph.sdbg import Sdbg
    from megahit_tpu_torch.utils import debug
    from megahit_tpu_torch.utils.log import get_logger, setup_logging

    setup_logging()  # console only
    msgs = _Messages()
    get_logger().addHandler(msgs)
    root = os.path.join(DATA, "stages")
    lib = os.path.join(root, "lib.npz")
    os.makedirs(root, exist_ok=True)
    try:
        t0 = time.monotonic()
        _stage(["buildlib", "-1", data["r1"], "-2", data["r2"], "-o", lib])
        log(f"[12] buildlib: {time.monotonic() - t0:.2f}s")
        cu, cp = os.path.join(root, "cuda"), os.path.join(root, "cpu")
        t0 = time.monotonic()
        launches = _stage_chain(torch, lib, cu, "cuda", msgs)
        t1 = time.monotonic()
        _stage_chain(torch, lib, cp, "cpu", msgs)
        t2 = time.monotonic()
        names = _equal_artifacts(cu, cp)
        log(f"[12] stage chain: cuda {t1 - t0:.1f}s, cpu {t2 - t1:.1f}s; "
            f"{len(names)} artifacts equal (.npz array by array, the rest "
            f"byte for byte); count launches {launches}; "
            "both cuda assemble stages cleaned on the device")
        if min(launches.values()) <= 0:
            fail(f"[12] a kernel was not launched by the count stage: "
                 f"{launches}")
    finally:
        get_logger().removeHandler(msgs)

    # read2sdbg (1-pass, out of core) == count + seq2sdbg
    t0 = time.monotonic()
    said = _stage(["--device", "cuda", "read2sdbg", "--lib", lib, "-k", "21",
                   "-m", "2", "--need-mercy", "--memory", str(ONEPASS_MEMORY),
                   "-o", os.path.join(root, "r2s.sdbg.npz")])
    secs = time.monotonic() - t0
    a = Sdbg.load(os.path.join(cu, "k21.sdbg.npz"), device="cuda")
    b = Sdbg.load(os.path.join(root, "r2s.sdbg.npz"), device="cuda")
    if not (np.array_equal(a.keys[a.valid], b.keys[b.valid])
            and np.array_equal(a.mult[a.valid], b.mult[b.valid])):
        fail("[12] read2sdbg differs from count + seq2sdbg")
    log(f"[12] cuda read2sdbg --memory {ONEPASS_MEMORY}: {secs:.2f}s "
        f"({said.strip()}); valid keys and multiplicities equal to count + "
        f"seq2sdbg ({a.num_valid()} edges)")

    # the sharded graph files
    t0 = time.monotonic()
    shards = os.path.join(root, "shards")
    a.save_sharded(shards, rows_per_shard=1 << 18)
    with open(os.path.join(shards, "sdbg_manifest.json")) as fh:
        n_shards = len(json.load(fh)["shards"])
    back = Sdbg.load_sharded(shards, device="cuda")
    e = a.real
    ok = back.real == e and all(
        np.array_equal(x[:e], y[:e]) for x, y in
        ((a.keys, back.keys), (a.mult, back.mult), (a.valid, back.valid)))
    parts = [Sdbg.load_sharded_rows(shards, lo, hi)
             for lo, hi in ((0, 1 << 15), (1 << 15, 1 << 16))]
    ok = ok and all(np.array_equal(np.concatenate([q[i] for q in parts]),
                                   x[:e]) for i, x in
                    enumerate((a.keys, a.mult, a.valid)))
    if n_shards < 2 or not ok:
        fail(f"[12] sharded round trip: {n_shards} shards, equal {ok}")
    log(f"[12] k=21 graph ({e} rows) through save_sharded(rows_per_shard="
        f"2^18): {n_shards} shards, load_sharded and load_sharded_rows over "
        f"buckets [0, 2^15) + [2^15, 2^16) equal "
        f"({time.monotonic() - t0:.2f}s)")

    # introspection
    t0 = time.monotonic()
    cc = _stage(["checkcpu"]).strip().splitlines()[-1]
    cn = _stage(["checknative"]).strip().splitlines()[-1]
    if cc != "1" or cn != "1":
        fail(f"[12] checkcpu printed {cc}, checknative {cn}")
    log(f"[12] checkcpu 1, checknative 1 ({time.monotonic() - t0:.2f}s)")

    # debug mode on the fixtures
    fx = os.path.join(DATA, "fixtures", "debug")
    args = ["--test", "--device", "cuda", "--k-list", "21,29", "--no-local",
            "-f"]
    t0 = time.monotonic()
    _run_cli(args + ["-o", os.path.join(fx, "plain")])
    before = dict(debug.CHECKS)
    os.environ["MEGAHIT_TPU_TORCH_DEBUG"] = "1"
    try:
        _run_cli(args + ["-o", os.path.join(fx, "debug")])
    finally:
        del os.environ["MEGAHIT_TPU_TORCH_DEBUG"]
        debug._finite_armed = False
    ran = {k: debug.CHECKS[k] - before[k] for k in before}
    with open(os.path.join(fx, "plain", "final.contigs.fa"), "rb") as f:
        want = f.read()
    with open(os.path.join(fx, "debug", "final.contigs.fa"), "rb") as f:
        got = f.read()
    if got != want or min(ran.values()) <= 0:
        fail(f"[12] debug mode: checks run {ran}, contigs equal "
             f"{got == want}")
    log(f"[12] fixtures --k-list 21,29 --no-local on cuda with "
        f"MEGAHIT_TPU_TORCH_DEBUG=1: checks run {ran}, final.contigs.fa "
        f"byte-identical to the run without ({time.monotonic() - t0:.1f}s "
        "both)")
    return launches


def _timed(torch, fn):
    """(fn(), host seconds with the card synchronised after)."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, time.monotonic() - t0


def _mesh_count(torch, data, msgs) -> None:
    """[13] 1: the sharded count over 8 virtual shards of the card."""
    import numpy as np

    from megahit_tpu_torch.graph.counter import count_canonical_kmers
    from megahit_tpu_torch.io.lib import build_lib
    from megahit_tpu_torch.parallel.multihost import Mesh
    from megahit_tpu_torch.parallel.shuffle import sharded_count_kmers

    mesh = Mesh(["cuda:0"] * 8)
    lib = build_lib([data["r1"]], [data["r2"]], [], [])

    def compare(tag, pool, starts, retry):
        want, t_one = _timed(torch, lambda: count_canonical_kmers(
            pool, starts, 22, 2, return_rare=True, device="cuda"))
        del msgs.messages[:]
        got, t_mesh = _timed(torch, lambda: sharded_count_kmers(
            pool, starts, 22, 2, mesh, return_rare=True))
        said = [m for m in msgs.messages if m.startswith("sharded count")]
        retried = any("retrying" in m for m in said)
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            fail(f"[13] {tag}: the sharded count differs from "
                 "count_canonical_kmers on cuda")
        if retried != retry:
            fail(f"[13] {tag}: retry taken {retried}, expected {retry}")
        rows = re.search(r"received rows max (\d+) mean ([0-9.]+)",
                         said[-1])
        log(f"[13] sharded count {tag}, k1=22, min_count 2, 8 shards of "
            f"cuda:0: keys, counts and rare keys equal to "
            f"count_canonical_kmers ({len(got[0])} solid, {len(got[2])} "
            f"rare); {t_mesh:.2f}s sharded vs {t_one:.2f}s single; "
            f"received rows a shard max {rows.group(1)} mean "
            f"{rows.group(2)}; retry {'taken' if retried else 'not taken'}")

    compare("isolate", lib.pool, lib.starts, retry=False)
    # one 24-bp read repeated: 3 distinct 22-mers, so each source shard
    # sends nearly all its rows to at most 3 owners
    read = np.random.default_rng(13).integers(0, 4, 24).astype(np.uint8)
    flat = np.tile(read, 200_000)
    starts = np.arange(0, len(flat) + 1, 24, dtype=np.int64)
    compare("repeated read (200,000 x 24 bp)", flat, starts, retry=True)


def _mesh_sort(torch, msgs) -> None:
    """[13] 2: the sample sort of 2^24 two-word rows over 8 virtual
    shards against torch.sort of the packed key."""
    import numpy as np

    from megahit_tpu_torch.core import kmerops
    from megahit_tpu_torch.parallel.multihost import Mesh
    from megahit_tpu_torch.parallel.shuffle import sharded_sort_kmers

    mesh = Mesh(["cuda:0"] * 8)
    rng = np.random.default_rng(17)
    n = 1 << 24
    uniform = rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(
        np.uint32)
    equal = np.tile(np.array([[5, 7]], np.uint32), (n, 1))

    def torch_sort(keys):
        t = kmerops.to_torch(keys, "cuda")
        (c,) = kmerops.pack_sort_keys([t[:, 0], t[:, 1]])
        s = torch.sort(c).values
        return kmerops.to_numpy(torch.stack(
            kmerops.unpack_sort_keys([s], 2), dim=1))

    cases = [("uniform", uniform, False), ("all equal", equal, False)]
    for tag, keys, retry in cases:
        want, t_torch = _timed(torch, lambda: torch_sort(keys))
        if tag == "uniform":
            # the same rows sorted: each shard holds one key range and
            # sends it to one owner, past the 2.5x capacity
            cases.append(("already sorted", want, True))
        del msgs.messages[:]
        got, t_mesh = _timed(torch, lambda: sharded_sort_kmers(keys, mesh))
        retried = any(m.startswith("sharded sort") and "retrying" in m
                      for m in msgs.messages)
        if not np.array_equal(got, want):
            fail(f"[13] sharded sort {tag} differs from torch.sort")
        if retried != retry:
            fail(f"[13] sharded sort {tag}: retry taken {retried}, "
                 f"expected {retry}")
        log(f"[13] sharded sort 2^24 x 2 words {tag}, 8 shards of cuda:0: "
            f"equal to torch.sort of the packed key; {t_mesh:.2f}s vs "
            f"torch.sort {t_torch:.2f}s (both host arrays in and out); "
            f"retry {'taken' if retried else 'not taken'}")


def _audit_cleaner(torch, keys, counts, mesh) -> dict:
    """[13] 3's size audit: the largest tensor any op creates in one
    remove_tips pass (and its refresh) and one iterate_local_low_depth
    call, on a fresh engine (mesh or not) from the k=21 graph; a weak
    link pass is audited too when the tip pass removes nothing."""
    from megahit_tpu_torch.graph.assemble_device import DeviceCleaner
    from megahit_tpu_torch.graph.cleaning import infer_min_depth
    from megahit_tpu_torch.graph.sdbg import remove_tips_sdbg, sdbg_from_edges
    from megahit_tpu_torch.graph.unitig import build_unitig_graph
    from megahit_tpu_torch.utils.audit import SizeAudit

    sdbg = sdbg_from_edges(keys, counts, 22, device="cuda")
    k = sdbg.k - 1
    remove_tips_sdbg(sdbg, 2 * k)
    min_depth = infer_min_depth(sdbg)
    eng = DeviceCleaner(build_unitig_graph(sdbg), mesh=mesh)
    if (eng.mesh is None) != (mesh is None):
        fail("[13] the audited cleaner did not take the 4-shard mesh")
    out = {"largest": 0, "passes": {}}
    steps = [("remove_tips", lambda: eng.remove_tips(2 * k))]
    for name, call in steps:
        with SizeAudit() as a:
            n = call()
        out["passes"][name] = (n, a.largest, a.op)
        out["largest"] = max(out["largest"], a.largest)
        if name == "remove_tips" and n == 0:
            steps.append(("disconnect_weak_links",
                          lambda: eng.disconnect_weak_links(0.1)))
    with SizeAudit() as a:
        n = eng.iterate_local_low_depth(min_depth, 2 * k, 1000, 0.1, True)
    out["passes"]["iterate_local_low_depth"] = (n, a.largest, a.op)
    out["largest"] = max(out["largest"], a.largest)
    out["e"], out["vc"] = eng.sdbg.size, eng.vc
    return out


def _mesh_cleaner(torch) -> None:
    """[13] 3: the cleaning engine split by owner rows over 4 virtual
    shards: assemble() equal to the unsharded engine's, the size audit,
    peak device memory, exchanges and seconds of both."""
    import numpy as np

    from megahit_tpu_torch.graph import assemble_device
    from megahit_tpu_torch.graph.sdbg import sdbg_from_edges
    from megahit_tpu_torch.parallel import multihost
    from megahit_tpu_torch.pipeline.assemble import (
        AssembleOptions, assemble,
    )

    z = np.load(os.path.join(DATA, "isolate_1pass", "tmp", "k21",
                             "k21.edges.npz"))
    keys, counts = z["keys"], z["counts"]
    made = []
    plain_cleaner = assemble_device.DeviceCleaner
    plain_mesh = multihost.global_shard_mesh

    class Recorded(plain_cleaner):
        def __init__(self, g, mesh=None):
            super().__init__(g, mesh=mesh)
            made.append(self)

    def run(use_mesh):
        sdbg = sdbg_from_edges(keys, counts, 22, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res, secs = _timed(torch, lambda: assemble(sdbg, AssembleOptions(
            min_standalone=300, prune_level=2, careful_bubble=True,
            use_mesh=use_mesh)))
        peak = torch.cuda.max_memory_allocated()

        def fmt(cs):
            return [(c.codes.tobytes(), c.flag, f"{c.multi:.4f}")
                    for c in cs]

        return (fmt(res.contigs), fmt(res.final_contigs),
                fmt(res.addi_contigs), fmt(res.bubbles), res.stats), secs, \
            peak

    assemble_device.DeviceCleaner = Recorded
    multihost.global_shard_mesh = lambda device: multihost.Mesh(
        ["cuda:0"] * 4)
    try:
        one, t_one, peak_one = run(False)
        torch.cuda.empty_cache()
        sharded, t_mesh, peak_mesh = run(True)
    finally:
        assemble_device.DeviceCleaner = plain_cleaner
        multihost.global_shard_mesh = plain_mesh
    if [e.mesh is not None for e in made] != [False, True]:
        fail("[13] the cleaner did not take the 4-shard mesh")
    for name, a, b in zip(("contigs", "finals", "addi", "bubbles",
                           "stats"), sharded, one):
        if a != b:
            fail(f"[13] 4-shard cleaner: {name} differ from the unsharded "
                 "device engine's")
    rows = made[1].rows
    gib = 1 << 30
    log(f"[13] cleaner split by owner rows over 4 shards of cuda:0 on "
        f"[11]'s k=21 graph (E {made[1].sdbg.size}, Vc {made[1].vc}): "
        f"{len(one[0])} contigs, {len(one[3])} bubbles and stats equal to "
        f"the unsharded engine; assemble {t_mesh:.2f}s sharded vs "
        f"{t_one:.2f}s; peak device memory {peak_mesh / gib:.3f} GiB vs "
        f"{peak_one / gib:.3f} GiB; {rows.exchanges} exchanges moving "
        f"{rows.bytes} bytes between shards")
    torch.cuda.empty_cache()
    mesh = multihost.Mesh(["cuda:0"] * 4)
    (audit, t_audit), (whole, t_whole) = (
        _timed(torch, lambda: _audit_cleaner(torch, keys, counts, m))
        for m in (mesh, None))
    ratio = audit["largest"] / whole["largest"]
    if ratio > 0.5:
        fail(f"[13] size audit: a shard's largest tensor is {ratio:.3f} of "
             "the unsharded engine's (limit 0.5)")
    log(f"[13] size audit, 4 shards of cuda:0, k=21 graph (E {audit['e']}"
        f"): largest tensor {audit['largest']} elements vs "
        f"{whole['largest']} unsharded, ratio {ratio:.3f} (limit 0.5); "
        f"passes (removed, largest, op) {audit['passes']} vs "
        f"{whole['passes']}; {t_audit:.1f}s and {t_whole:.1f}s audited")


MESH_CHILD = r"""
import json, os, sys, time
import torch
sys.path.insert(0, sys.argv[1])
from megahit_tpu_torch.parallel.multihost import init_distributed
init_distributed(coordinator=f"localhost:{sys.argv[2]}", num_processes=1,
                 process_id=0, device="cuda")
from torch.profiler import ProfilerActivity, profile
from megahit_tpu_torch.__main__ import main
from megahit_tpu_torch.core import kernels
kernels.canonical_all_kmers.launches = 0
kernels.count_sorted_runs.launches = 0
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.monotonic()
    rc = main(sys.argv[3:])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
busy = sum(e.self_device_time_total for e in prof.key_averages()
           if e.self_device_time_total > 0) / 1e6
print(json.dumps({"rc": rc, "wall": wall, "busy": busy,
                  "backend": str(torch.distributed.get_backend()),
                  "world": torch.distributed.get_world_size(),
                  "launches": {
                      "canonical_all_kmers": kernels.canonical_all_kmers.launches,
                      "count_sorted_runs": kernels.count_sorted_runs.launches}}))
torch.distributed.destroy_process_group()
"""


def _mesh_cli(torch, data) -> None:
    """[13] 4: the CLI with --mesh in a child process on NCCL at world
    size 1, against the same run without --mesh in this process."""
    import socket

    root = os.path.join(DATA, "mesh_cli")
    argv = ["-1", data["r1"], "-2", data["r2"], "--k-list", "21,41",
            "--no-local", "-f"]
    wall, launches, _, prof = _cuda_run(
        torch, argv + ["-o", os.path.join(root, "plain")])
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.self_device_time_total > 0) / 1e6
    del prof
    torch.cuda.empty_cache()
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    res = subprocess.run(
        [sys.executable, "-c", MESH_CHILD, HERE, str(port)] + argv
        + ["--device", "cuda", "--mesh", "-o", os.path.join(root, "mesh")],
        capture_output=True, text=True, timeout=400, cwd=HERE)
    if res.returncode != 0:
        fail(f"[13] the --mesh child failed:\n{res.stderr[-3000:]}")
    child = json.loads(res.stdout.strip().splitlines()[-1])
    with open(os.path.join(root, "mesh", "log")) as fh:
        text = fh.read()
    outs = []
    for name in ("plain", "mesh"):
        with open(os.path.join(root, name, "final.contigs.fa"), "rb") as f:
            outs.append(f.read())
    if outs[0] != outs[1] or not outs[0]:
        fail("[13] --mesh final.contigs.fa differs from the run without")
    if child["backend"] != "nccl" or child["world"] != 1 \
            or "mesh counting over 1 devices (nccl)" not in text:
        fail(f"[13] the --mesh run did not count over NCCL: {child}")
    if not re.search(r"k=41: ~\d+ multiset rows > budget \d+; bucketed",
                     text):
        fail("[13] the --mesh k=41 build did not take the bucketed route")
    log(f"[13] CLI --mesh --k-list 21,41 --no-local, NCCL at world size 1 "
        f"(child process): final.contigs.fa byte-identical to the run "
        f"without --mesh ({outs[0].count(b'>')} contigs); walls "
        f"{child['wall']:.1f}s --mesh vs {wall:.1f}s; idle share "
        f"{1 - child['busy'] / child['wall']:.1%} vs {1 - busy / wall:.1%}; "
        f"kernel 1, 2 launches {child['launches']} under --mesh (the "
        f"sharded count uses torch ops, as megahit_tpu's mesh count "
        f"reaches no Pallas kernel) vs {launches}")
    _log_stages("[13] --mesh", os.path.join(root, "mesh"))


def phase_mesh(torch, data) -> None:
    """[13] the mesh on the card: sharded count and sort over 8 virtual
    shards, the cleaner split by owner rows over 4, and the CLI's --mesh
    on NCCL."""
    from megahit_tpu_torch.utils.log import get_logger, setup_logging

    t0 = time.monotonic()
    setup_logging()  # console only
    msgs = _Messages()
    get_logger().addHandler(msgs)
    try:
        _mesh_count(torch, data, msgs)
        _mesh_sort(torch, msgs)
    finally:
        get_logger().removeHandler(msgs)
    _mesh_cleaner(torch)
    _mesh_cli(torch, data)
    log(f"[13] mesh phase {time.monotonic() - t0:.1f}s")


def phase_community_data(spec=COMMUNITY, tag="[14]") -> dict:
    """A community of scripts/make_community.py: spec is (cache directory
    under chip_smoke_data/, generator arguments); generated once."""
    name, args = spec
    d = os.path.join(DATA, name)
    manifest = os.path.join(d, "manifest.json")  # written last
    if not os.path.exists(manifest):
        t0 = time.monotonic()
        subprocess.run([sys.executable, os.path.join(
            HERE, "scripts", "make_community.py"), d] + list(args),
            check=True)
        log(f"{tag} generated the community in {time.monotonic() - t0:.1f}s")
    with open(manifest) as fh:
        genomes = json.load(fh)
    log(f"{tag} community: {len(genomes)} genomes, "
        f"{sum(g['bp'] for g in genomes)} bp of genome, "
        f"{sum(g['pairs'] for g in genomes)} pairs ({d})")
    return {"dir": d, "r1": os.path.join(d, "reads_1.fa"),
            "r2": os.path.join(d, "reads_2.fa"), "genomes": genomes}


def _community_kernels(torch, lib, tag="[14]", name="community"
                       ) -> list[dict]:
    """Kernels 1 and 2 at a community's shapes on the card, each against
    its plain version bit for bit: kernel 1 over the first 2^26-base
    chunk of the count's chunked branch, kernel 2 over the branch's
    sorted, sentinel-padded rows; times (CUDA events), byte bounds and,
    for kernel 2, torch.unique_consecutive."""
    from megahit_tpu_torch.core import kernels, kmerops
    from megahit_tpu_torch.graph import counter

    k1 = 22
    w = kmerops.words_per_kmer(k1)
    pool, starts = lib.pool, lib.starts

    _, sub, _ = next(counter._chunks(pool, starts, k1, COUNT_CHUNK))
    err1 = _parity_k1(torch, sub, k1)
    packed = torch.from_numpy(sub.view("int32")).cuda()
    n_out = kernels.q_padded(packed.shape[0], k1) * 16
    ms1 = cuda_ms(torch, lambda: kernels.canonical_all_kmers(packed, k1))
    plain1 = cuda_ms(
        torch, lambda: kernels.canonical_all_kmers_plain(packed, k1),
        iters=3, warm=1)
    bytes1 = packed.shape[0] * 4 + w * 4 * n_out
    bound1 = bytes1 / HBM_BYTES_PER_S * 1e3
    log(f"{tag} canonical_all_kmers k1={k1} over a {COUNT_CHUNK}-base chunk "
        f"({packed.shape[0]} words): {n_out} offsets, max_abs_err {err1}, "
        f"{ms1:.3f} ms (plain {plain1:.3f} ms), bound {bound1:.3f} ms "
        f"({bytes1} B), {bound1 / ms1:.1%} of bound")
    _k1_ops(torch, tag, packed, k1)
    del packed

    words, n_inv, n_chunks = counter._chunked_sorted_words(
        pool, starts, k1, COUNT_CHUNK, "cuda")
    cols = [kmerops.i32_bits(c) for c in words]
    del words
    n = cols[0].shape[0]
    torch.cuda.empty_cache()
    ms2 = cuda_ms(torch, lambda: kernels.count_sorted_runs(cols, n_inv))
    err2 = _parity_k2(torch, cols, n_inv)
    plain2 = cuda_ms(
        torch, lambda: kernels.count_sorted_runs_plain(cols, n_inv),
        iters=2, warm=1)
    torch.cuda.empty_cache()
    key = kmerops.pack_sort_keys([kmerops.u32_value(c) for c in cols])[0]
    lib2 = cuda_ms(torch, lambda: torch.unique_consecutive(
        key, return_counts=True), iters=3, warm=1)
    bytes2 = w * 4 * n + 5 * n
    bound2 = bytes2 / HBM_BYTES_PER_S * 1e3
    log(f"{tag} count_sorted_runs over the chunked branch's rows "
        f"({n_chunks} chunks): n={n}, n_inv={n_inv}, max_abs_err {err2}, "
        f"{ms2:.3f} ms (plain {plain2:.3f} ms, unique_consecutive "
        f"{lib2:.3f} ms), bound {bound2:.3f} ms ({bytes2} B), "
        f"{bound2 / ms2:.1%} of bound")
    del cols, key
    torch.cuda.empty_cache()
    if err1 or err2:
        fail(f"{tag} kernel parity at the community's shapes: "
             f"canonical_all_kmers {err1}, count_sorted_runs {err2}")
    return [
        {"name": f"canonical_all_kmers/{name}", "route": "cuda",
         "source": "megahit_tpu_torch/csrc/canonical_kmers.cu",
         "replaces": "megahit_tpu/core/pallas_kernels.py:105",
         "launches": 0, "max_abs_err": err1, "ms": ms1,
         "plain_ms": plain1, "bound_ms": bound1, "bound_by": "bytes",
         "library_ms": None},
        {"name": f"count_sorted_runs/{name}", "route": "cuda",
         "source": "megahit_tpu_torch/csrc/count_runs.cu",
         "replaces": "megahit_tpu/core/pallas_kernels.py:286",
         "launches": 0, "max_abs_err": err2, "ms": ms2,
         "plain_ms": plain2, "bound_ms": bound2, "bound_by": "bytes",
         "library_ms": lib2},
    ]


def _community_lib(comm, tag: str):
    """The community's reads as one SequenceLib (host)."""
    from megahit_tpu_torch.io.lib import build_lib

    t0 = time.monotonic()
    lib = build_lib([comm["r1"]], [comm["r2"]], [], [])
    log(f"{tag} build_lib: {lib.num_seqs} reads, {int(lib.starts[-1])} "
        f"read bases ({time.monotonic() - t0:.1f}s)")
    return lib


def _fasta_codes(path: str) -> list:
    """Each record of a FASTA file as uint8 codes (A, C, G, T = 0..3)."""
    import numpy as np

    lut = np.zeros(256, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    seqs, cur = [], []
    with open(path, "rb") as fh:
        for line in fh:
            if line.startswith(b">"):
                if cur:
                    seqs.append(lut[np.frombuffer(b"".join(cur), np.uint8)])
                cur = []
            else:
                cur.append(line.strip())
    if cur:
        seqs.append(lut[np.frombuffer(b"".join(cur), np.uint8)])
    return seqs


def _canonical_32mers(seqs):
    """Canonical 32-mers (2 bits a base in a u64) of every window of each
    sequence, as scripts/check_recovery.py counts them."""
    import numpy as np

    out = [np.zeros(0, np.uint64)]
    two = np.uint64(2)
    for c in seqs:
        n = len(c) - 31
        if n <= 0:
            continue
        c = c.astype(np.uint64)
        rc = (np.uint64(3) - c)[::-1]
        fw = np.zeros(n, np.uint64)
        rv = np.zeros(n, np.uint64)
        for j in range(32):
            fw = (fw << two) | c[j:j + n]
            rv = (rv << two) | rc[j:j + n]
        out.append(np.minimum(fw, rv[::-1]))
    return np.concatenate(out)


def _check_recall(tag: str, out: str, comm) -> dict:
    """Per-genome 32-mer recall of a run's contigs: every genome at
    RECALL_MIN_COV or more must reach RECALL_MIN, and the contig total
    stay at most TOTAL_MAX x the genome total."""
    import numpy as np

    from megahit_tpu_torch.graph.output import contig_stats

    contigs = _fasta_codes(os.path.join(out, "final.contigs.fa"))
    table = np.unique(_canonical_32mers(contigs))
    total = sum(len(c) for c in contigs)
    genome_total = sum(g["bp"] for g in comm["genomes"])
    low, recalls = [], []
    for g in comm["genomes"]:
        q = _canonical_32mers(_fasta_codes(os.path.join(
            comm["dir"], f"genome_{g['genome']}.fa")))
        i = np.minimum(np.searchsorted(table, q), len(table) - 1)
        rec = float((table[i] == q).mean()) if len(q) and len(table) else 0.0
        recalls.append(rec)
        log(f"{tag}   genome {g['genome']:>2}: {g['bp']} bp, cov "
            f"{g['cov']:.2f}x{', mobile' if g['mobile'] else ''}: 32-mer "
            f"recall {rec:.4f}")
        if g["cov"] >= RECALL_MIN_COV and rec < RECALL_MIN:
            low.append((g["genome"], g["cov"], rec))
    st = contig_stats(np.array([len(c) for c in contigs], np.int64))
    log(f"{tag} contigs: {len(contigs)}, total {total} bp (genome total "
        f"{genome_total} bp, limit {TOTAL_MAX} x), N50 {st['n50']} bp; "
        f"32-mer recall mean {np.mean(recalls):.4f}, worst "
        f"{min(recalls):.4f}")
    if low:
        fail(f"{tag} genomes at {RECALL_MIN_COV}x or more below recall "
             f"{RECALL_MIN}: {low}")
    if total > TOTAL_MAX * genome_total:
        fail(f"{tag} contig total {total} above {TOTAL_MAX} x {genome_total}")
    return {"contigs": len(contigs), "bp": total, "n50": st["n50"],
            "mean": float(np.mean(recalls)), "worst": min(recalls)}


def phase_community(torch) -> tuple[list[dict], dict, dict]:
    """[14] the community on the card: kernels 1 and 2 at its shapes,
    (a) --k-list 21 on cuda through the count's chunked branch, (b) the
    same on cpu, byte-identical, (c) the default k list on cuda, held to
    the genomes by 32-mer recall."""
    t_all = time.monotonic()
    comm = phase_community_data()
    kern = _community_kernels(torch, _community_lib(comm, "[14]"))
    reads = ["-1", comm["r1"], "-2", comm["r2"], "-f"]

    out_a = os.path.join(DATA, "community_k21")
    wall, launches_a, peak, prof = _cuda_run(
        torch, reads + ["--k-list", "21", "-o", out_a])
    log(f"[14] (a) community --k-list 21 on cuda: {wall:.1f}s wall, "
        f"launches {launches_a}, peak device memory {peak / 2**30:.2f} GiB")
    with open(os.path.join(out_a, "log")) as fh:
        m = re.search(r"count \(chunked\): (\d+) chunks of (\d+) bases, "
                      r"(\d+) windows padded to (\d+) rows -> (\d+) distinct"
                      r" canonical \d+-mers, (\d+) solid", fh.read())
    if not m or int(m.group(1)) < 3:
        fail("[14] (a) the count did not take the chunked branch in 3 or "
             "more chunks")
    log(f"[14] (a) count: chunked branch, {m.group(1)} chunks of "
        f"{m.group(2)} bases, {m.group(3)} windows padded to {m.group(4)} "
        f"rows, {m.group(5)} distinct and {m.group(6)} solid keys")
    _device_profile("[14] (a)", prof, wall)
    del prof
    _log_stages("[14] (a)", out_a)
    _check_cleaning("[14] (a)", out_a)
    if launches_a["canonical_all_kmers"] < 3 \
            or launches_a["count_sorted_runs"] < 1:
        fail(f"[14] (a) kernel launches {launches_a}: kernel 1 needs 3 or "
             "more, kernel 2 one or more")

    out_b = os.path.join(DATA, "community_k21_cpu")
    t0 = time.monotonic()
    _run_cli(reads + ["--k-list", "21", "--device", "cpu", "-o", out_b])
    wall_b = time.monotonic() - t0
    with open(os.path.join(out_a, "final.contigs.fa"), "rb") as f:
        a = f.read()
    with open(os.path.join(out_b, "final.contigs.fa"), "rb") as f:
        b = f.read()
    if a != b or not a:
        fail("[14] (b) community final.contigs.fa differs between cpu and "
             "cuda")
    log(f"[14] (b) community --k-list 21 on cpu: {wall_b:.1f}s wall, "
        f"final.contigs.fa byte-identical to (a)'s ({a.count(b'>')} "
        "contigs)")
    _log_stages("[14] (b)", out_b)
    _log_split("[14] (a) | (b)", out_a, out_b)

    launches_c = _community_ladder(torch, comm)
    log(f"[14] community phase {time.monotonic() - t_all:.1f}s")
    return kern, launches_a, launches_c


def _community_ladder(torch, comm) -> dict:
    """[14] (c): the community with the default k list on cuda, every
    rung cleaned on the device, held to the genomes by 32-mer recall.
    Returns the kernel launches."""
    out_c = os.path.join(DATA, "community_ladder")
    torch.cuda.empty_cache()
    wall, launches_c, peak, prof = _cuda_run(
        torch, ["-1", comm["r1"], "-2", comm["r2"], "-f", "-o", out_c])
    log(f"[14] (c) community, default k list on cuda: {wall:.1f}s wall, "
        f"launches {launches_c}, peak device memory {peak / 2**30:.2f} GiB")
    _device_profile("[14] (c)", prof, wall)
    del prof
    if launches_c["canonical_all_kmers"] < 3 \
            or launches_c["count_sorted_runs"] < 1:
        fail(f"[14] (c) kernel launches {launches_c}: kernel 1 needs 3 or "
             "more, kernel 2 one or more")
    _check_run("[14] (c)", out_c, comm)
    return launches_c



CLI_CHILD = r"""
import json, resource, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as c
wall, launches, peak, prof = c._cuda_run(torch, json.loads(sys.argv[2]))
busy = c._device_profile(sys.argv[3], prof, wall)
print(json.dumps({"wall": wall, "launches": launches, "peak": peak,
                  "busy": busy, "maxrss": resource.getrusage(
                      resource.RUSAGE_SELF).ru_maxrss * 1024}))
"""


def _child_cli(tag: str, argv: list[str], what: str) -> dict:
    """The CLI on cuda in a child process (so its ru_maxrss is its own),
    through _cuda_run: the kernel counters set to 0 just before and read
    just after, the device's idle share. Returns the child's numbers
    (wall, launches, peak device bytes, busy seconds, maxrss bytes)."""
    res = subprocess.run(
        [sys.executable, "-c", CLI_CHILD, HERE, json.dumps(argv), tag],
        stdout=subprocess.PIPE, text=True, timeout=3300, cwd=HERE)
    lines = res.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(line)
    if res.returncode != 0:
        fail(f"{tag} the CLI child exited {res.returncode}")
    child = json.loads(lines[-1])
    log(f"{tag} {what} on cuda (child process): {child['wall']:.1f}s wall, "
        f"launches {child['launches']} (the 1-pass route reaches no kernel, "
        f"as megahit_tpu's bucketed build reaches no Pallas kernel), peak "
        f"device memory {child['peak'] / 2**30:.2f} GiB, peak host memory "
        f"(ru_maxrss) {child['maxrss'] / 2**30:.2f} GiB")
    return child


def _onepass_build(tag: str, out: str, mercy: bool) -> dict:
    """The 1-pass k=21 build in a run's log: rows spilled, each round's
    rows, seconds and sort seconds, edges; a first_graph.mercy phase must
    have run if and only if `mercy`. Returns the rows spilled and each
    round's rows."""
    with open(os.path.join(out, "log")) as fh:
        text = fh.read()
    spill = re.search(r"bucketed build k=22: (\d+) rows spilled in "
                      r"([0-9.]+)s, (\d+) rounds \(budget (\d+)\)", text)
    built = re.search(r"k=21 \(1-pass\): (\d+) edges, (\d+) rounds \(max "
                      r"(\d+) rows\)", text)
    if not spill or not built:
        fail(f"{tag} the k=21 graph was not built by the 1-pass route")
    # the k=22 build's rounds (a later rung may build out of core too)
    rounds = re.findall(r"bucketed round \d+/\d+ .*: (\d+) rows, (\d+) "
                        r"edges, ([0-9.]+)s \(sort ([0-9.]+)s\)",
                        text[spill.end():built.start()])
    ran = re.search(r"mercy: (\d+) gap windows -> (\d+) distinct mercy "
                    r"edges", text)
    if ("first_graph.mercy" in text) != mercy or (ran is None) == mercy:
        fail(f"{tag} a mercy phase " + ("did not run" if mercy else
                                        "ran under min_count 1"))
    log(f"{tag} 1-pass k=21 build: {spill.group(1)} rows spilled in "
        f"{spill.group(2)}s, {spill.group(3)} rounds (budget "
        f"{spill.group(4)} rows; largest {built.group(3)} rows), "
        f"{built.group(1)} edges; rounds: " + ", ".join(
            f"{r} rows {t}s (sort {u}s)" for r, _, t, u in rounds)
        + (f"; mercy: {ran.group(1)} gap windows, {ran.group(2)} mercy "
           "edges" if mercy else "; no mercy phase"))
    return {"spilled": int(spill.group(1)),
            "rounds": [int(r) for r, _, _, _ in rounds]}


def _check_run(tag: str, out: str, comm) -> dict:
    """A community run's rungs, stages and assemble split, every rung
    cleaned on the device, and its contigs held to the genomes
    (_check_recall)."""
    _log_rungs(tag, out)
    _log_stages(tag, out)
    split = _assemble_split(out)
    log(f"{tag} assemble split summed over rungs: " + ", ".join(
        f"{name} {split.get(name, 0.0):.2f}s" for name in (
            "sdbg_tips", "unitig_build", "cleaning_rounds", "prune_output")))
    _check_cleaning(tag, out)
    return _check_recall(tag, out, comm)


def _meta_flags(k_list) -> list[str]:
    """[15]'s run: the preset's own flags, or with a k list its first
    rungs (min_count 1 sets the 1-pass build and no mercy, as the preset
    does)."""
    if k_list is None:
        return ["--presets", "meta-sensitive"]
    return ["--min-count", "1", "--k-list", k_list]


def _meta_cli(torch, comm, k_list) -> tuple[str, dict]:
    """[15] (b): the CLI under the preset on cuda in a child process (so
    its ru_maxrss is its own, not [14]'s), with the kernel counters set
    to 0 just before and read just after; options.json must be the
    preset's but for the k list, and the log must show the 1-pass build,
    no mercy and the device engine at every rung. Returns the output
    directory and the child's numbers."""
    from dataclasses import asdict

    from megahit_tpu_torch.__main__ import make_parser, options_from_args

    out = os.path.join(DATA, "community_meta")
    base = ["-1", comm["r1"], "-2", comm["r2"], "-f", "--keep-tmp-files",
            "-o", out]
    child = _child_cli("[15] (b)", base + _meta_flags(k_list),
                       f"community {' '.join(_meta_flags(k_list))}")

    want = options_from_args(make_parser().parse_args(
        base + ["--presets", "meta-sensitive", "--device", "cuda"]))
    want.validate()
    with open(os.path.join(out, "options.json")) as fh:
        got = json.load(fh)
    differ = sorted(k for k, v in asdict(want).items() if got.get(k) != v)
    # validate() derives k_max from the k list
    if not set(differ) <= ({"k_list", "auto_k", "k_max"} if k_list else
                           set()):
        fail(f"[15] (b) options.json differs from the preset's in {differ}")
    log(f"[15] (b) options.json equal to --presets meta-sensitive's but "
        f"for {differ or 'nothing'}")

    child["spilled"] = _onepass_build("[15] (b)", out, mercy=False)["spilled"]
    _check_run("[15] (b)", out, comm)
    return out, child


def _meta_graph(torch, comm, out) -> dict:
    """[15] (a): the 1-pass k=21 graph that (b) kept (nav-form
    tmp/k21/k21.sdbg.npz) against the count route on cuda at min_count
    1 (the chunked branch: kernel 1 a chunk, one torch.sort, kernel 2)
    and sdbg_from_edges: every Sdbg array equal. The kernel counters are
    set to 0 just before the count and read just after. Returns the
    launches and the count's windows."""
    import numpy as np

    from megahit_tpu_torch.core import kernels
    from megahit_tpu_torch.graph.counter import count_canonical_kmers
    from megahit_tpu_torch.graph.sdbg import Sdbg, sdbg_from_edges
    from megahit_tpu_torch.io.lib import build_lib
    from megahit_tpu_torch.utils.log import get_logger, setup_logging

    lib = build_lib([comm["r1"]], [comm["r2"]], [], [])
    setup_logging()  # console only
    msgs = _Messages()
    get_logger().addHandler(msgs)
    try:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        kernels.canonical_all_kmers.launches = 0
        kernels.count_sorted_runs.launches = 0
        keys, counts = count_canonical_kmers(
            lib.pool, lib.starts, 22, 1, batch_windows=COUNT_CHUNK,
            device="cuda")
        torch.cuda.synchronize()
        launches = {
            "canonical_all_kmers": kernels.canonical_all_kmers.launches,
            "count_sorted_runs": kernels.count_sorted_runs.launches}
        t_count = time.monotonic() - t0
    finally:
        get_logger().removeHandler(msgs)
    m = next((re.search(r"count \(chunked\): (\d+) chunks of \d+ bases, "
                        r"(\d+) windows padded to (\d+) rows", x)
              for x in msgs.messages if x.startswith("count (chunked)")),
             None)
    if not m:
        fail("[15] (a) the count did not take the chunked branch")
    t0 = time.monotonic()
    want = sdbg_from_edges(keys, counts, 22, device="cuda")
    t_edges = time.monotonic() - t0
    got = Sdbg.load(os.path.join(out, "tmp", "k21", "k21.sdbg.npz"),
                    device="cuda")
    if (got.k, got.real, got.size) != (want.k, want.real, want.size):
        fail(f"[15] (a) 1-pass graph (k, real, size) "
             f"{(got.k, got.real, got.size)} != count route's "
             f"{(want.k, want.real, want.size)}")
    for name in ("keys", "mult", "valid", "run_start", "nxt_link", "rc"):
        if not np.array_equal(np.asarray(getattr(got, name)),
                              np.asarray(getattr(want, name))):
            fail(f"[15] (a) Sdbg.{name} differs between the 1-pass graph "
                 "and the count route's")
    log(f"[15] (a) 1-pass k=21 graph equal to count_canonical_kmers("
        f"min_count=1, cuda) + sdbg_from_edges in every Sdbg array (keys, "
        f"mult, valid, run_start, nxt_link, rc): {got.real} edges, "
        f"{len(keys)} canonical keys, capacity {got.size}; count "
        f"{t_count:.1f}s ({m.group(1)} chunks, {m.group(2)} windows padded "
        f"to {m.group(3)} rows; launches {launches}), sdbg_from_edges "
        f"{t_edges:.1f}s")
    if launches["canonical_all_kmers"] < 3 \
            or launches["count_sorted_runs"] < 1:
        fail(f"[15] (a) kernel launches {launches}: kernel 1 needs 3 or "
             "more, kernel 2 one or more")
    return {"launches": launches, "windows": int(m.group(2))}


def phase_meta(torch, k_list=META_K_LIST) -> dict:
    """[15] the community under --presets meta-sensitive (k_list=None:
    all its rungs; else --min-count 1 with that k list): (b) the CLI on
    cuda, then (a) its kept k=21 graph against the count route. The
    1-pass build must spill two rows (both strands) for every window the
    count sees. Returns (a)'s kernel launches."""
    t_all = time.monotonic()
    comm = phase_community_data()
    torch.cuda.empty_cache()
    out, child = _meta_cli(torch, comm, k_list)
    graph = _meta_graph(torch, comm, out)
    torch.cuda.empty_cache()
    if child["spilled"] != 2 * graph["windows"]:
        fail(f"[15] the 1-pass build spilled {child['spilled']} rows, not "
             f"2 x the count's {graph['windows']} windows")
    log(f"[15] rows spilled {child['spilled']} = 2 x the count's "
        f"{graph['windows']} windows; meta phase "
        f"{time.monotonic() - t_all:.1f}s")
    return graph["launches"]


def phase_cpu_ladders(k_list=META_K_LIST) -> None:
    """The community's default ladder ([14] (c)) and [15] (b)'s run again
    on cpu: each final.contigs.fa must be byte-identical to its cuda
    run's. Needs both cuda runs' outputs from the same command; kept out
    of main() for its time (README)."""
    comm = phase_community_data()
    for tag, name, flags in (
            ("default k list", "community_ladder", []),
            (" ".join(_meta_flags(k_list)), "community_meta",
             _meta_flags(k_list))):
        out = os.path.join(DATA, name + "_cpu")
        t0 = time.monotonic()
        _run_cli(["-1", comm["r1"], "-2", comm["r2"], "--device", "cpu",
                  "-f", "-o", out] + flags)
        wall = time.monotonic() - t0
        with open(os.path.join(DATA, name, "final.contigs.fa"), "rb") as f:
            a = f.read()
        with open(os.path.join(out, "final.contigs.fa"), "rb") as f:
            b = f.read()
        if a != b or not a:
            fail(f"community {tag}: final.contigs.fa differs between cpu "
                 "and cuda")
        log(f"[cpu] community {tag} on cpu: {wall:.1f}s wall, "
            f"final.contigs.fa byte-identical to the cuda run's "
            f"({a.count(b'>')} contigs)")
        _log_rungs(f"[cpu] {name}", out)
        _log_stages(f"[cpu] {name}", out)
        _log_split(f"[cpu] {name}", os.path.join(DATA, name), out)



# [16] (b): megahit_tpu's flags for its 100-genome run, at the default
# min_count 2 (1-pass build, then mercy over the 1-pass graph)
K_LIST100 = "21,41,61"
# 1.39e9 spilled rows in rounds of at most round_cap_rows() = 2^26
MIN_ROUNDS100 = 21
# megahit_tpu's own record (RESULTS.md:120-126), printed beside [16] (b)
RECORD100 = ("megahit_tpu's record on its own 100-genome read set of the "
             "same shape (RESULTS.md:124-126; not a limit): 1.386e9 rows "
             "in 22 rounds, maxrss 21 GB, 2622.9 s, 8,615 contigs, 43.96 "
             "Mbp, N50 150,392, 32-mer recall mean 96.09%, worst 77.25%")


def _k21_multiplicity(keys, counts) -> int:
    """Total valid multiplicity of the k=21 graph that `keys`, `counts`
    (canonical edges) finalize to: both strands, a palindrome once."""
    import numpy as np

    from megahit_tpu_torch.graph.bucketed import np_revcomp

    pal = (np_revcomp(keys, 22) == keys).all(axis=1)
    c = counts.astype(np.int64)
    return int(2 * c.sum() - c[pal].sum())


def _community100_cli(torch, comm, k_list=K_LIST100) -> dict:
    """[16] (b): the CLI on cuda in a child process with megahit_tpu's
    flags (--k-list 21,41,61 --kmin-1pass, min_count 2; k_list="21" cuts
    it to the first rung for (c)): the 1-pass k=21 build in
    MIN_ROUNDS100 or more rounds of at most round_cap_rows(), mercy over
    the 1-pass graph, every rung cleaned on the device (the k=21 total
    multiplicity printed beside the device engine's 2^31 bound), the
    contigs held to the genomes. Returns
    the child's numbers and the rows spilled."""
    from megahit_tpu_torch.graph.bucketed import round_cap_rows

    import numpy as np

    tag = "[16] (b)"
    out = os.path.join(DATA, "community100")
    torch.cuda.empty_cache()
    child = _child_cli(tag, [
        "-1", comm["r1"], "-2", comm["r2"], "--k-list", k_list,
        "--kmin-1pass", "-f", "--keep-tmp-files", "-o", out],
        f"100-genome community --k-list {k_list} --kmin-1pass")
    built = _onepass_build(tag, out, mercy=True)
    rounds, cap = built["rounds"], round_cap_rows()
    if len(rounds) < MIN_ROUNDS100 or max(rounds) > cap:
        fail(f"{tag} {len(rounds)} rounds, the largest {max(rounds)} rows: "
             f"{MIN_ROUNDS100} or more of at most {cap} rows expected")
    z = np.load(os.path.join(out, "tmp", "k21", "k21.edges.npz"))
    total = _k21_multiplicity(z["keys"], z["counts"])
    log(f"{tag} {len(rounds)} rounds of at most {max(rounds)} rows (cap "
        f"{cap}); k=21 total valid multiplicity {total} "
        f"({total / 2**31:.3f} x 2^31, the device engine's bound)")
    st = _check_run(tag, out, comm)
    log(f"{tag} summary: {child['wall']:.1f}s wall, idle share "
        f"{1 - child['busy'] / child['wall']:.1%}, peak device "
        f"{child['peak'] / 2**30:.2f} GiB, peak host "
        f"{child['maxrss'] / 2**30:.2f} GiB; {built['spilled']} rows in "
        f"{len(rounds)} rounds; {st['contigs']} contigs, {st['bp']} bp, N50 "
        f"{st['n50']}, recall mean {st['mean']:.2%}, worst "
        f"{st['worst']:.2%}")
    log(f"{tag} {RECORD100}")
    return {"out": out, "spilled": built["spilled"], **child}


def _community100_count(torch, comm, b) -> None:
    """[16] (a), after (b) has exited: count_canonical_kmers(min_count=2)
    on cuda over the same reads, the chunked branch at its 2^30-row
    ceiling, with the kernel counters set to 0 just before and read just
    after (kernel 1 once a chunk, 12 or more; kernel 2 once or more): its
    solid keys and counts must equal the canonical solid rows of (b)'s
    1-pass graph (the head of tmp/k21/k21.edges.npz; mercy rows, count
    1, follow). Then kernels 1 and 2 at those shapes."""
    import numpy as np

    from megahit_tpu_torch.core import kernels
    from megahit_tpu_torch.graph.counter import (
        count_canonical_kmers, num_windows)
    from megahit_tpu_torch.utils.log import get_logger, setup_logging

    tag = "[16] (a)"
    lib = _community_lib(comm, tag)
    windows = num_windows(lib.starts, 22)
    if b["spilled"] != 2 * windows:
        fail(f"[16] (b) spilled {b['spilled']} rows, not 2 x the reads' "
             f"{windows} windows at k1 = 22")
    log(f"[16] (b) rows spilled {b['spilled']} = 2 x the reads' {windows} "
        "windows at k1 = 22")
    z = np.load(os.path.join(b["out"], "tmp", "k21", "k21.edges.npz"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    setup_logging()  # console only
    msgs = _Messages()
    get_logger().addHandler(msgs)
    try:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        kernels.canonical_all_kmers.launches = 0
        kernels.count_sorted_runs.launches = 0
        keys, counts = count_canonical_kmers(
            lib.pool, lib.starts, 22, 2, batch_windows=COUNT_CHUNK,
            device="cuda")
        torch.cuda.synchronize()
        launches = {
            "canonical_all_kmers": kernels.canonical_all_kmers.launches,
            "count_sorted_runs": kernels.count_sorted_runs.launches}
        t_count = time.monotonic() - t0
    finally:
        get_logger().removeHandler(msgs)
    peak = torch.cuda.max_memory_allocated()
    info = next((x for x in msgs.messages
                 if x.startswith("count (chunked)")), "")
    m = re.search(r"(\d+) chunks of \d+ bases, (\d+) windows padded to "
                  r"(\d+) rows", info)
    if not m:
        fail(f"{tag} the count did not take the chunked branch")
    n_chunks = int(m.group(1))
    if launches["canonical_all_kmers"] != n_chunks or n_chunks < 12 \
            or launches["count_sorted_runs"] < 1:
        fail(f"{tag} kernel launches {launches} over {n_chunks} chunks: "
             "kernel 1 once a chunk (12 or more), kernel 2 one or more")
    n = len(keys)
    if not (np.array_equal(keys, z["keys"][:n])
            and np.array_equal(counts, z["counts"][:n])):
        fail(f"{tag} the count's {n} solid keys and counts differ from "
             "(b)'s 1-pass graph's canonical solid rows")
    mercy = z["counts"][n:]
    if len(mercy) and mercy.max() != 1:
        fail(f"{tag} rows after the solid ones in k21.edges.npz are not "
             "mercy edges (count 1)")
    log(f"{tag} count_canonical_kmers(min_count=2, cuda): {t_count:.1f}s, "
        f"{info}; launches {launches}; peak device memory "
        f"{peak / 2**30:.2f} GiB ({peak} B); its {n} solid keys and counts "
        f"equal (b)'s 1-pass graph's canonical solid rows ({len(mercy)} "
        "mercy rows follow)")
    del keys, counts, z
    torch.cuda.empty_cache()
    kern = _community_kernels(torch, lib, tag, "community100")
    for kd in kern:
        kd["launches"] = launches[kd["name"].split("/")[0]]
    log(f"{tag} kernels {json.dumps(kern)}")


def phase_community100(torch) -> None:
    """[16] megahit_tpu's 100-genome --kmin-1pass run (RESULTS.md:120-129)
    on the card: (b) the CLI on cuda in a child process, then (a) the
    count route at its 2^30-row ceiling against (b)'s 1-pass graph. Kept
    out of main() for its time (README)."""
    t_all = time.monotonic()
    comm = phase_community_data(COMMUNITY100, "[16]")
    genome = sum(g["bp"] for g in comm["genomes"])
    bases = sum(2 * g["pairs"] * 150 for g in comm["genomes"])
    df = subprocess.run(["df", "-h", comm["dir"]], capture_output=True,
                        text=True).stdout.strip().splitlines()[-1]
    deep = sum(g["cov"] >= RECALL_MIN_COV for g in comm["genomes"])
    log(f"[16] {genome} bp of genome, {bases} read bases (megahit_tpu's "
        f"record: 45.4 Mbp, 806 Mbp); {deep} genomes at {RECALL_MIN_COV}x "
        f"or more; df: {df}")
    b = _community100_cli(torch, comm)
    torch.cuda.empty_cache()
    _community100_count(torch, comm, b)
    log(f"[16] phase {time.monotonic() - t_all:.1f}s")


def phase_community100_cpu(k_list=K_LIST100) -> None:
    """[16] (c): (b)'s run again on cpu: final.contigs.fa byte-identical
    and tmp/k21/k21.edges.npz equal array by array (the cpu rounds sort
    on the host: an independent sort of the same rows). Needs (b)'s
    output from the same command (_community100_cli with the same
    k_list); kept out of main() for its time (README)."""
    import numpy as np

    comm = phase_community_data(COMMUNITY100, "[16]")
    a, b = os.path.join(DATA, "community100"), os.path.join(
        DATA, "community100_cpu")
    t0 = time.monotonic()
    _run_cli(["-1", comm["r1"], "-2", comm["r2"], "--k-list", k_list,
              "--kmin-1pass", "-f", "--keep-tmp-files", "--device", "cpu",
              "-o", b])
    wall = time.monotonic() - t0
    with open(os.path.join(a, "final.contigs.fa"), "rb") as f:
        fa = f.read()
    with open(os.path.join(b, "final.contigs.fa"), "rb") as f:
        fb = f.read()
    if fa != fb or not fa:
        fail("[16] (c) final.contigs.fa differs between cpu and cuda")
    za, zb = (np.load(os.path.join(d, "tmp", "k21", "k21.edges.npz"))
              for d in (a, b))
    bad = sorted(set(za.files) ^ set(zb.files)) + [
        f for f in za.files if f in zb.files and (
            za[f].dtype != zb[f].dtype or not np.array_equal(za[f], zb[f]))]
    if bad:
        fail(f"[16] (c) k21.edges.npz differs between cpu and cuda: {bad}")
    log(f"[16] (c) --k-list {k_list} --kmin-1pass on cpu: {wall:.1f}s "
        f"wall; final.contigs.fa byte-identical to (b)'s ({fa.count(b'>')} "
        f"contigs), k21.edges.npz equal array by array ({len(za['keys'])} "
        "rows)")
    _onepass_build("[16] (c)", b, mercy=True)
    _log_stages("[16] (c)", b)
    _log_split("[16] (b) | (c)", a, b)


def phase_diff(flags=()) -> list[str]:
    """Bisects a cuda/cpu difference by rung: the community with `flags`
    on both devices, every intermediate kept, then each intermediate
    contig file (byte for byte, with its first differing line) and each
    rung's edge file (array by array) compared in rung order. Prints and
    returns the names that differ. Not in main() (README)."""
    import numpy as np

    comm = phase_community_data()
    outs = {dev: os.path.join(DATA, f"diff_{dev}") for dev in ("cuda", "cpu")}
    for dev, out in outs.items():
        _run_cli(["-1", comm["r1"], "-2", comm["r2"], "--device", dev, "-f",
                  "--keep-tmp-files", "-o", out] + list(flags))

    def rung(name):
        m = re.search(r"k(\d+)", os.path.basename(name))
        return (int(m.group(1)) if m else 1 << 30, name)

    names = sorted((os.path.relpath(os.path.join(d, f), outs["cuda"])
                    for d, _, fs in os.walk(outs["cuda"]) for f in fs
                    if f.endswith((".fa", ".npz"))), key=rung)
    differ = []
    for name in names:
        a, b = (os.path.join(outs[dev], name) for dev in ("cuda", "cpu"))
        if not os.path.exists(b):
            same, detail = False, "absent on cpu"
        elif name.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            bad = [f for f in za.files if f not in zb.files
                   or za[f].dtype != zb[f].dtype
                   or not np.array_equal(za[f], zb[f])]
            same, detail = not bad, f"arrays {bad}"
        else:
            with open(a) as fa, open(b) as fb:
                la, lb = fa.read().splitlines(), fb.read().splitlines()
            i = next((i for i, (x, y) in enumerate(zip(la, lb)) if x != y),
                     min(len(la), len(lb)))
            same = la == lb
            detail = (f"{sum(x.startswith('>') for x in la)} | "
                      f"{sum(x.startswith('>') for x in lb)} records; "
                      f"first difference at line {i + 1}: "
                      f"{la[i][:60] if i < len(la) else '-'} | "
                      f"{lb[i][:60] if i < len(lb) else '-'}")
        if not same:
            differ.append(name)
            log(f"[diff] {name} differs, cuda | cpu: {detail}")
    log(f"[diff] community {' '.join(flags) or 'default k list'}: "
        f"{len(differ)} of {len(names)} intermediate files differ between "
        "cuda and cpu")
    return differ


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import megahit_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: megahit_tpu_torch not found next to this "
              f"script ({e})", file=sys.stderr)
        return 2
    t0 = time.monotonic()
    spans = []

    def timed(tag, fn, *args):
        t = time.monotonic()
        out = fn(*args)
        spans.append(f"{tag} {time.monotonic() - t:.1f}s")
        return out

    card = timed("[1]", phase_card, torch)
    timed("[2]", phase_build)
    data = timed("[3]", phase_data)
    kern = timed("[4] kernels 1, 2", phase_kernels, torch, data)
    sort_kern = timed("[4] kernels 3, 4", phase_sortnet, torch)
    timed("[5]", phase_fixtures)
    launches = timed("[6]", phase_main_path, torch, data)
    timed("[7]", phase_cpu_match, data)
    ladder = timed("[8]", phase_ladder, torch, data)
    timed("[11]", phase_out_of_core, data)
    timed("[10]", phase_engines, torch)
    stages = timed("[12]", phase_stages, torch, data)
    timed("[13]", phase_mesh, torch, data)
    torch.cuda.empty_cache()
    comm_kern, comm_a, comm_c = timed("[14]", phase_community, torch)
    torch.cuda.empty_cache()
    meta = timed("[15]", phase_meta, torch)
    for kd in kern:
        kd["launches"] = launches[kd["name"]]
        kd["ladder_launches"] = ladder[kd["name"]]
        kd["stage_launches"] = stages[kd["name"]]
    for kd in comm_kern:
        name = kd["name"].split("/")[0]
        kd["launches"] = comm_a[name]
        kd["ladder_launches"] = comm_c[name]
        kd["meta_launches"] = meta[name]
    kern += sort_kern + comm_kern
    mods = sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.")
                  or m == "megahit_tpu" or m.startswith("megahit_tpu."))
    if mods:
        fail(f"JAX or the JAX package was imported: {mods[:5]}")
    log(f"[9] total {time.monotonic() - t0:.1f}s ({', '.join(spans)})")
    print(card)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
