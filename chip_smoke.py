#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (megahit_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. the card (nvidia-smi name and power limit) and the torch/CUDA/nvcc
   versions;
2. build the CUDA kernels (one nvcc per source, in parallel) and the
   host C++ helpers from this checkout;
3. a bacterial-isolate read set: Illumina-like paired FASTQ from
   scripts/make_realistic.py (2 Mbp genome, 30x, seed 1; cached in
   chip_smoke_data/);
4. kernel parity on the card, each kernel against its plain PyTorch
   version, exact equality: at the main path's shapes (the isolate's
   pool at k1=22), at k1 in {32, 42, 56}, and (kernel 2) the main
   path's n as one run (every tile but the first headless: the longest
   look-ahead chain) and odd n with sentinel rows and one run spanning
   many tiles; with each kernel's time, byte bound and library
   yardstick, and kernel 2's device work per call (torch.profiler: one
   kernel launch and at most one memset, else the phase fails); and
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
   (from [11]'s edge file: its solid edges and mercy) assembled on cuda with the device engine and with the host
   engine, with careful bubbles at prune level 2 and 3, final round and
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
   600000000 on cuda equal to count + seq2sdbg (valid keys and
   multiplicities); the k=21 graph (4.07M rows) through
   save_sharded(rows_per_shard=2^20) (at least 2 shards), load_sharded
   and load_sharded_rows over two bucket ranges, equal; checkcpu and
   checknative each print 1; the link probe's milliseconds (it must keep
   the device engine); the fixtures
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
9. (printed last) the script's total seconds.

It then prints the card line, one JSON line with every kernel's numbers
(kernels 1, 2 with the launches of [6] and, as ladder_launches, of [8]
and, as stage_launches, of [12]'s count stage), and as its last line
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
GENOME_BP = 2_000_000
COVERAGE = 30
# H100 SXM memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
# batch of the chunked count check (the isolate's pool is 4 batches)
CHUNK = 1 << 24
# -m bytes of the 1-pass run in [11]: 16.7M rows a round at k1=22, so the
# isolate's ~104M spilled rows take more than 4 rounds
ONEPASS_MEMORY = 600_000_000


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


def _parity_k1(torch, words_np, k1: int) -> int:
    """kernel 1 vs plain at k1 on the card -> max |difference|."""
    from megahit_tpu_torch.core import kernels

    packed = torch.from_numpy(words_np.view("int32")).cuda()
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
    for kk in (32, 42, 56):
        e = _parity_k1(torch, words_np[: (1 << 20) + 8], kk)
        log(f"[4] canonical_all_kmers k1={kk}: max_abs_err {e}")
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
    n_set = sum(c for name, _, c in ops if "memset" in name.lower())
    if sum(c for _, _, c in ops) - n_set != 1 or n_set > 1:
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


def _device_profile(tag: str, prof, wall: float) -> None:
    ops = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in ops) / 1e6
    log(f"{tag} device busy {busy:.3f}s of {wall:.1f}s wall "
        f"(idle share {1 - busy / wall:.1%}), "
        f"{sum(e.count for e in ops)} device ops")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"{tag}   device {e.self_device_time_total / 1e3:.2f} ms "
            f"x{e.count}: {e.key[:70]}")


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
    """The `assemble split` seconds of a run's log, summed over rungs."""
    split: dict[str, float] = {}
    with open(os.path.join(out, "log")) as fh:
        for line in fh:
            m = re.search(r"assemble split: (.*)$", line)
            if m:
                for name, secs in re.findall(r"(\w+) ([0-9.]+)s",
                                             m.group(1)):
                    split[name] = split.get(name, 0.0) + float(secs)
    return split


def _log_split(tag: str, out_cuda: str, out_cpu: str) -> None:
    a, b = _assemble_split(out_cuda), _assemble_split(out_cpu)
    log(f"{tag} assemble split summed over rungs, cuda | cpu: " + ", ".join(
        f"{name} {a.get(name, 0.0):.2f} | {b.get(name, 0.0):.2f}s"
        for name in ("sdbg_tips", "unitig_build", "cleaning_rounds",
                     "prune_output")))


def phase_main_path(torch, data) -> dict:
    from megahit_tpu_torch.core import kernels

    from torch.profiler import ProfilerActivity, profile

    out = os.path.join(DATA, "isolate_out")
    torch.cuda.reset_peak_memory_stats()
    kernels.canonical_all_kmers.launches = 0
    kernels.count_sorted_runs.launches = 0
    # device activity only (CUPTI): the host side runs unrecorded
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        _run_cli(["-1", data["r1"], "-2", data["r2"], "--k-list", "21",
                  "--device", "cuda", "-f", "-o", out])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    launches = {"canonical_all_kmers": kernels.canonical_all_kmers.launches,
                "count_sorted_runs": kernels.count_sorted_runs.launches}
    peak = torch.cuda.max_memory_allocated()
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
    from megahit_tpu_torch.core import kernels

    from torch.profiler import ProfilerActivity, profile

    out = os.path.join(DATA, "isolate_ladder")
    torch.cuda.reset_peak_memory_stats()
    kernels.canonical_all_kmers.launches = 0
    kernels.count_sorted_runs.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        _run_cli(["-1", data["r1"], "-2", data["r2"], "--device", "cuda",
                  "-f", "-o", out])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    launches = {"canonical_all_kmers": kernels.canonical_all_kmers.launches,
                "count_sorted_runs": kernels.count_sorted_runs.launches}
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(out, "log")) as fh:
        text = fh.read()
    klist = re.search(r"k list: (\S+)", text).group(1)
    rungs = re.findall(r"stage \d+ \(stage_assemble (\d+)\)", text)
    early = re.search(r"early termination at k=(\d+)", text)
    log(f"[8] isolate, default k list on cuda: {wall:.1f}s wall, "
        f"launches {launches}, peak device memory {peak / 2**30:.2f} GiB")
    log(f"[8] k list {klist}; rungs assembled: {','.join(rungs)}"
        + (f"; early termination at k={early.group(1)}" if early else
           "; no early termination"))
    _device_profile("[8]", prof, wall)
    _log_stages("[8]", out)
    _check_cleaning("[8]", out)
    log("[8] local low-depth passes on the device, by rung: " + ", ".join(
        f"k={k} {n} in {t}s" for k, (n, t) in zip(rungs, re.findall(
            r"local low depth: (\d+) passes on the device, ([0-9.]+)s",
            text))))
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


class _SplitCatcher(logging.Handler):
    """Keeps the seconds of the last `assemble split` log message."""

    split: dict = {}

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("assemble split: "):
            self.split = {n: float(v) for n, v in
                          re.findall(r"(\w+) ([0-9.]+)s", msg)}


def phase_engines(torch) -> None:
    """The isolate's k=21 graph assembled with each cleaning engine on
    cuda; every record must be equal."""
    import numpy as np

    from megahit_tpu_torch.graph import assemble_device
    from megahit_tpu_torch.graph.sdbg import sdbg_from_edges
    from megahit_tpu_torch.pipeline.assemble import (
        AssembleOptions, assemble,
    )
    from megahit_tpu_torch.utils.log import get_logger

    from megahit_tpu_torch.utils.log import setup_logging

    setup_logging()  # console only: the last run's log file stays as is
    edges = os.path.join(DATA, "isolate_1pass", "tmp", "k21",
                         "k21.edges.npz")
    if not os.path.exists(edges):
        fail("[10] no k=21 edge file from [11]'s 1-pass run")
    z = np.load(edges)
    keys, counts = z["keys"], z["counts"]
    catcher = _SplitCatcher()
    get_logger().addHandler(catcher)
    on_device = assemble_device.use_device_cleaning

    def run(engine, prune, final):
        assemble_device.use_device_cleaning = (
            on_device if engine == "device" else lambda device: False)
        try:
            sdbg = sdbg_from_edges(keys, counts, 22, device="cuda")
            t0 = time.monotonic()
            res = assemble(sdbg, AssembleOptions(
                min_standalone=300, prune_level=prune, careful_bubble=True,
                is_final_round=final))
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        finally:
            assemble_device.use_device_cleaning = on_device

        def fmt(cs):
            return [(c.codes.tobytes(), c.flag, f"{c.multi:.4f}")
                    for c in cs]

        return ((fmt(res.contigs), fmt(res.final_contigs),
                 fmt(res.addi_contigs), fmt(res.bubbles), res.stats),
                wall, dict(catcher.split))

    try:
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
    finally:
        get_logger().removeHandler(catcher)


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
    read2sdbg, the sharded graph files, checkcpu/checknative, the link
    probe and debug mode."""
    import numpy as np

    from megahit_tpu_torch.graph.sdbg import Sdbg
    from megahit_tpu_torch.utils import debug, devlink
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
    a.save_sharded(shards, rows_per_shard=1 << 20)
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
        f"2^20): {n_shards} shards, load_sharded and load_sharded_rows over "
        f"buckets [0, 2^15) + [2^15, 2^16) equal "
        f"({time.monotonic() - t0:.2f}s)")

    # introspection and the link probe
    t0 = time.monotonic()
    cc = _stage(["checkcpu"]).strip().splitlines()[-1]
    cn = _stage(["checknative"]).strip().splitlines()[-1]
    if cc != "1" or cn != "1":
        fail(f"[12] checkcpu printed {cc}, checknative {cn}")
    ms = devlink.link_latency_ms()
    log(f"[12] checkcpu 1, checknative 1 ({time.monotonic() - t0:.2f}s); "
        f"link_latency_ms {ms:.4f}, latency_bound_link "
        f"{devlink.latency_bound_link()}")
    if devlink.latency_bound_link():
        fail("[12] the link probe routes cleaning off the card")

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


def _mesh_cleaner(torch) -> None:
    """[13] 3: the cleaning engine's state over 4 virtual shards."""
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
        res, secs = _timed(torch, lambda: assemble(sdbg, AssembleOptions(
            min_standalone=300, prune_level=2, careful_bubble=True,
            use_mesh=use_mesh)))

        def fmt(cs):
            return [(c.codes.tobytes(), c.flag, f"{c.multi:.4f}")
                    for c in cs]

        return (fmt(res.contigs), fmt(res.final_contigs),
                fmt(res.addi_contigs), fmt(res.bubbles), res.stats), secs

    assemble_device.DeviceCleaner = Recorded
    multihost.global_shard_mesh = lambda device: multihost.Mesh(
        ["cuda:0"] * 4)
    try:
        one, t_one = run(False)
        sharded, t_mesh = run(True)
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
    log(f"[13] cleaner state over 4 shards of cuda:0 on [11]'s k=21 graph "
        f"(E {made[1].sdbg.size}, Vc {made[1].vc}): {len(one[0])} contigs, "
        f"{len(one[3])} bubbles and stats equal to the unsharded engine; "
        f"assemble {t_mesh:.2f}s sharded vs {t_one:.2f}s")


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

    from megahit_tpu_torch.core import kernels

    from torch.profiler import ProfilerActivity, profile

    root = os.path.join(DATA, "mesh_cli")
    argv = ["-1", data["r1"], "-2", data["r2"], "--k-list", "21,41",
            "--no-local", "--device", "cuda", "-f"]
    kernels.canonical_all_kmers.launches = 0
    kernels.count_sorted_runs.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        _run_cli(argv + ["-o", os.path.join(root, "plain")])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.self_device_time_total > 0) / 1e6
    launches = {"canonical_all_kmers": kernels.canonical_all_kmers.launches,
                "count_sorted_runs": kernels.count_sorted_runs.launches}
    torch.cuda.empty_cache()
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    res = subprocess.run(
        [sys.executable, "-c", MESH_CHILD, HERE, str(port)] + argv
        + ["--mesh", "-o", os.path.join(root, "mesh")],
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
    shards, the cleaner's state over 4, and the CLI's --mesh on NCCL."""
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
    card = phase_card(torch)
    phase_build()
    data = phase_data()
    kern = phase_kernels(torch, data)
    sort_kern = phase_sortnet(torch)
    phase_fixtures()
    launches = phase_main_path(torch, data)
    phase_cpu_match(data)
    ladder = phase_ladder(torch, data)
    phase_out_of_core(data)
    phase_engines(torch)
    stages = phase_stages(torch, data)
    phase_mesh(torch, data)
    for kd in kern:
        kd["launches"] = launches[kd["name"]]
        kd["ladder_launches"] = ladder[kd["name"]]
        kd["stage_launches"] = stages[kd["name"]]
    kern += sort_kern
    mods = sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.")
                  or m == "megahit_tpu" or m.startswith("megahit_tpu."))
    if mods:
        fail(f"JAX or the JAX package was imported: {mods[:5]}")
    log(f"[9] total {time.monotonic() - t0:.1f}s")
    print(card)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
