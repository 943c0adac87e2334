"""The small cleaning cases of tests/test_device_cleaning.py, made with
numpy and the port's packing only (no JAX), so that both the CPU parity
tests and the card's tests build the same graphs.

Each case is (reads, min_count, AssembleOptions keyword arguments)."""

import numpy as np

from megahit_tpu_torch.core import packing


def _reads(genome, n_reads, rl, err, rng):
    reads = []
    for _ in range(n_reads):
        s = int(rng.integers(0, len(genome) - rl))
        r = genome[s: s + rl].copy()
        if err:
            m = rng.random(rl) < err
            r[m] = (r[m] + rng.integers(1, 4, int(m.sum()))) % 4
        if rng.random() < 0.5:
            r = packing.revcomp_codes(r)
        reads.append(r)
    return reads


def _mixed(err, prune, careful):
    rng = np.random.default_rng(hash((err, prune)) % (2**31))
    genome = rng.integers(0, 4, 6000).astype(np.uint8)
    genome[3000:3100] = genome[500:600]  # a repeat: bubbles, branches
    reads = _reads(genome, 1500, 100, err, rng)
    opt = dict(prune_level=prune, careful_bubble=careful,
               min_standalone=200, output_standalone=True,
               merge_similar=0.95)
    return reads, 1 if err == 0 else 2, opt


def _loop():
    rng = np.random.default_rng(9)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    circ = np.concatenate([genome, genome[:120]])
    reads = [circ[s: s + 120].copy() for s in range(0, len(genome), 2)]
    return reads, 1, dict(min_standalone=200, output_standalone=True,
                          is_final_round=True)


def _addi():
    rng = np.random.default_rng(5)
    g1 = rng.integers(0, 4, 4000).astype(np.uint8)
    reads = _reads(g1, 2200, 90, 0.015, rng)
    return reads, 2, dict(prune_level=2, careful_bubble=True,
                          is_final_round=False, min_standalone=300)


CASES = {
    "clean_prune2": lambda: _mixed(0.0, 2, False),
    "err1_prune2_careful": lambda: _mixed(0.01, 2, True),
    "err2_prune3_careful": lambda: _mixed(0.02, 3, True),
    "loop_genome": _loop,
    "final_round_addi": _addi,
}

# the cases whose passes remove nothing (error-free reads)
CLEAN = ("clean_prune2", "loop_genome")


def engine_steps(eng, k: int, min_depth: float, rec: list):
    """(name, call) for every cleaning pass of the engine API, in an
    order that reaches each branch: careful and naive bubbles, weak
    links, both local low-depth passes, low depth."""
    return [
        ("remove_tips", lambda: eng.remove_tips(2 * k)),
        ("pop_bubbles_careful", lambda: eng.pop_bubbles(
            k + 2, True, careful_threshold=0.2, bubble_records=rec)),
        ("pop_complex_bubbles_careful", lambda: eng.pop_complex_bubbles(
            20, 0.95, True, careful_threshold=0.2, bubble_records=rec)),
        ("disconnect_weak_links", lambda: eng.disconnect_weak_links(0.1)),
        ("remove_local_low_depth", lambda: eng.remove_local_low_depth(
            min_depth, 2 * k, 1000, 0.1, True)),
        ("remove_tips_again", lambda: eng.remove_tips(2 * k)),
        ("remove_low_depth", lambda: eng.remove_low_depth(min_depth)),
        ("pop_bubbles", lambda: eng.pop_bubbles(k + 2, True)),
        ("iterate_local_low_depth", lambda: eng.iterate_local_low_depth(
            min_depth, 2 * k, 1000, 0.2, False)),
        ("pop_complex_bubbles", lambda: eng.pop_complex_bubbles(
            20, 0.95, False)),
    ]


def records(res):
    """assemble() records in a comparable form."""
    def fmt(cs):
        return [(packing.decode(c.codes), c.flag, round(c.multi, 4))
                for c in cs]

    return (fmt(res.contigs), fmt(res.final_contigs),
            fmt(res.addi_contigs), fmt(res.bubbles))
