"""The sample generator: a seeded synthetic metagenome community.

A frozen copy of the repository's ``scripts/make_community.py`` (random
genomes with log-uniform depths, an optional mobile element shared by a
share of the genomes, 2x``read_len`` pairs with substitution errors),
as a function. At the same arguments and seed it writes byte-identical
``reads_1.fa`` and ``reads_2.fa``; the genomes are returned, not
written.
"""

from __future__ import annotations

import os

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = np.zeros(256, dtype=np.uint8)
COMP[np.frombuffer(b"ACGT", dtype=np.uint8)] = np.frombuffer(
    b"TGCA", dtype=np.uint8)

# generator arguments and their defaults (make_community.py's flags)
DEFAULTS = {
    "genomes": 20, "min_bp": 100_000, "max_bp": 600_000,
    "min_cov": 2.0, "max_cov": 80.0, "read_len": 150, "insert": 300,
    "insert_sd": 25, "error": 0.002, "mobile_bp": 1000,
    "mobile_share": 0.3,
}


def write_fasta(path: str, seqs: np.ndarray, prefix: str) -> None:
    """seqs: (n, L) uint8 ASCII array."""
    n, _ = seqs.shape
    with open(path, "wb") as fh:
        chunk = 4096
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            parts = []
            for i in range(lo, hi):
                parts.append(b">" + f"{prefix}{i}".encode() + b"\n")
                parts.append(seqs[i].tobytes() + b"\n")
            fh.write(b"".join(parts))


def simulate(seed: int, shape_seed: int | None = None, **args) -> dict:
    """The community's genomes and read pairs (ASCII arrays) at `seed`.

    With `shape_seed`, the genomes' lengths and depths, the mobile
    element and which genomes carry it are those drawn at `shape_seed`,
    taken in an order drawn from `seed`, so every seed gives the same
    set of genomes (by length, depth and repeat) and the same number of
    pairs; the sequences, the reads and their errors come from `seed`.
    At seed == shape_seed, or without `shape_seed`, the draws are
    make_community.py's at `seed`.

    Returns {"genomes": [uint8 arrays], "covs", "carriers", "r1", "r2"}:
    r1, r2 are (pairs, read_len) in the order the files hold them."""
    a = dict(DEFAULTS)
    unknown = set(args) - set(a)
    if unknown:
        raise ValueError(f"unknown generator arguments: {sorted(unknown)}")
    a.update(args)
    rng = np.random.default_rng(seed if shape_seed is None else shape_seed)
    n_gen = int(a["genomes"])
    covs = np.exp(rng.uniform(np.log(a["min_cov"]), np.log(a["max_cov"]),
                              n_gen))
    sizes = rng.integers(a["min_bp"], a["max_bp"] + 1, n_gen)
    mobile = BASES[rng.integers(0, 4, a["mobile_bp"])] \
        if a["mobile_bp"] > 0 else None
    carriers = set(
        rng.choice(n_gen, max(1, int(a["mobile_share"] * n_gen)),
                   replace=False).tolist()
    ) if mobile is not None else set()
    if shape_seed is not None and seed != shape_seed:
        rng = np.random.default_rng(seed)
        order = rng.permutation(n_gen)
        covs, sizes = covs[order], sizes[order]
        carriers = {i for i in range(n_gen) if int(order[i]) in carriers}

    rl, ins_mu, ins_sd = a["read_len"], a["insert"], a["insert_sd"]
    genomes, r1_parts, r2_parts = [], [], []
    for gi in range(n_gen):
        g = BASES[rng.integers(0, 4, int(sizes[gi]))]
        if gi in carriers:
            at = int(rng.integers(0, len(g) - len(mobile)))
            g[at : at + len(mobile)] = mobile
        genomes.append(g)
        n_pairs = int(len(g) * covs[gi] / (2 * rl))
        ins = np.clip(
            rng.normal(ins_mu, ins_sd, n_pairs).astype(np.int64),
            rl + 10, ins_mu + 6 * ins_sd,
        )
        starts = rng.integers(0, len(g) - ins.max() - 1, n_pairs)
        r1 = g[starts[:, None] + np.arange(rl)[None, :]]
        r2 = COMP[g[(starts + ins)[:, None] - 1 - np.arange(rl)[None, :]]]
        if a["error"] > 0:
            for r in (r1, r2):
                m = rng.random(r.shape) < a["error"]
                r[m] = BASES[rng.integers(0, 4, int(m.sum()))]
        r1_parts.append(r1)
        r2_parts.append(r2)

    r1 = np.concatenate(r1_parts)
    r2 = np.concatenate(r2_parts)
    perm = rng.permutation(len(r1))
    return {"genomes": genomes, "covs": covs, "carriers": carriers,
            "r1": r1[perm], "r2": r2[perm]}


def write_sample(outdir: str, seed: int, shape_seed: int | None = None,
                 **args) -> dict:
    """Write reads_1.fa and reads_2.fa of the community at `seed` into
    `outdir`. Returns simulate()'s dict with the two paths added."""
    s = simulate(seed, shape_seed, **args)
    os.makedirs(outdir, exist_ok=True)
    s["path1"] = os.path.join(outdir, "reads_1.fa")
    s["path2"] = os.path.join(outdir, "reads_2.fa")
    write_fasta(s["path1"], s["r1"], "r")
    write_fasta(s["path2"], s["r2"], "r")
    return s
