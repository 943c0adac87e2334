"""Plain NumPy reference of what the contigs of a one-k assembly must be,
held against the first graph that reference/first_graph.py works out
from the reads.

MEGAHIT's contigs at one k are the unitigs of the first graph after it
has been cleaned (upstream ``src/assembly``): tips and bubbles are cut
away, and every contig is a path of the graph's edges. Its header's
``multi`` is the mean multiplicity of the contig's edges, printed to 4
decimals. So, without working out the cleaning itself:

- every (k+1)-mer of a contig is an edge of the first graph;
- every contig's ``multi`` is the mean of the first graph's
  multiplicities over its (k+1)-mers;
- no contig ends where the first graph forks in two, into a tip (a
  branch that dies within ``reach`` edges, beside one that runs on past
  them), or into a bubble (two branches that meet again within ``reach`` edges):
  cleaning would have cut the tip or merged the bubble, and the contig
  would run on.

Nodes are k-mers and edges (k+1)-mers, as keys with the first base in
the most significant bits (reference/first_graph.py). This file imports
NumPy and reference/first_graph.py only.
"""

from __future__ import annotations

import numpy as np

from reference.first_graph import canonical, kmers, revcomp

BASES = np.arange(4, dtype=np.uint64)


class Graph:
    """The first graph's edges (sorted canonical (k+1)-mer keys) as a
    node graph: successors and predecessors of forward k-mers."""

    def __init__(self, keys: np.ndarray, k1: int):
        self.keys = np.asarray(keys, np.uint64)
        self.k1, self.k = k1, k1 - 1
        self.mask = np.uint64((1 << (2 * self.k)) - 1)

    def has(self, edges: np.ndarray) -> np.ndarray:
        """Whether each forward (k+1)-mer is an edge (on either strand)."""
        c = np.minimum(edges, revcomp(edges, self.k1))
        if len(self.keys) == 0:
            return np.zeros(c.shape, bool)
        i = np.minimum(np.searchsorted(self.keys, c), len(self.keys) - 1)
        return self.keys[i] == c

    def out(self, x: np.ndarray) -> np.ndarray:
        """(n, 4): whether node x is followed by base b."""
        return self.has((x[:, None] << np.uint64(2)) | BASES[None, :])

    def into(self, x: np.ndarray) -> np.ndarray:
        """(n, 4): whether base b followed by node x is an edge."""
        return self.has((BASES[None, :] << np.uint64(2 * self.k))
                        | x[:, None])

    def walk(self, start: np.ndarray, reach: int):
        """From each start node follow the path while it neither forks
        nor joins, for at most `reach` edges. Returns (dead, join, far):
        the path ended with no way on; at a node where another path
        joins (that node; -1 where it did not); or ran all `reach`
        edges."""
        n = len(start)
        dead = np.zeros(n, bool)
        join = np.full(n, -1, np.int64)
        x = start.copy()
        live = np.ones(n, bool)
        for _ in range(reach):
            idx = np.flatnonzero(live)
            if len(idx) == 0:
                break
            o = self.out(x[idx])
            deg = o.sum(axis=1)
            dead[idx[deg == 0]] = True
            live[idx[deg != 1]] = False
            idx, o = idx[deg == 1], o[deg == 1]
            y = (x[idx] << np.uint64(2) | BASES[o.argmax(axis=1)]) \
                & self.mask
            joined = self.into(y).sum(axis=1) > 1
            join[idx[joined]] = y[joined].astype(np.int64)
            live[idx[joined]] = False
            x[idx] = y
        return dead, join, live


def contig_edges(contig: np.ndarray, k1: int) -> np.ndarray:
    """Canonical (k+1)-mer keys of one contig (codes 0..3)."""
    return canonical(contig[None, :], k1)[0]


def edges_foreign(contigs: list[np.ndarray], keys: np.ndarray,
                  k1: int) -> int:
    """(k+1)-mers of the contigs that are not edges of the graph."""
    keys = np.asarray(keys, np.uint64)
    n = 0
    for c in contigs:
        if len(c) < k1:
            continue
        e = contig_edges(c, k1)
        i = np.minimum(np.searchsorted(keys, e), max(len(keys) - 1, 0))
        n += int(np.count_nonzero(keys[i] != e)) if len(keys) else len(e)
    return n


def depths_differ(contigs: list[np.ndarray], multis: list[str],
                  keys: np.ndarray, mult: np.ndarray, k1: int) -> int:
    """Contigs whose printed multi is not the mean of the graph's
    multiplicities over their (k+1)-mers, printed to 4 decimals (a
    contig with an edge that is not in the graph differs)."""
    keys = np.asarray(keys, np.uint64)
    n = 0
    for c, printed in zip(contigs, multis):
        e = contig_edges(c, k1)
        i = np.minimum(np.searchsorted(keys, e), len(keys) - 1)
        if len(e) == 0 or not np.array_equal(keys[i], e):
            n += 1
            continue
        mean = float(np.asarray(mult)[i].sum(dtype=np.int64)) / len(e)
        n += f"{mean:.4f}" != printed
    return n


def uncleaned_ends(contigs: list[np.ndarray], keys: np.ndarray, k1: int,
                   reach: int) -> int:
    """Contig ends where the graph forks into a tip or a bubble.

    An end is looked at outward: from the contig's last node forward,
    and from its first node backward (the reverse complement's last
    node forward). The end counts where that node has two successors,
    one of whose branches dies within `reach` edges while the other runs
    on past them, or where two of its branches join the same node
    within them. A tip
    that joins the contig's path is seen from the contig on its other
    side, where it is a fork."""
    g = Graph(keys, k1)
    k = k1 - 1
    ends = []
    for c in contigs:
        if len(c) < k1:
            continue
        nodes = kmers(c[None, :], k)[0][0]
        ends += [nodes[-1], revcomp(nodes[:1], k)[0]]
    if not ends:
        return 0
    v = np.array(ends, np.uint64)
    o = g.out(v)
    deg = o.sum(axis=1)
    bad = np.zeros(len(v), bool)

    # forks: each branch's first node, walked on
    fe, fb = np.nonzero(o & (deg >= 2)[:, None])
    y = ((v[fe] << np.uint64(2)) | BASES[fb]) & g.mask
    first_joins = g.into(y).sum(axis=1) > 1
    dead, join, far = g.walk(y, reach)
    dead &= ~first_joins
    join[first_joins] = -1
    far &= ~first_joins
    # a tip: one branch of two dies, the other runs on
    has_far = np.zeros(len(v), bool)
    has_far[fe[far]] = True
    bad[fe[dead & has_far[fe] & (deg[fe] == 2)]] = True
    # two branches of one fork that join the same node: a bubble
    pairs = np.stack([fe[join >= 0], join[join >= 0]], axis=1)
    if len(pairs):
        u, counts = np.unique(pairs, axis=0, return_counts=True)
        bad[u[counts > 1, 0]] = True

    return int(np.count_nonzero(bad))

