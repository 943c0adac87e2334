"""recall_gap: 1 minus the lowest share of a genome's canonical 32-mers
that the judged job's contigs hold, over the genomes at 10x or more."""

from reference import first_graph as ref

K = 32
MIN_COV = 10.0


def read(job):
    s = job.sample
    recall = [r for r, cov in zip(
        ref.genome_recall([ref.codes(g) for g in s["genomes"]],
                          job.contigs, K), s["covs"]) if cov >= MIN_COV]
    return round(1.0 - min(recall), 6) if recall else 0.0
