"""edges_foreign: (k_min + 1)-mers of the judged job's contigs that are
not edges of the reference's k_min graph (one-k jobs: every contig is a
path of that graph)."""

from reference import contigs


def read(job):
    return contigs.edges_foreign(job.contigs, job.reference[0], job.k1)
