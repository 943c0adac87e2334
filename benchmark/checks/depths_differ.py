"""depths_differ: contigs of the judged job whose printed multi is not
the mean of the reference's multiplicities over their edges, to 4
decimals (one-k jobs)."""

from reference import contigs


def read(job):
    keys, mult, _ = job.reference
    return contigs.depths_differ(job.contigs, job.multis, keys, mult,
                                 job.k1)
