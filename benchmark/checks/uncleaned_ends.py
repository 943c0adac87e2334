"""uncleaned_ends: ends of the judged job's contigs where the reference's
k_min graph forks into a tip or a bubble within 2 (k_min + 1) edges,
which cleaning would have cut or merged (one-k jobs)."""

from reference import contigs


def read(job):
    return contigs.uncleaned_ends(job.contigs, job.reference[0], job.k1,
                                  reach=2 * job.k1)
