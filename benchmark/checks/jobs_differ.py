"""jobs_differ: the window's other jobs whose k_min graph or contigs
differ from the judged job's, byte for byte (every job assembles the
same sample)."""


def read(job):
    return sum(d != job.digests[job.pick] for d in job.digests)
