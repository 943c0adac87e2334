"""rungs_differ: the window's other jobs whose kept rung files (every
rung's edge file and contig files) differ from the judged job's, byte
for byte (.npz array by array)."""


def read(job):
    return sum(d != job.rung_digests[job.pick] for d in job.rung_digests)
