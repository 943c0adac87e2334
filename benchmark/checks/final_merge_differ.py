"""final_merge_differ: 1 when the judged job's final.contigs.fa is not
the merge of its rung files, else 0. The merge (upstream src/megahit
merge_final) is every rung's final contigs in k order, then the last
rung's contigs, each of at least --min-contig-len bases, as written."""

import numpy as np

MIN_CONTIG_LEN = 200  # MEGAHIT's default --min-contig-len


def _min_len(flags):
    if "--min-contig-len" in flags:
        return int(flags[flags.index("--min-contig-len") + 1])
    return MIN_CONTIG_LEN


def read(job):
    runs = {k: r for k, r in job.rung_records.items() if "contigs" in r}
    last = max(runs)
    want = [rec for r in runs.values() for rec in r.get("final.contigs", ())]
    want += runs[last]["contigs"]
    n = _min_len(job.config["flags"])
    want = [(h, c) for h, c in want if len(c) >= n]
    got = job._records
    same = len(want) == len(got) and all(
        h1 == h2 and np.array_equal(c1, c2)
        for (h1, c1), (h2, c2) in zip(want, got))
    return 0 if same else 1
