"""rung_depths_differ: contigs of the judged job's every rung whose
printed multi is not the mean of the reference graph's multiplicities
over their (k+1)-mers, to 4 decimals (contigs.fa and final.contigs.fa).
Additional contigs (addi.fa) are the vertices that the rung's last
low-depth passes changed, which the program prints at multi 1
(graph/output.py, output_contigs with change_only): each of them that
reads another multi counts too."""

import judge
from reference import ladder

FILES = ("contigs", "final.contigs")


def read(job):
    n = 0
    for k, rung in job.ladder.items():
        if rung.graph is None:
            continue
        records = job.rung_records[k]
        for name in FILES:
            recs = records.get(name, ())
            want = ladder.contig_depths(*job.rung_edges(k, name), rung.mult,
                                        len(recs))
            n += sum(w is None or w != judge.header_multi(h)
                     for w, (h, _) in zip(want, recs))
        n += sum(judge.header_multi(h) != "1.0000"
                 for h, _ in records.get("addi", ()))
    return n
