"""graph_edges_differ: edges of the judged job's k_min graph that are
missing, extra or of another multiplicity than the reference's (exact)."""

from reference import first_graph as ref


def read(job):
    keys, mult, _ = job.reference
    return ref.edges_differ(keys, mult, *job.graph)
