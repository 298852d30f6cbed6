"""ingest_host_s: the seconds of the span "ingest.host" in the traced run's
profiled call (span_tree.py): the single-LP ingest's host stage: A's CSR and
A^T's (host_csr)."""

from lpbench import span_tree


def read(run):
    return span_tree.seconds(run, "ingest.host")
