"""Seconds a pass waits at the end of the fused ingest for its exact rescan
of borderline hashes (the port's span `ingest.rescan_wait`, the part of
the rescan not hidden under the reads): the window's total, per pass."""


def read(rec):
    total = rec["spans"].get("ingest.rescan_wait")
    return None if total is None else total / len(rec["passes"])
