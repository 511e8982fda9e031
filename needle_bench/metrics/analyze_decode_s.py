"""Seconds a pass spends in the port's span `analyze.decode` (the analyzer's
reads, MD5s and lane assembly, with the ingest dispatches they start):
the window's total over its passes, per pass. A host clock."""


def read(rec):
    total = rec["spans"].get("analyze.decode")
    return None if total is None else total / len(rec["passes"])
