"""Seconds a pass spends in the port's span `ingest.upload` (the fused
ingest's host-to-card copies of its lane chunks): the window's total over
its passes, per pass. A host clock."""


def read(rec):
    total = rec["spans"].get("ingest.upload")
    return None if total is None else total / len(rec["passes"])
