"""Seconds a pass spends copying the episodes' valid samples into the fused
ingest's lane buffers (the port's span `ingest.lane_copy`, inside
`ingest.batch_assemble`: the memmaps' pages fault in here, so this is the
actual read of the episodes): the window's total, per pass. A host clock."""


def read(rec):
    total = rec["spans"].get("ingest.lane_copy")
    return None if total is None else total / len(rec["passes"])
