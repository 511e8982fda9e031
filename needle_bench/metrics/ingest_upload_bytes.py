"""Bytes a pass copies to the card for the fused ingest (the port's counter
`ingest.upload_bytes`): the window's total over its passes, per pass."""


def read(rec):
    total = rec["spans"].get("ingest.upload_bytes")
    return None if total is None else total / len(rec["passes"])
