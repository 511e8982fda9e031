"""Bytes of the card's mid-rate samples a pass's exact rescan brings to the
host (the port's counter `ingest.rescan_window_bytes`, each flagged range's
int16 window): the window's total over its passes, per pass."""


def read(rec):
    total = rec["spans"].get("ingest.rescan_window_bytes")
    return None if total is None else total / len(rec["passes"])
