"""Hashes a pass's exact rescan recomputes (the port's counter
`ingest.rescan_hashes`, the borderline flags of every lane chunk): the
window's total, per pass."""


def read(rec):
    total = rec["spans"].get("ingest.rescan_hashes")
    return None if total is None else total / len(rec["passes"])
