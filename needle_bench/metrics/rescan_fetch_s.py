"""Seconds a pass's exact rescan spends fetching its windows of the card's
mid-rate samples (the port's span `ingest.rescan_fetch`, on the rescan
worker: the gather on the card, the copy to the host and the wait for it):
the window's total over its passes, per pass. A host clock."""


def read(rec):
    total = rec["spans"].get("ingest.rescan_fetch")
    return None if total is None else total / len(rec["passes"])
