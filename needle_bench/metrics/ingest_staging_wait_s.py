"""Seconds a pass spends in the port's span `ingest.staging_wait` (the host
waiting, before it stages a lane chunk in a slot of the staging ring, for
the slot's last upload to the card to end): the window's total over its
passes, per pass. A host clock."""


def read(rec):
    total = rec["spans"].get("ingest.staging_wait")
    return None if total is None else total / len(rec["passes"])
