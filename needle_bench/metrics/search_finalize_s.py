"""Seconds a pass's search spends after the engine (the port's span
`search.finalize`: candidate voting and the skip files): the window's
total over its passes, per pass. A host clock."""


def read(rec):
    total = rec["spans"].get("search.finalize")
    return None if total is None else total / len(rec["passes"])
