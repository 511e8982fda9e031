"""Seconds a pass spends in the port's span `search.entries` (turning the
count walk's flagged diagonals into RunEntry lists): the window's total
over its passes, per pass. A host clock."""


def read(rec):
    total = rec["spans"].get("search.entries")
    return None if total is None else total / len(rec["passes"])
