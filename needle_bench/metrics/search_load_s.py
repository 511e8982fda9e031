"""Seconds a pass's search spends reading the analysis back (the port's
span `search.load`, every `.needle.dat`): the window's total over its
passes, per pass. A host clock."""


def read(rec):
    total = rec["spans"].get("search.load")
    return None if total is None else total / len(rec["passes"])
