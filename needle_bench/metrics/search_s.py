"""Seconds a pass spends in `Comparator.run`, on the benchmark's clock with
the card synchronised at its end: the window's total over its passes, per
pass."""


def read(rec):
    walls = [p["search_s"] for p in rec["passes"] if "search_s" in p]
    return sum(walls) / len(walls) if walls else None
