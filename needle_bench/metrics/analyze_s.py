"""Seconds a pass spends in `Analyzer.run`, on the benchmark's clock with
the card synchronised at its end: the window's total over its passes, per
pass."""


def read(rec):
    walls = [p["analyze_s"] for p in rec["passes"] if "analyze_s" in p]
    return sum(walls) / len(walls) if walls else None
