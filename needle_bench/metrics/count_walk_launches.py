"""Count walk kernel launches per pass (the port's counter
`search.diag_runs.LAUNCHES` over the window, per pass). Nothing where the
window launched none (a CPU run, or a route that does not walk)."""


def read(rec):
    return rec["launches"] / len(rec["passes"]) if rec["launches"] else None
