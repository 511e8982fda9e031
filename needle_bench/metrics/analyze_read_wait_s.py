"""Seconds a pass's analyzer waits for its read pool (the port's span
`analyze.read_wait`, on the main thread: the next episode's header read,
MD5 and memmap): the window's total over its passes, per pass. A host
clock."""


def read(rec):
    total = rec["spans"].get("analyze.read_wait")
    return None if total is None else total / len(rec["passes"])
