"""Seconds a pass spends in the interpreter's garbage collections, on any
thread (the port's counter `gc.pause_s`, from a `gc.callbacks` hook): the
window's total, per pass."""


def read(rec):
    total = rec["spans"].get("gc.pause_s")
    return None if total is None else total / len(rec["passes"])
