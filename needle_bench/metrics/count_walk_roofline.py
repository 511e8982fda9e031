"""The count walk's share of its roofline, in %: the least time an H100
SXM could take for the walk of one pass (roofline.bound_s of the cells and
bytes counted from the launched lanes' lengths) over the kernel time of
that pass's launches (CUDA events around each, after the window). Nothing
where the pass launched no walk or a banded one (its cells are not all
walked, and roofline.py counts walk-all work)."""

from needle_bench import roofline


def read(rec):
    walk = rec["walk"]
    if not walk or walk["banded"] or walk["kernel_s"] <= 0:
        return None
    bound, _ = roofline.bound_s(walk["cells"], walk["bytes"])
    return 100.0 * bound / walk["kernel_s"]
