"""Shared shape-bucketing for device program inputs (copy of
needle_tpu/_shapes.py).

Dynamic sizes (frame counts, hash-sequence lengths, episode counts) are
rounded up to quarter-steps between powers of two, so a bounded set of
shapes serves any library with at most ~14% padding waste. The port keeps
needle_tpu's buckets: the count walk's n_pad and the ingest's frame
buckets decide which cells are padding, and the outputs are held equal to
needle_tpu's.
"""


def size_bucket(x: int, minimum: int = 256) -> int:
    b = minimum
    while b < x:
        b *= 2
    for q in (b // 2 + b // 8, b // 2 + b // 4, b // 2 + 3 * b // 8, b):
        if x <= q:
            return q
    return b
