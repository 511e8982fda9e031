"""The share, in %, of the valid bytes copied into the fused ingest's lane
buffers that were copied in chunks whose copy was split across the port's
copy pool: the port's counter `ingest.lane_copy_pool_bytes` over
`ingest.lane_bytes`, over the window. It says how often the pool engages.
Nothing where the pool's counter is absent, as in a run of a port that
copies every chunk on one thread, or where no lane bytes were copied."""


def read(rec):
    pooled = rec["spans"].get("ingest.lane_copy_pool_bytes")
    lanes = rec["spans"].get("ingest.lane_bytes")
    return 100.0 * pooled / lanes if pooled is not None and lanes else None
