"""The share of the fused ingest's lane chunks, in %, staged in a slot of
the port's staging ring that was already large enough (and page-locked, on
a card): the port's counter `ingest.staging_hits` over it plus
`ingest.staging_misses` (a slot allocated or grown, or buffers of the
chunk's own), over the window. Nothing where neither was counted."""


def read(rec):
    hits = rec["spans"].get("ingest.staging_hits")
    misses = rec["spans"].get("ingest.staging_misses")
    chunks = (hits or 0.0) + (misses or 0.0)
    return 100.0 * (hits or 0.0) / chunks if chunks else None
