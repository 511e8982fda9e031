"""The fused ingest's lane fill, in %: the episodes' valid bytes copied into
the lanes (the port's counter `ingest.lane_bytes`) over the bytes uploaded
to the card (`ingest.upload_bytes`), over the window. The rest is padding:
lanes past their window's end and lanes left empty."""


def read(rec):
    lanes = rec["spans"].get("ingest.lane_bytes")
    uploaded = rec["spans"].get("ingest.upload_bytes")
    return None if lanes is None or not uploaded else 100.0 * lanes / uploaded
