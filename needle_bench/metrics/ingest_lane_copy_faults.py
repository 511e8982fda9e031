"""Page faults (minor plus major, the copying thread's getrusage) a pass
takes while it copies the episodes into the lane buffers (the port's
counter `ingest.lane_copy_faults`): the window's total, per pass."""


def read(rec):
    total = rec["spans"].get("ingest.lane_copy_faults")
    return None if total is None else total / len(rec["passes"])
