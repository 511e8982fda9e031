"""Card seconds a pass spends in the fused ingest's kernels (the port's
counter `ingest.kernels_card_s`: CUDA events after each lane chunk's upload
and after its kernels, read once the chunk's download is waited for): the
window's total, per pass. Nothing on the CPU."""


def read(rec):
    total = rec["spans"].get("ingest.kernels_card_s")
    return None if total is None else total / len(rec["passes"])
