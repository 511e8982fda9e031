"""Card seconds a pass spends in the fused ingest's source stage (the port's
counter `ingest.decimate_card_s`: each lane chunk's time from the CUDA event
at the start of its kernels to the one after its downmix, or after its
decimation where there is none, read once the chunk's download is waited
for): the zeroing past each lane's valid count, the half-band stage or
stages and the downmix. The window's total, per pass. Nothing on the CPU."""


def read(rec):
    total = rec["spans"].get("ingest.decimate_card_s")
    return None if total is None else total / len(rec["passes"])
