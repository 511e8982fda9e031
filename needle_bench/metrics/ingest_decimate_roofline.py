"""The fused ingest's source stage's share of its roofline, in %: the least
time an H100 SXM could take for the stage's work over the window
(`bound_s`) over the card seconds it took there (the port's counter
`ingest.decimate_card_s`). Nothing where a counter is missing (on the CPU,
or a port without them).

The work is counted from the lanes' valid lengths, never from the tensors'
padded shapes, so every design of the stage is read against the same work.
The port's counters give, summed over the window's lanes: the valid frames
in at the source rate (`ingest.source_frames`), their int16 bytes
(`ingest.lane_bytes`) and the mono samples out at the mid rate
(`ingest.mid_samples`, each lane's valid frames // the decimation factor).
A window holds one source format, as every configuration does, so its
channels are the bytes in / 2 / the frames in, and its factor the frames in
/ the samples out, taken as the nearest factor the port has (1, 2, 4).

- Bytes: those read in, once, and 2 for each sample out.
- Integer operations: each half-band stage's nonzero taps per output frame
  and channel, as multiply-adds of 2 operations (factor 2: the main design;
  factor 4: the relaxed design, then the main one), and one add per
  downmixed frame. The taps are those of the port's designs that are not 0
  in Q14 (fingerprint/decimate.py `_halfband_q14`: n_odd odd taps on each
  side and the centre), frozen here: main (n_odd 28, beta 9.0) 53 of its 57,
  its two outermost odd taps rounding to 0; relaxed (n_odd 3, beta 5.65) 7.

Peaks of the NVIDIA H100 SXM5 at its 700 W limit: 3.35 TB/s of HBM3 (NVIDIA
H100 data sheet) and 33.5 TOPS of INT32 (NVIDIA H100 Tensor Core GPU
Architecture whitepaper, its table of peak rates: 132 SMs x 64 INT32 lanes
x 2 operations a multiply-add x the 1.98 GHz boost clock).
"""

PEAK_INT32_OPS = 33.5e12
PEAK_BYTES = 3.35e12
# nonzero taps of each half-band stage, first to last, by decimation factor
STAGE_TAPS = {1: (), 2: (53,), 4: (7, 53)}


def stage_work(frames_in, bytes_in, samples_out):
    """(integer operations, bytes) of the source stage, or None where the
    counters are missing or hold no work."""
    if not frames_in or not bytes_in or not samples_out:
        return None
    channels = bytes_in / 2 / frames_in
    factor = min(STAGE_TAPS, key=lambda f: abs(frames_in / samples_out - f))
    taps = STAGE_TAPS[factor]
    # stage k of n writes samples_out * 2**(n - 1 - k) frames of each channel
    ops = sum(2 * t * samples_out * 2 ** (len(taps) - 1 - k) * channels
              for k, t in enumerate(taps))
    if round(channels) == 2:
        ops += samples_out
    return ops, bytes_in + 2 * samples_out


def bound_s(ops: float, moved: float) -> tuple:
    """(seconds, "operations" or "bytes"): the larger of the operations at
    the INT32 rate and the bytes at the memory rate."""
    ops_s, bytes_s = ops / PEAK_INT32_OPS, moved / PEAK_BYTES
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")


def read(rec):
    spans = rec["spans"]
    card_s = spans.get("ingest.decimate_card_s")
    work = stage_work(spans.get("ingest.source_frames"), spans.get("ingest.lane_bytes"),
                      spans.get("ingest.mid_samples"))
    if not card_s or work is None:
        return None
    return 100.0 * bound_s(*work)[0] / card_s
