"""The card's idle share, in %, of a few whole passes profiled after the
window: 100 x (1 - the union of its kernel, copy and set intervals over the
profiled wall), from torch.profiler's trace. Nothing without a profile."""


def read(rec):
    prof = rec["profile"]
    if not prof or prof["window_s"] <= 0 or not prof["device_events"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
