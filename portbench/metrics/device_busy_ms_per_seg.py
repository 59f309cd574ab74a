"""device_busy_ms_per_seg: the card's busy time (the union of its kernel,
copy and set intervals) in the traced sub-window, per segment run there;
the segments counted by their audio resampler launches (``fir_decimate``,
one a segment)."""


def read(records):
    tr = records.get("trace")
    if records.get("cpu") or not tr:
        return None
    segs = sum(c for name, (c, _) in tr["ops"].items()
               if "fir_decimate" in name)
    return tr["busy_s"] * 1e3 / segs if segs else None
