"""device_idle_pct.band: 100 x (1 - busy / wall) over the band cell's
traced sub-window."""


def read(records):
    tr = records.get("trace")
    if records.get("cpu") or not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
