"""fir_roofline_pct.band: the FIR kernels' (``fir_bank``, ``fir_decimate``)
floors over their measured device time in the traced sub-window. The
floors are the frozen arithmetic of ``_costs.band_fir_sites`` per
segment, times the segments the window ran (its ``fir_decimate``
launches)."""

from portbench.metrics import _costs


def read(records):
    tr = records.get("trace")
    if records.get("cpu") or not tr:
        return None
    fir = {n: v for n, v in tr["ops"].items()
           if "fir_bank" in n or "fir_decimate" in n}
    segs = sum(c for n, (c, _) in fir.items() if "fir_decimate" in n)
    spent = sum(t for _, t in fir.values())
    if not segs or spent <= 0:
        return None
    floor = sum(_costs.floor_s(c["flops"], c["bytes"])
                for sites in _costs.band_fir_sites(
                    records["config"], records["rds"]).values()
                for c in sites)
    return 100.0 * floor * segs / spent
