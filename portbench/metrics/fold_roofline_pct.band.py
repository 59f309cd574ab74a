"""fold_roofline_pct.band: the fused wideband frontend's fold product (one
f32 GEMM a segment, a library kernel, and any split-K reduction) at its
floor, 2 M N K operations at
the f32 peak (``_costs.fold_product``), over its measured device time in
the traced sub-window, times the segments run there (the ``fir_decimate``
launches). Nothing to read where the profiler recorded no
GEMM kernel."""

from portbench.metrics import _costs


def read(records):
    tr = records.get("trace")
    if records.get("cpu") or not tr:
        return None
    segs = sum(c for n, (c, _) in tr["ops"].items() if "fir_decimate" in n)
    spent = sum(t for n, (_, t) in tr["ops"].items()
                if "gemm" in n.lower() or "splitk" in n.lower())
    if not segs or spent <= 0:
        return None
    p = _costs.fold_product(records["config"])
    return 100.0 * _costs.floor_s(p["flops"], p["bytes"]) * segs / spent
