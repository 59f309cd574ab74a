"""frontend_roofline_pct.tuners: the tuner bank's front-end kernel
(``frontend_fused``, one launch a segment over every tuner's row) at its
floor (``_costs_tuners.frontend_launch``: the bytes at 3.35 TB/s or the
f32 operations at 67 TFLOP/s, the larger), times its launches in the
traced sub-window, over its measured device time there."""

from portbench.metrics import _costs, _costs_tuners


def read(records):
    tr = records.get("trace")
    if records.get("cpu") or not tr:
        return None
    fe = [v for n, v in tr["ops"].items() if "frontend_fused" in n]
    launches = sum(c for c, _ in fe)
    spent = sum(t for _, t in fe)
    if not launches or spent <= 0:
        return None
    c = _costs_tuners.frontend_launch(records["config"])
    return 100.0 * _costs.floor_s(c["flops"], c["bytes"]) * launches / spent
