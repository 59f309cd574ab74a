"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload band64.rds --seed 7 --seconds 20 \
        --trace 0

The cell (a ``workloads`` entry of ``BENCHMARK.json``) names its
configuration (``portbench/configs/<config>.json``) and its traffic mix
(``portbench/traffic/<traffic>.json``, whose ``kind`` names the runner,
``portbench/core/<kind>.py``); its correctness limits are
``portbench/limits/<cell>.json`` and each per-layer metric has its reader
in ``portbench/metrics/<metric>.py``. The program under test is
``real_time_sdr_tpu_torch``, driven through its CLI.

The last line of standard output is the result, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, traced, ``breakdown``; the compared
numbers beside their limits come last, under ``checks``, and again as the
last lines of standard error.

Exit codes: 0 with a result; 2 without a card (or fewer than the cell
needs) and no result; 3 when a JAX module was loaded; 4 when the program
failed or the run overran; 5 when the traffic names no runner.

``--cpu`` rehearses a cell's code path on the CPU at whatever size its
files give (tests use small throwaway cells); it prints no device
metric. ``--control`` runs the cell's lower-precision control in place
of the program's normal precision (``PERF.md`` lists the readings).
"""

from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "real_time_sdr_tpu")
RUN_LIMIT_S = 330.0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--control", action="store_true")
    return ap


def forbidden_modules() -> list[str]:
    """Loaded modules of JAX or of the JAX package, by whole top-level
    name (``real_time_sdr_tpu_torch`` is the port, not the package)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _cache_dirs(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(root, "portbench", ".cache", sub)
    os.environ.setdefault("USE_FLAX", "0")


def _runner(kind: str):
    """The module ``portbench/core/<kind>.py`` that runs a traffic kind,
    found by name, or None."""
    import importlib
    import re
    from portbench.core import manifest
    if not re.fullmatch(r"[a-z][a-z0-9_]*", kind) or not os.path.exists(
            os.path.join(manifest.PKG, "core", kind + ".py")):
        return None
    mod = importlib.import_module(f"portbench.core.{kind}")
    return mod if hasattr(mod, "run") else None


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    from portbench.core import manifest
    _cache_dirs(manifest.ROOT)
    cell = manifest.Cell(manifest.load(), args.workload)

    import torch
    import real_time_sdr_tpu_torch  # noqa: F401  (the program under test)
    if args.cpu:
        device = torch.device("cpu")
    elif (not torch.cuda.is_available()
          or torch.cuda.device_count() < cell.chips):
        print(f"error: the cell needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    else:
        device = torch.device("cuda")
        # float32 products stay float32: the configuration states f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    runner = _runner(cell.traffic.get("kind", ""))
    if runner is None:
        print(f"error: the traffic {cell.workload['traffic']!r} names no "
              f"runner portbench/core/<kind>.py (kind "
              f"{cell.traffic.get('kind')!r})", file=sys.stderr)
        return 5
    watchdog = threading.Timer(RUN_LIMIT_S, _overrun)
    watchdog.daemon = True
    watchdog.start()
    out = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                     device, args.control, T_PROCESS)
    watchdog.cancel()

    bad = sorted(set(forbidden_modules()) | set(out.get("forbidden", [])))
    if bad:
        print(f"error: modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    if out["rc"] != 0:
        print(f"error: the program exited {out['rc']}", file=sys.stderr)
        return 4
    return _report(cell, args, out, device)


def _report(cell, args, out: dict, device) -> int:
    from portbench.core import check, manifest
    import torch
    numbers = out["numbers"]
    ok, checks = check.verdict(numbers, cell.limits)
    correct = ok and out["failed"] == 0
    metrics = {}
    if args.trace:
        rec = dict(out["records"], cpu=device.type != "cuda")
        for m in cell.per_layer:
            v = manifest.metric_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            v = (out["setup_s"] if m["name"] == "setup_s"
                 else out["e2e"].get(m["name"]))
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": (out.get("device_kind") or torch.cuda.get_device_name(0)
                    if cuda else "cpu"),
           "count": cell.chips if cuda else 0,
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev}
    tr = out["records"].get("trace")
    if args.trace and cuda and tr is not None:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    # the numbers the check reads but does not compare in this cell
    result["notes"] = dict(out["notes"], **{
        k: numbers[k] for k in ("pcm_rel_err", "pcm_rel_err_median",
                                "compared", "worst", "rds_wrong_streams",
                                "rds_miscorrected_pct")
        if k in numbers and k not in checks})
    result["checks"] = checks
    print(json.dumps(result))
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    return 0


def _overrun() -> None:
    # the program's stderr may be the harness's tap: write to the process's
    print(f"error: the run passed {RUN_LIMIT_S:.0f} s", file=sys.__stderr__)
    sys.__stderr__.flush()
    os._exit(4)


if __name__ == "__main__":
    sys.exit(main())
