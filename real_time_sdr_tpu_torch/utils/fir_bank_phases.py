"""Where the FIR bank's general body spends a block, on a card.

    python -m real_time_sdr_tpu_torch.utils.fir_bank_phases [CASE,...]

Builds variants of ``csrc/fir_bank.cu`` into ``_build/phases/`` (the
source as it is, with text inserted at fixed anchors; it fails where an
anchor is gone) and, for each case of ``utils/fir_digest.py`` named (the
mode-0 site by default) at the lines tile ``lines_plan`` picks:

- the median cycles (``clock64``, thread 0 of each block) of a block's
  phases: make the unit and start the window's first loads and the
  columns; bring in the window and tap streams; the walk; the way out;
  and the span of each SM's blocks (first start to last end);
- the device time of one launch behind a sleeping kernel (as
  ``fir_digest``) of the body as it is and of three ablations that give
  wrong outputs: the taps' loads kept at their first quad, the samples'
  loads kept at their first quad, no walk at all.

It prints one line per case and variant.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from real_time_sdr_tpu_torch.ops.cuda import _build
from real_time_sdr_tpu_torch.ops.cuda.fir_bank import lines_plan
from real_time_sdr_tpu_torch.utils import fir_digest

__all__ = ["ABLATIONS", "instrumented_source", "main"]

_MARKS = [  # (anchor, text inserted before it)
    ("  const GenUnit t = gen_unit(s, blockIdx.x);\n  GenStage st;",
     "  MARK(0);\n"),
    ("  gen_stage_rest(s, t, col, buf, xx, ptaps, st, warp, lane);",
     "  MARK(1);\n"),
    ("  float acc[RT][kGenCols];\n  gen_compute<NF, RT>(", "  MARK(2);\n"),
    ("  // Out through the spent buffer", "  MARK(3);\n"),
]
_END = ("          buf[li * os + col];\n    }\n  }\n}\n",
        "          buf[li * os + col];\n    }\n  }\n  __syncthreads();\n"
        "  MARK(4);\n  if (threadIdx.x == 0 && blockIdx.x < kDbgBlocks) {\n"
        "    unsigned sm;\n    asm volatile(\"mov.u32 %0, %%smid;\" : "
        "\"=r\"(sm));\n    g_dbg[blockIdx.x * 8 + 5] = sm;\n  }\n}\n")
ABLATIONS = {
    "no_tap_loads": ("  for (int c = 0; c < kCols; ++c) hv[c] = tq[c * sq + k];",
                     "  for (int c = 0; c < kCols; ++c) hv[c] = tq[c * sq];"),
    "no_sample_loads": (
        "    xv[r] = *reinterpret_cast<const float4*>(xr[r] - 4 * k);",
        "    xv[r] = *reinterpret_cast<const float4*>(xr[r]);"),
    "no_walk": ("  gen_compute<NF, RT>(s, col, buf, g, li0, acc);",
                "  for (int r = 0; r < RT; ++r)\n"
                "    for (int c = 0; c < kGenCols; ++c) acc[r][c] = 0.f;"),
}
_GENERAL = ("// ------------------------------------------------------------"
            "---- general --")


def _replace(src: str, anchor: str, new: str) -> str:
    if anchor not in src:
        raise RuntimeError(f"fir_bank.cu has changed: no {anchor[:50]!r}")
    return src.replace(anchor, new, 1)


def instrumented_source(ablation: str | None = None) -> str:
    """``csrc/fir_bank.cu`` with the phase marks (and an ablation)."""
    src = (_build.CSRC / "fir_bank.cu").read_text()
    src = _replace(src, _GENERAL,
                   "constexpr int kDbgBlocks = 65536;\n"
                   "__device__ long long g_dbg[kDbgBlocks * 8];\n"
                   "#define MARK(i) if (threadIdx.x == 0 && blockIdx.x < "
                   "kDbgBlocks) g_dbg[blockIdx.x * 8 + (i)] = clock64()\n"
                   + _GENERAL)
    for anchor, text in _MARKS:
        src = _replace(src, anchor, text + anchor)
    src = _replace(src, *_END)
    if ablation is not None:
        src = _replace(src, *ABLATIONS[ablation])
    return src + ("\nextern \"C\" int fir_phases_read(long long* out, int n) "
                  "{\n  return cudaMemcpyFromSymbol(out, g_dbg, n * 8 * "
                  "sizeof(long long));\n}\n")


def _build_variants() -> dict:
    out = _build.BUILD_DIR / "phases"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in [None, *ABLATIONS]:
        tag = name or "body"
        cu = out / f"{tag}.cu"
        cu.write_text(instrumented_source(name))
        cmd = [_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC", "-shared", "-I", str(_build.CSRC),
               "-o", str(out / f"{tag}.so"), str(cu)]
        procs[tag] = (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for tag, (cmd, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{text}")
        lib = ctypes.CDLL(str(out / f"{tag}.so"))
        lib.sdr_fir_bank.argtypes = _build._SIGNATURES["sdr_fir_bank"][0]
        lib.sdr_fir_bank.restype = ctypes.c_int
        lib.fir_phases_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        libs[tag] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("fir_bank_phases: needs a CUDA card", file=sys.stderr)
        return 2
    names = (sys.argv[1].split(",") if len(sys.argv) > 1
             else ["mode0_rds_247_640_r384"])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    libs = _build_variants()
    cases = {c["name"]: c for c in fir_digest.cases()}
    for name in names:
        bank, xx, n = fir_digest.case_inputs(cases[name], "cuda")
        g = bank.geometry
        rows, length = xx.shape
        n_out = g.n_out(n)
        plan = lines_plan(g, rows, n_out, bank.nf)
        arr = (ctypes.c_int * 8)(*plan.as_ints())
        y = torch.empty((rows, bank.nf, n_out), device="cuda")
        for tag, lib in libs.items():
            def run(lib=lib):
                err = lib.sdr_fir_bank(
                    xx.data_ptr(), bank.ptaps.data_ptr(), y.data_ptr(), rows,
                    length, bank.nf, g.num_taps, g.up, g.down, g.T, n_out,
                    arr, _build.stream_ptr(xx.device))
                if err:
                    raise RuntimeError(f"fir_bank_phases [{tag}]: error {err}")
            ms = fir_digest._device_ms(run)
            line = (f"fir_bank general [{name}] {tag}: rt {plan.rt}, gb "
                    f"{plan.gb}, {plan.grid} blocks; {ms:.4f} ms")
            if tag == "body":
                run()
                torch.cuda.synchronize()
                dbg = np.zeros(65536 * 8, np.int64)
                if lib.fir_phases_read(dbg.ctypes.data, 65536):
                    raise RuntimeError("fir_bank_phases: read failed")
                d = dbg.reshape(-1, 8)[:min(plan.grid, 65536)]
                med = [int(np.median(d[:, i + 1] - d[:, i]))
                       for i in range(4)]
                sm = d[:, 5].astype(int)
                spans = [int(d[sm == k][:, 4].max() - d[sm == k][:, 0].min())
                         for k in np.unique(sm)]
                line += (f"; median cycles a block: unit and first loads "
                         f"{med[0]}, staging {med[1]}, walk {med[2]}, out "
                         f"{med[3]}; SM span median {int(np.median(spans))}"
                         f" max {max(spans)}; blocks an SM "
                         f"{np.bincount(sm).max()}")
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
