"""Build and load the CUDA kernels: ``nvcc`` compiles every source under
``real_time_sdr_tpu_torch/csrc/`` into ONE shared library with a plain C
interface, which is loaded with ctypes.

The build runs at first use (the first kernel launch, or an explicit
``library()``), never at import. Its output lands in
``real_time_sdr_tpu_torch/_build/`` (git-ignored), named by a hash of the
sources and flags, and is written atomically (temporary file, then
``os.replace``), so a stale or half-written library is never loaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["CSRC", "BUILD_DIR", "build", "library", "check", "stream_ptr"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# sm_90a keeps the Hopper-only instructions (wgmma, setmaxnreg) open to later
# kernels; -Xptxas -v writes each kernel's registers/shared memory/spills to
# the build log beside the library.
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")
LINK_FLAGS = (*ARCH, "-shared")
NVCC_FLAGS = COMPILE_FLAGS + LINK_FLAGS

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_SIGNATURES = {
    # xx, taps, y, B, L, nf, K, up, down, T, n_out, stream
    "sdr_fir_bank": ([_P, _P, _P] + [_I] * 8 + [_P], ctypes.c_int),
    # xx, taps, prev_i, prev_q, demod, last_i, last_q, C, L, K, down,
    # n_out, stream
    "sdr_frontend_fused": ([_P] * 7 + [_I] * 5 + [_P], ctypes.c_int),
    # y, pc, ps, out, S, n_out, vec, stream
    "sdr_chan_epilogue": ([_P] * 4 + [_I, _LL, _I, _P], ctypes.c_int),
    # xx, h, y, C, L, K, down, n_out, stream
    "sdr_fir_decimate": ([_P] * 3 + [_I] * 5 + [_P], ctypes.c_int),
    # K, down -> shared-memory bytes of one fir_decimate block
    "sdr_fir_decimate_smem": ([_I, _I], _LL),
    # x, ldx, out, C, N, carry in (6), carry out (6), kp, ki, fr, fsr,
    # ang_scale, nco_scale, phase_adjust, four_pi, stream
    "sdr_pll_scan": ([_P, _LL, _P, _I, _I] + [_P] * 12 + [_F] * 2 + [_I] * 2
                     + [_F] * 4 + [_P], ctypes.c_int),
    # z, n, n_max, mu0, sps, gain, out, n_valid, stream
    "sdr_mm_timing": ([_P, _I, _I, _P, _F, _F, _P, _P, _P], ctypes.c_int),
    # z, rows, n, phase0, freq0, alpha, beta, two_pi, out, freq_log,
    # phase1, freq1, stream
    "sdr_costas_scan": ([_P, _I, _I, _P, _P] + [_F] * 3 + [_P] * 5,
                        ctypes.c_int),
    # last_bits, result, stream
    "sdr_costas_sincos_check": ([ctypes.c_uint, _P, _P], ctypes.c_int),
    "sdr_error_string": ([_I], ctypes.c_char_p),
}


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc is needed to build "
                           "the kernels)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> Path:
    """Compile the kernels unless a library for the current sources exists;
    returns its path. Each source compiles in its own ``nvcc`` process, all
    started together, then one ``nvcc`` links the objects. The compilers'
    output is kept in ``<lib>.log``."""
    out = BUILD_DIR / f"libsdr_kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs, procs = [], []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = str(Path(tmpdir) / f"{src.stem}.o")
            cmd = [nvcc, *COMPILE_FLAGS, "-I", str(CSRC), "-c", "-o", obj,
                   str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for cmd, proc in procs:
            text = proc.communicate()[0]
            if proc.returncode != 0:
                for _, other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{text}")
            logs.append(text)
        tmp = str(Path(tmpdir) / out.name)
        cmd = [nvcc, *LINK_FLAGS, "-o", tmp, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        out.with_suffix(".log").write_text("".join(logs) + res.stdout
                                           + res.stderr)
        os.replace(tmp, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call). Needs a Hopper card:
    the library holds sm_90a code only."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a card; "
                           "torch.cuda.is_available() is False")
    cap = torch.cuda.get_device_capability()
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a (Hopper); "
                           f"this card is sm_{cap[0]}{cap[1]}")
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        msg = library().sdr_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device: torch.device) -> int:
    """The current PyTorch stream of ``device`` as a raw pointer."""
    return torch.cuda.current_stream(device).cuda_stream
