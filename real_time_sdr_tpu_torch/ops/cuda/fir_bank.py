"""Kernel 2: the FIR bank (``csrc/fir_bank.cu``) and its plain version.

``fir_bank(xx, ptaps, w, geom)`` maps tail-prefixed rows ``xx`` (B, T-1+n)
f32 to ``(B, nf, n_out)`` f32, n_out = n*up//down (C++ truncation), for nf
FIRs of one geometry. Rows are anything independent: channels, stacked
audio rails, per-block RDS batches.

- On a CPU tensor it runs ``fir_bank_plain``: the framed matmul on the
  PolyFIR plan (frames of the input against the zero-padded polyphase
  weight matrix ``w``), the arithmetic of ``real_time_sdr_tpu.ops.fir``.
- On a CUDA tensor it launches the kernel, or raises. The geometry alone
  picks the kernel's body (``kernel_body``): the register-tiled direct form
  at up == down == 1, the general polyphase form otherwise; the shape
  (rows, outputs, filters, phase period) picks the general body's tile
  (``general_plan``): lines or direct. ``body_launches`` counts each body
  and, under ``general.lines`` / ``general.direct``, each tile.

The kernel takes the taps phase-major (``phase_major``, ``FIRBank.ptaps``:
(nf, up, T), one phase's taps contiguous; at up = 1 the (nf, K) taps as
they are).

The general body's tiles (the header of ``csrc/fir_bank.cu`` has the
details), both bit for bit the first form's outputs (every output one
``fmaf`` chain a filter, m ascending):

- lines: a warp's lanes on lines (a row or, where rows are few, a stretch
  of a row a whole number of phase periods long), so that all lanes meet
  the same taps; a block stages its lines' windows and one tap stream a
  column, then walks each group of consecutive outputs' union window four
  steps a load. On an H100 what bounds it is the staging of those windows
  and streams (neighbouring blocks' windows overlap; a tile's streams are
  staged again by every line group) and, at long input steps, the walk's
  steps outside each output's own taps. Picked where lines are many.
- direct: one output a thread over a staged window, the taps staged where
  a block's outputs meet each phase twice or more, else read through L1.
  Bound by a block's latency; picked where lines are few (1-2 rows of
  247/640, the alternative decode's 2 rows of 19/240), where it is faster
  than the lines tile and than the first form.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from real_time_sdr_tpu_torch.device import kernel_route
from real_time_sdr_tpu_torch.ops.cuda._build import check, library, stream_ptr

__all__ = ["BankGeometry", "check_geometry", "DirectPlan", "direct_plan",
           "fir_bank", "fir_bank_plain", "FirBankKernel", "GeneralPlan",
           "general_plan", "kernel_body", "lines_plan", "phase_major"]

MAX_NF = 4  # filters per launch (csrc/fir_bank.cu instantiates 1..4)
TILED_TILE = 1152  # outputs per block of the tiled body (kTiledTile)
GEN_COLS = 8  # accumulator columns of a line (kGenCols)
SMEM_SM = 232_448  # shared memory of an SM, bytes; each block also holds 1 KB


@dataclasses.dataclass(frozen=True)
class BankGeometry:
    """Static polyphase geometry shared by the filters of one bank.

    ``R`` outputs per frame read a ``J``-sample window that advances by
    ``stride`` input samples per frame; the window spans ``s_over`` rows of
    a (-1, stride) reshape (ops.fir.PolyFIR's plan)."""
    up: int
    down: int
    num_taps: int
    R: int
    stride: int
    J: int
    s_over: int

    @property
    def T(self) -> int:
        """Input samples one output touches: ceil(K/up)."""
        return -(-self.num_taps // self.up)

    def n_out(self, n: int) -> int:
        return (n * self.up) // self.down


def fir_bank_plain(xx: torch.Tensor, w: torch.Tensor,
                   geom: BankGeometry) -> torch.Tensor:
    """Framed matmul: xx (B, T-1+n) @ w (J, nf*R) -> (B, nf, n_out)."""
    B, L = xx.shape
    R, stride, J, s_over = geom.R, geom.stride, geom.J, geom.s_over
    nf = w.shape[1] // R
    n_out = geom.n_out(L - (geom.T - 1))
    c_frames = -(-n_out // R)
    pad_to = (c_frames + s_over) * stride
    if pad_to >= L:
        xp = torch.nn.functional.pad(xx, (0, pad_to - L))
    else:
        xp = xx[:, :pad_to]
    rows = xp.reshape(B, -1, stride)
    frames = torch.cat([rows[:, s:s + c_frames] for s in range(s_over)],
                       dim=-1)[..., :J]
    y = frames @ w                                  # (B, c_frames, nf*R)
    y = y.reshape(B, c_frames, nf, R).permute(0, 2, 1, 3)
    return y.reshape(B, nf, c_frames * R)[..., :n_out]


def phase_major(taps: np.ndarray, up: int) -> np.ndarray:
    """(nf, K) taps -> (nf, up, T) with ``[f, p, m] = taps[f, p + up*m]``
    and zeros where ``p + up*m >= K``: the general body's tap table, one
    phase's taps contiguous. At up = 1 it is the taps themselves."""
    nf, k_taps = taps.shape
    T = -(-k_taps // up)
    pad = np.zeros((nf, T * up), dtype=taps.dtype)
    pad[:, :k_taps] = taps
    return np.ascontiguousarray(pad.reshape(nf, T, up).transpose(0, 2, 1))


def outputs_per_group(nf: int) -> int:
    """Outputs of one group of the general body (``GenKO``): 8 columns of
    accumulators a line hold outputs x filters."""
    return {1: 8, 2: 4, 3: 2, 4: 2}[nf]


def window_bound(n: int, up: int, down: int, T: int) -> int:
    """Floats of a window over n consecutive outputs' inputs from the
    16-byte boundary at or below its start to the one at or above its end
    (``gen_window_bound``)."""
    return (((n - 1) * down + up - 1) // up + T + 6 + 3) & ~3


@dataclasses.dataclass(frozen=True)
class GeneralPlan:
    """The general body's lines tile for one shape.

    A line is one row, or, where the rows are few, one stretch of ``U``
    consecutive outputs of a row (U a multiple of the phase period
    up/gcd(up, down), so every line's outputs meet the same phases and
    its input starts U*down/up samples after the previous line's). A
    block of ``nw`` warps holds ``lb`` = (nw/gb) * 32 * rt lines and
    ``gb`` groups of ``ko`` consecutive outputs of each; ``rt`` lines a
    lane. ``ws``: floats of a line's window in shared memory (ws % 8 ==
    4); ``span``: floats of a column's tap stream; ``smem``: bytes of the
    window and the streams, or of the output tile that reuses them where
    that is larger. ``grid`` blocks."""
    rt: int
    ko: int
    gb: int
    nw: int
    U: int
    V: int
    lines: int
    lb: int
    tiles: int
    ws: int
    span: int
    smem: int

    form = "lines"

    @property
    def grid(self) -> int:
        return -(-self.lines // self.lb) * self.tiles

    def as_ints(self) -> list[int]:
        """The plan as ``sdr_fir_bank`` takes it."""
        return [0, self.rt, self.U, self.ko, self.gb, self.nw, self.ws,
                self.span]


@dataclasses.dataclass(frozen=True)
class DirectPlan:
    """The general body's direct tile for one shape: a block is ``bo``
    consecutive outputs of one row, one a thread, over its window of
    ``ws`` floats; where ``staged``, each filter's ``rows`` tap rows (every
    phase, or one an output) sit in shared memory ``ts`` floats apart
    (ts % 8 == 4), else the taps come through L1. ``smem`` bytes, ``grid``
    blocks."""
    bo: int
    rows: int
    ts: int
    ws: int
    staged: bool
    grid: int
    smem: int

    form = "direct"

    def as_ints(self) -> list[int]:
        """The plan as ``sdr_fir_bank`` takes it."""
        return [1, self.bo, self.rows, self.ts, self.ws, int(self.staged),
                0, 0]


def blocks_per_sm(smem: int) -> int:
    """Blocks of the general body that share an SM at ``smem`` bytes."""
    return SMEM_SM // (smem + 1024)


def tile_plan(geom: BankGeometry, U: int, V: int, lines: int, nf: int,
              rt: int, nw: int, gb: int, ko: int) -> GeneralPlan:
    """The plan of one lines-tile shape (its shared memory may not fit)."""
    up, down, T = geom.up, geom.down, geom.T
    w = window_bound(gb * ko, up, down, T)
    ws = w if w % 8 == 4 else w + 4
    span = window_bound(ko, up, down, T)
    lb = (nw // gb) * 32 * rt
    smem = 4 * max(lb * ws + gb * GEN_COLS * span,
                   lb * (gb * GEN_COLS + 1))
    return GeneralPlan(rt, ko, gb, nw, U, V, lines, lb, -(-U // (gb * ko)),
                       ws, span, smem)


def lines_plan(geom: BankGeometry, rows: int, n_out: int,
               nf: int) -> GeneralPlan | None:
    """The lines tile for ``rows`` rows of ``n_out`` outputs, or None where
    none fits shared memory (T past about 900).

    Lines: the rows, or, under 32 rows, stretches of each row enough to
    fill a warp's lanes (as far as the phase period allows). Tile, in
    blocks of 4 warps: full groups (ko outputs; a smaller ko leaves
    columns of zero taps); then, as timed on an NVIDIA H100 80GB HBM3 at
    the serving path's sites (``utils/fir_digest.py`` cases, ranked by
    the input step d = down/up), two lines a lane and a group a warp where
    d < 4.5 and there are 128 lines or more (three blocks an SM); two
    groups, two warps each, where 4.5 <= d < 6.5, or d >= 6.5 with under
    64 lines; else a group a warp, one line a lane; each with two blocks
    an SM, else one."""
    up, down = geom.up, geom.down
    period = up // math.gcd(up, down)
    if rows >= 32 or n_out <= period:
        U = n_out
    else:
        per = -(-n_out // -(-32 // rows))
        U = max(period, -(-per // period) * period)
    V = -(-n_out // U)
    lines = rows * V
    d = down / up
    pref = ([(2, 4, 3)] if lines >= 128 and d < 4.5 else
            [(1, 2, 2)] if 4.5 <= d < 6.5 or (d >= 6.5 and lines < 64)
            else [])
    tiers = pref + [(1, gb, share) for share in (2, 1) for gb in (4, 2, 1)]
    for ko in (k for k in (8, 4, 2, 1) if k <= outputs_per_group(nf)):
        for rt, gb, share in tiers:
            pl = tile_plan(geom, U, V, lines, nf, rt, 4, gb, ko)
            if blocks_per_sm(pl.smem) >= share:
                return pl
    return None


def direct_plan(geom: BankGeometry, rows: int, n_out: int, nf: int,
                bo: int = 128) -> DirectPlan:
    """The direct tile for ``rows`` rows of ``n_out`` outputs, ``bo``
    outputs a block or fewer: the most of 128, 64, 32 that fits. Its taps
    are staged where a block's outputs meet each staged row twice or more
    (up/gcd(up, down) <= bo/2) and T >= 16, two blocks an SM; else they
    come through L1 (on an NVIDIA H100 80GB HBM3, ``utils/fir_digest.py``
    cases: staging a row per output, 128 rows of 101 taps a block, took
    twice as long at 1-2 rows of 247/640 as L1; at T 7 staging costs more
    than it saves). Raises where not even a 32-output window fits
    (``check_geometry``)."""
    up, down, T = geom.up, geom.down, geom.T
    period = up // math.gcd(up, down)
    ts = T + (4 - T) % 8
    sizes = [b for b in (128, 64, 32) if b <= bo]
    for staged in ((True, False) if T >= 16 else (False,)):
        for b in sizes:
            trows = period if period <= b else b
            if staged and 2 * trows > b:
                continue
            ws = window_bound(b, up, down, T)
            smem = 4 * (ws + (nf * trows * ts if staged else 0))
            if blocks_per_sm(smem) >= (2 if staged else 1):
                return DirectPlan(b, trows if staged else 0,
                                  ts if staged else 0, ws, staged,
                                  rows * -(-n_out // b), smem)
    raise ValueError(f"the FIR bank's general body holds no window of 32 "
                     f"outputs at up {up}, down {down}, T {T}")


def check_geometry(geom: BankGeometry) -> None:
    """Raise ValueError where the general body cannot run ``geom`` at
    all: where a window of 32 outputs, ceil(31*down/up) + T samples and
    a few more, exceeds one SM's shared memory (227 KB, about 58,000
    floats)."""
    if kernel_body(geom) == "general":
        direct_plan(geom, 1, 32, 1, bo=32)


def general_plan(geom: BankGeometry, rows: int, n_out: int,
                 nf: int) -> GeneralPlan | DirectPlan:
    """The general body's tile for ``rows`` rows of ``n_out`` outputs.

    The lines tile (``lines_plan``) where it fits and has 64 lines or
    more, or a phase period past a warp (P = up/gcd(up, down) > 32) with
    32 lines or more or an upsampling geometry (down < up); else the
    direct tile (``direct_plan``). As timed on an NVIDIA H100 80GB HBM3
    (``utils/fir_digest.py`` cases, both tiles at each): the lines tile
    shares each tap across a warp's lines, which pays where lines are
    many; the direct one needs no lines and walks only each output's own
    T steps, which pays where lines are few or a few phases repeat (1-2
    rows of 247/640 and the alternative decode's 2 rows of 19/240)."""
    pl = lines_plan(geom, rows, n_out, nf)
    period = geom.up // math.gcd(geom.up, geom.down)
    if pl is not None and (pl.lines >= 64 or (
            period > 32 and (pl.lines >= 32 or geom.down < geom.up))):
        return pl
    return direct_plan(geom, rows, n_out, nf)


def kernel_body(geom: BankGeometry) -> str:
    """The body of ``csrc/fir_bank.cu`` that runs a geometry; its
    ``launch`` dispatches on the same rule."""
    return "tiled" if geom.up == 1 and geom.down == 1 else "general"


class FirBankKernel:
    """Launch wrapper of ``sdr_fir_bank`` with its launch count, in total
    and per kernel body."""

    name = "fir_bank"
    source = "real_time_sdr_tpu_torch/csrc/fir_bank.cu"
    replaces = "real_time_sdr_tpu/ops/pallas/polyfir.py:69"

    def __init__(self):
        self.launches = 0
        self.body_launches = {"tiled": 0, "general": 0,
                              "general.lines": 0, "general.direct": 0}

    def __call__(self, xx: torch.Tensor, ptaps: torch.Tensor,
                 w: torch.Tensor, geom: BankGeometry) -> torch.Tensor:
        """xx (B, T-1+n) f32, ptaps (nf, up, T) f32 (``phase_major``), w
        (J, nf*R) f32 (the plain version's weights) -> (B, nf, n_out)
        f32."""
        if kernel_route(xx, ptaps, w) == "plain":
            return fir_bank_plain(xx, w, geom)
        return self.launch(xx, ptaps, geom)

    def launch(self, xx: torch.Tensor, ptaps: torch.Tensor,
               geom: BankGeometry) -> torch.Tensor:
        """Run the CUDA kernel (CUDA tensors only)."""
        if xx.device.type != "cuda" or ptaps.device != xx.device:
            raise ValueError(f"fir_bank kernel needs CUDA tensors on one "
                             f"device, got {xx.device} and {ptaps.device}")
        if xx.dtype != torch.float32 or ptaps.dtype != torch.float32:
            raise TypeError(f"fir_bank takes float32, got {xx.dtype}/"
                            f"{ptaps.dtype}")
        T = geom.T
        if xx.ndim != 2 or ptaps.ndim != 3 or ptaps.shape[1:] != (
                geom.up, T):
            raise ValueError(f"fir_bank takes xx (B, L) and phase-major "
                             f"taps (nf, {geom.up}, {T}); got "
                             f"{tuple(xx.shape)}, {tuple(ptaps.shape)}")
        if not (xx.is_contiguous() and ptaps.is_contiguous()):
            raise ValueError("fir_bank takes contiguous tensors")
        nf, K = ptaps.shape[0], geom.num_taps
        if not 1 <= nf <= MAX_NF:
            raise ValueError(f"a bank holds 1 <= nf <= {MAX_NF} filters, "
                             f"got {nf}")
        B, L = xx.shape
        if L < T:
            raise ValueError(f"fir_bank rows (B={B}, L={L}) need L >= T={T}")
        n_out = geom.n_out(L - (T - 1))
        y = torch.empty((B, nf, n_out), dtype=torch.float32, device=xx.device)
        if B == 0 or n_out == 0:
            return y
        body = kernel_body(geom)
        gp = general_plan(geom, B, n_out, nf) if body == "general" else None
        plan = (ctypes.c_int * 8)(*(gp.as_ints() if gp else [0] * 8))
        lib = library()
        with torch.cuda.device(xx.device):
            err = lib.sdr_fir_bank(xx.data_ptr(), ptaps.data_ptr(),
                                   y.data_ptr(), B, L, nf, K, geom.up,
                                   geom.down, T, n_out, plan,
                                   stream_ptr(xx.device))
        check(err, "sdr_fir_bank")
        self.launches += 1
        self.body_launches[body] += 1
        if gp is not None:
            self.body_launches[f"general.{gp.form}"] += 1
        return y


fir_bank = FirBankKernel()
