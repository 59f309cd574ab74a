"""Full receiver: (state, u8 IQ rows) -> (state, outputs), batched over
channels.

Port of ``real_time_sdr_tpu/models/receiver.py``. The mono/stereo and RDS
branches are two consumers of one demod tensor; with stereo + RDS the pilot,
stereo-band and RDS-band BPFs share one IF band bank (one FIR-bank launch).
Channels are the leading axis of every input, output and state leaf.

    rx = Receiver(0, stereo=True, rds=True, pll_tier=3, device="cuda")
    state = rx.init_state(32)
    state, out = rx.run_segment(state, iq)   # iq: (32, 12*147000) uint8

The carrier tier is 1 (the exact sequential PLL, the JAX package's and the
CLI's default), 2 (its Newton twin) or 3 (feedforward sync, the batched
serving path); RDS timing is the per-block comb or the tracked CDR.
"""

from __future__ import annotations

import copy
from typing import Any, NamedTuple

import torch
from torch import nn

from real_time_sdr_tpu_torch.config import ReceiverConfig, mode_config
from real_time_sdr_tpu_torch.device import resolve_device
from real_time_sdr_tpu_torch.models.audio import MonoPath, StereoPath
from real_time_sdr_tpu_torch.models.frontend import Frontend
from real_time_sdr_tpu_torch.models.rds import RdsPath
from real_time_sdr_tpu_torch.ops.fir import make_bank

__all__ = ["ReceiverState", "ReceiverOutput", "Receiver"]


class ReceiverState(NamedTuple):
    frontend: Any
    audio: Any
    rds: Any        # RdsState or None


class ReceiverOutput(NamedTuple):
    mono: Any       # (C, n_audio) f32, mono receivers only, else None
    left: Any       # (C, n_audio) f32, stereo receivers only, else None
    right: Any
    rds_bits: Any   # (C, [nb,] max_bits) int32 or None
    rds_nbits: Any  # (C, [nb]) int32 or None
    rds_clean: Any = None  # (C, [nb,] rds_block) f32 RRC output


class Receiver(nn.Module):
    """Configured receiver chain.

    mode and type mirror the reference CLI: mono, stereo (``stereo=True``),
    stereo + RDS (``stereo=True, rds=True``). It runs on the card unless
    the caller names a device: ``device=None`` is ``"cuda"`` and raises
    ``RuntimeError`` without one; ``device="cpu"`` runs the kernels' plain
    versions.
    """

    def __init__(self, cfg: ReceiverConfig | int = 0, *, stereo: bool = False,
                 rds: bool = False, pll_tier: int = 1,
                 rds_timing: str = "comb",
                 device: str | torch.device | None = None):
        super().__init__()
        if isinstance(cfg, int):
            cfg = mode_config(cfg)
        if pll_tier not in (1, 2, 3):
            raise ValueError(f"pll_tier must be 1 (exact loop), 2 (Newton) "
                             f"or 3 (feedforward); got {pll_tier!r}")
        self.cfg = cfg
        self.stereo = stereo
        self.rds = bool(rds)
        self.pll_tier = pll_tier
        self.device = resolve_device(device)
        self._replicas: dict[torch.device, Receiver] = {}
        self.frontend = Frontend(cfg)
        self.audio = StereoPath(cfg, pll_tier) if stereo else MonoPath(cfg)
        self.rds_path = (RdsPath(cfg, pll_tier, timing=rds_timing)
                         if rds else None)
        self.if_bank = (make_bank([self.audio.pilot_fir, self.audio.band_fir,
                                   self.rds_path.band_fir])
                        if stereo and rds else None)
        self.to(self.device)

    def replica(self, device: str | torch.device) -> "Receiver":
        """This receiver on ``device``: itself when it already lives there,
        else a copy of its modules and buffers moved there, made once and
        kept (one replica per device is how the parallel paths spread rows
        over cards)."""
        dev = resolve_device(device)
        if dev == self.device:
            return self
        if dev not in self._replicas:
            cache, self._replicas = self._replicas, {}   # copied with self
            try:
                twin = copy.deepcopy(self).to(dev)
            finally:
                self._replicas = cache
            twin.device = dev
            cache[dev] = twin
        return self._replicas[dev]

    def init_state(self, batch: int) -> ReceiverState:
        """Fresh state for ``batch`` channels."""
        return ReceiverState(
            frontend=self.frontend.init_state(batch),
            audio=self.audio.init_state(batch),
            rds=self.rds_path.init_state(batch) if self.rds_path else None)

    @torch.no_grad()
    def step(self, state: ReceiverState, iq_u8: torch.Tensor):
        """iq_u8: (C, 2*nb*block_size_iq) uint8 on the receiver's device.
        Returns (new_state, ReceiverOutput)."""
        if iq_u8.ndim != 2 or iq_u8.dtype != torch.uint8:
            raise ValueError(f"iq_u8 must be (C, n) uint8, got "
                             f"{iq_u8.dtype} {tuple(iq_u8.shape)}")
        blk = 2 * self.cfg.block_size_iq
        if iq_u8.shape[-1] % blk:
            raise ValueError(f"segment length {iq_u8.shape[-1]} is not a "
                             f"whole number of {blk}-byte blocks")
        demod, f_state = self.frontend(iq_u8, state.frontend)
        return self._post_frontend(demod, f_state, state)

    def _post_frontend(self, demod: torch.Tensor, f_state,
                       state: ReceiverState):
        shared = band_pre = None
        if self.if_bank is not None:
            (pilot, band_s, band_r), if_tail = self.if_bank(
                demod, state.audio.pilot_tail)
            shared = (pilot, band_s, if_tail)
            band_pre = (band_r, if_tail)
        if self.stereo:
            (left, right), a_state = self.audio(demod, state.audio,
                                                shared=shared)
            mono = None
        else:
            mono, a_state = self.audio(demod, state.audio)
            left = right = None
        if self.rds_path is not None:
            (bits, n_bits, clean), r_state = self.rds_path(
                demod, state.rds, band_pre=band_pre)
        else:
            bits = n_bits = clean = r_state = None
        out = ReceiverOutput(mono=mono, left=left, right=right,
                             rds_bits=bits, rds_nbits=n_bits,
                             rds_clean=clean)
        return ReceiverState(f_state, a_state, r_state), out

    @torch.no_grad()
    def run_blocks(self, state: ReceiverState, iq_blocks: torch.Tensor):
        """Block mode: one ``step`` per block. iq_blocks (C, B,
        2*block_size_iq) uint8. Returns (final_state, ReceiverOutput) with
        every output stacked on a block axis after C, e.g. left
        (C, B, audio_block), rds_bits (C, B, max_bits), rds_nbits (C, B)."""
        if iq_blocks.ndim != 3 or iq_blocks.shape[1] == 0:
            raise ValueError(f"iq_blocks must be (C, B, n) with B >= 1, got "
                             f"{tuple(iq_blocks.shape)}")
        outs = []
        for b in range(iq_blocks.shape[1]):
            state, out = self.step(state, iq_blocks[:, b])
            outs.append(out)
        stacked = ReceiverOutput(*(
            None if leaves[0] is None else torch.stack(leaves, dim=1)
            for leaves in zip(*outs)))
        return state, stacked

    def run_segment(self, state: ReceiverState, iq_segment: torch.Tensor):
        """Segment mode: nb blocks per channel as ONE contiguous pass.

        iq_segment: (C, nb*2*block_size_iq) uint8. Audio comes back as
        (C, nb*audio_block); RDS bits as (C, nb, max_bits) for nb > 1.
        Wideband stages run over the whole segment; the narrowband RDS
        tail keeps exact per-block semantics."""
        return self.step(state, iq_segment)

    def run_segment_tiled(self, state: ReceiverState,
                          iq_segment: torch.Tensor, tile_blocks: int = 12):
        """A long segment as ``run_segment`` passes over tiles of
        ``tile_blocks`` blocks, chained through the carried state, with the
        outputs joined to exactly ``run_segment``'s layout: audio
        (C, nb*audio_block), ``rds_bits`` / ``rds_clean`` (C, nb, ...),
        ``rds_nbits`` (C, nb). Equal to one pass up to f32 summation order;
        the working set stays that of one tile. A segment of at most
        ``tile_blocks`` blocks (or ``tile_blocks`` < 2) is one pass."""
        blk = 2 * self.cfg.block_size_iq
        n_blocks = iq_segment.shape[-1] // blk
        # tile_blocks >= 2: a one-block pass has no block axis to join on
        if tile_blocks < 2 or n_blocks <= tile_blocks:
            return self.step(state, iq_segment)
        if n_blocks % tile_blocks:
            raise ValueError(
                f"run_segment_tiled: {n_blocks} blocks not divisible by "
                f"tile_blocks={tile_blocks}; pad the segment or pick a "
                "divisor")
        outs = []
        for k in range(n_blocks // tile_blocks):
            state, out = self.step(
                state, iq_segment[:, k * tile_blocks * blk:
                                  (k + 1) * tile_blocks * blk])
            outs.append(out)
        # audio streams join in time (last axis), block-major leaves on
        # their block axis
        axis = dict(mono=-1, left=-1, right=-1, rds_bits=1, rds_nbits=1,
                    rds_clean=1)
        return state, ReceiverOutput(**{
            f: (None if leaves[0] is None else torch.cat(leaves, dim=axis[f]))
            for f, leaves in zip(ReceiverOutput._fields, zip(*outs))})

    @torch.no_grad()
    def run_segment_demod(self, state: ReceiverState, demod: torch.Tensor):
        """Post-frontend entry: ``demod`` (C, nb*if_block) float32 is the
        FM-discriminated IF signal computed elsewhere (the fused wideband
        frontend emits it from one wide-rate matmul). Runs the audio and
        RDS chains as ``run_segment`` does after its frontend;
        ``state.frontend`` passes through untouched."""
        if demod.ndim != 2 or demod.dtype != torch.float32:
            raise ValueError(f"demod must be (C, n) float32, got "
                             f"{demod.dtype} {tuple(demod.shape)}")
        if demod.shape[-1] % self.cfg.if_block:
            raise ValueError(f"demod length {demod.shape[-1]} is not a whole "
                             f"number of {self.cfg.if_block}-sample blocks")
        return self._post_frontend(demod, state.frontend, state)
