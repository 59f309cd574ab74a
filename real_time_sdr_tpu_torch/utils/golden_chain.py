"""Whole-capture float64 oracle: every pipeline stage of the receiver as a
numpy signal, for the figure sheet's ``--golden`` overlay.

A jax-free copy of ``golden/chain.run_stages`` and of the loop-level
``golden/dsp.py`` functions it reaches (``fir_block``,
``fir_resample_block``, ``fm_demod_block``, ``PllState``, ``pll_block``),
on the port's own ``config`` and ``ops.filters``; ``golden/chain.py``
itself imports the JAX package's. It runs the oracle block by block over a
raw uint8 capture and returns each intermediate stage concatenated across
blocks. Deliberately simple and slow: explicit loops, float64, per-block
carried state. ``tests/test_torch_copies.py`` holds it equal to the
original stage by stage.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from real_time_sdr_tpu_torch import config as C
from real_time_sdr_tpu_torch.ops import filters

__all__ = ["fir_block", "fir_resample_block", "fm_demod_block", "PllState",
           "pll_block", "run_stages"]


def fir_block(x, h, state, decim=1):
    """Causal FIR + decimation with overlap-save state.

    Twin of the reference's ``convolveFIR(y, x, h, state, decim)``
    (src/filter.cpp:106-121): y[n] = sum_k h[k] * xx[n*decim - k] with the
    previous block's tail supplying negative indices; outputs only every
    ``decim``-th sample. Returns (y, new_state) where new_state is the last
    len(h)-1 input samples.
    """
    x = np.asarray(x, dtype=np.float64)
    h = np.asarray(h, dtype=np.float64)
    taps = len(h)
    if len(state) != taps - 1:
        raise ValueError(f"FIR state holds {len(state)} samples, not "
                         f"{taps - 1}")
    xx = np.concatenate([np.asarray(state, dtype=np.float64), x])
    n_out = len(x) // decim
    y = np.zeros(n_out)
    for n in range(n_out):
        pos = taps - 1 + n * decim
        y[n] = np.dot(h, xx[pos - np.arange(taps)])
    return y, x[-(taps - 1):].copy()


def fir_resample_block(x, h, state, up, down):
    """Polyphase rational resampler with carried state.

    Twin of ``convolveFIR(y, x, h, state, up, down)`` (src/filter.cpp:123-147)
    and ``convfilter_resample`` (model/fmSupportLib.py:95-114): for each output
    n, phase = (n*down) % up and only the phase's tap bank touches real input
    samples. State is the last ceil(len(h)/up)-1 *input* samples (the reference
    stores len(h)-1, of which only these are ever read).
    """
    x = np.asarray(x, dtype=np.float64)
    h = np.asarray(h, dtype=np.float64)
    K = len(h)
    T = -(-K // up)  # ceil: real input samples per output dot
    if len(state) != T - 1:
        raise ValueError(f"resampler state holds {len(state)} samples, not "
                         f"{T - 1}")
    xx = np.concatenate([np.asarray(state, dtype=np.float64), x])
    n_out = (len(x) * up) // down
    y = np.zeros(n_out)
    for n in range(n_out):
        phase = (n * down) % up
        q = (n * down - phase) // up  # == floor(n*down/up)
        for m, k in enumerate(range(phase, K, up)):
            # x index q - m; negative comes from state via the xx prefix
            y[n] += h[k] * xx[T - 1 + q - m]
    return y, xx[len(xx) - (T - 1):].copy()


# ----------------------------------------------------------------------------
# FM discriminator
# ----------------------------------------------------------------------------

def fm_demod_block(i_sig, q_sig, prev_i, prev_q):
    """Arctan-free FM discriminator (src/demod.cpp:3-24,
    model/fmSupportLib.py:164-183):
    d[n] = (I[n] dQ[n] - Q[n] dI[n]) / (I[n]^2 + Q[n]^2), zero-guarded.
    """
    i_sig = np.asarray(i_sig, dtype=np.float64)
    q_sig = np.asarray(q_sig, dtype=np.float64)
    ii = np.concatenate([[prev_i], i_sig])
    qq = np.concatenate([[prev_q], q_sig])
    num = i_sig * np.diff(qq) - q_sig * np.diff(ii)
    den = i_sig * i_sig + q_sig * q_sig
    out = np.where((i_sig == 0) & (q_sig == 0), 0.0, num / np.where(den == 0, 1.0, den))
    return out, i_sig[-1], q_sig[-1]


@dataclass
class PllState:
    """Carried loop state (reference: include/pll.h:10-17 + pll.cpp:18)."""
    integrator: float = 0.0
    phase_est: float = 0.0
    feedback_i: float = 1.0
    feedback_q: float = 0.0
    trig_offset: int = 0
    last_nco: float = 1.0  # previous block's final NCO sample -> out[0]


def pll_block(x, freq, fs, state: PllState, nco_scale=1.0, phase_adjust=0.0,
              norm_bw=0.01):
    """Type-2 second-order PLL with NCO, per-sample recurrence.

    Twin of ``fmpll`` (src/pll.cpp:4-61) / ``fmPll`` (model/fmPll.py:103-175).
    Returns (out, new_state) where out has len(x)+1 entries and out[0] is the
    *previous* block's last NCO sample — consumers index out[0:len(x)], so the
    carrier is effectively one sample delayed, exactly as in the reference
    (src/stereo.cpp:83-85, src/rds.cpp:125-127).
    """
    cp, ci = 2.666, 3.555
    kp = norm_bw * cp
    ki = norm_bw * norm_bw * ci
    omega = 2.0 * math.pi * freq / fs

    fbi, fbq = state.feedback_i, state.feedback_q
    integ, phase = state.integrator, state.phase_est
    trig = state.trig_offset

    out = np.empty(len(x) + 1)
    out[0] = state.last_nco
    for k in range(len(x)):
        err_i = x[k] * fbi
        err_q = x[k] * (-fbq)
        err_d = math.atan2(err_q, err_i)
        integ = integ + ki * err_d
        phase = phase + kp * err_d + integ
        trig += 1
        arg = omega * trig + phase
        fbi = math.cos(arg)
        fbq = math.sin(arg)
        out[k + 1] = math.cos(arg * nco_scale + phase_adjust)

    new = PllState(integrator=integ, phase_est=phase, feedback_i=fbi,
                   feedback_q=fbq, trig_offset=trig, last_nco=out[-1])
    return out, new


def run_stages(cfg, iq_u8: np.ndarray, stereo: bool = True,
               rds: bool = True) -> dict:
    """iq_u8: (nb*2*block_size_iq,) raw interleaved uint8.

    Returns {stage_name: float64 array at that stage's rate} with stages
    concatenated over all whole blocks. Stage set mirrors the receiver:
    demod, pilot, carrier, left/right (stereo), rds_band, rds_mixed,
    rds_clean (rds)."""
    blk = 2 * cfg.block_size_iq
    nb = len(iq_u8) // blk
    blocks = np.asarray(iq_u8[: nb * blk], np.uint8).reshape(nb, blk)

    rf_h = filters.design_lpf(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps)
    audio_h = filters.design_lpf(cfg.if_fs * cfg.audio_up, cfg.audio_fc,
                                 cfg.rf_taps * cfg.audio_up,
                                 gain=cfg.audio_up)
    # polyphase state length is ceil(taps/up) - 1 (the resampler touches
    # only every up-th tap per phase) — NOT taps-1, which breaks the
    # fractional modes 2/3 where audio_up = 147
    n_audio_st = -(-len(audio_h) // cfg.audio_up) - 1
    st_i = np.zeros(cfg.rf_taps - 1)
    st_q = np.zeros(cfg.rf_taps - 1)
    prev_i = prev_q = 0.0
    out: dict[str, list] = {"demod": []}

    if stereo:
        pilot_h = filters.design_bpf(cfg.if_fs, *C.PILOT_BAND, cfg.rf_taps)
        band_h = filters.design_bpf(cfg.if_fs, *C.STEREO_BAND, cfg.rf_taps)
        apf_h = filters.design_apf(cfg.rf_taps)
        st_pilot = np.zeros(cfg.rf_taps - 1)
        st_band = np.zeros(cfg.rf_taps - 1)
        st_delay = np.zeros(cfg.rf_taps - 1)
        st_mono = np.zeros(n_audio_st)
        st_sub = np.zeros(n_audio_st)
        pll_st = PllState()
        out.update(pilot=[], carrier=[], left=[], right=[])
    else:
        st_mono = np.zeros(n_audio_st)
        out.update(mono=[])

    if rds:
        up, down = cfg.rds_resample
        rband_h = filters.design_bpf(cfg.if_fs, *C.RDS_BAND, cfg.rf_taps)
        sq_h = filters.design_bpf(cfg.if_fs, *C.RDS_SQUARED_BAND,
                                  cfg.rf_taps)
        rapf_h = filters.design_apf(cfg.rf_taps)
        bb_h = filters.design_lpf(cfg.if_fs * up, 3_000.0,
                                  cfg.rf_taps * up, gain=up)
        rrc_h = filters.design_rrc(cfg.rds_fs, cfg.rf_taps)
        st_rband = np.zeros(cfg.rf_taps - 1)
        st_sq = np.zeros(cfg.rf_taps - 1)
        st_rdelay = np.zeros(cfg.rf_taps - 1)
        st_bb = np.zeros(-(-len(bb_h) // up) - 1)
        st_rrc = np.zeros(cfg.rf_taps - 1)
        rpll_st = PllState()
        out.update(rds_band=[], rds_mixed=[], rds_clean=[])

    for b in range(nb):
        x = (blocks[b].astype(np.float64) - 128.0) / 128.0
        i_ds, st_i = fir_block(x[0::2], rf_h, st_i, cfg.rf_decim)
        q_ds, st_q = fir_block(x[1::2], rf_h, st_q, cfg.rf_decim)
        fm, prev_i, prev_q = fm_demod_block(i_ds, q_ds, prev_i, prev_q)
        out["demod"].append(fm)

        if stereo:
            pilot, st_pilot = fir_block(fm, pilot_h, st_pilot, 1)
            car_full, pll_st = pll_block(
                pilot, int(C.PILOT_FREQ), cfg.if_fs, pll_st, nco_scale=2.0,
                norm_bw=C.PLL_BW_STEREO)
            carrier = car_full[: len(fm)]
            band, st_band = fir_block(fm, band_h, st_band, 1)
            sub_dc = 2.0 * band * carrier
            mono_del, st_delay = fir_block(fm, apf_h, st_delay, 1)
            mono, st_mono = fir_resample_block(
                mono_del, audio_h, st_mono, cfg.audio_up, cfg.audio_down)
            sub, st_sub = fir_resample_block(
                sub_dc, audio_h, st_sub, cfg.audio_up, cfg.audio_down)
            out["pilot"].append(pilot)
            out["carrier"].append(carrier)
            out["left"].append(mono + sub)
            out["right"].append(mono - sub)
        else:
            mono, st_mono = fir_resample_block(
                fm, audio_h, st_mono, cfg.audio_up, cfg.audio_down)
            out["mono"].append(mono)

        if rds:
            rband, st_rband = fir_block(fm, rband_h, st_rband, 1)
            pil, st_sq = fir_block(rband * rband, sq_h, st_sq, 1)
            rcar, rpll_st = pll_block(
                pil, int(C.RDS_PILOT_FREQ), cfg.if_fs, rpll_st,
                nco_scale=0.5, norm_bw=C.PLL_BW_RDS)
            delayed, st_rdelay = fir_block(rband, rapf_h, st_rdelay, 1)
            mixed = 2.0 * delayed * rcar[: len(fm)]
            filt, st_bb = fir_resample_block(mixed, bb_h, st_bb, up,
                                                 down)
            clean, st_rrc = fir_block(filt, rrc_h, st_rrc, 1)
            out["rds_band"].append(rband)
            out["rds_mixed"].append(mixed)
            out["rds_clean"].append(clean)

    return {k: np.concatenate(v) for k, v in out.items()}
