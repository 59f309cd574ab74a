"""The port's diagnostic entry point (``python -m real_time_sdr_tpu_torch.viz``)
and what it reaches, against the JAX package's.

The PSD estimate (three transforms) within 1e-3 dB of JAX's; the Fourier
ladder against the float64 DFT at the JAX test's tolerance (1e-2 absolute,
``tests/test_aux_components.py``); ``freq_response`` equal; the
sync-by-offset framer's events and ``state_dict`` equal to JAX's on the same
bits; the figure functions render; and the entry point in-process on the CPU:
the figure sheet with ``--alt --golden``, the ``--ber`` sweep, ``--live``
and the exit status without a card.

The golden lines. On the default sheet the port's CPU run prints FM demod
132.0, audio 133.2 / 133.3 and the RDS RRC output 122.1 dB against the
float64 oracle; the JAX receiver (Pallas frontend in interpret mode) sits
at 129.0, 78.5 / 78.6 and 45.8 dB, and the port on the card at 132.3,
78.5 / 78.6 and 45.8 (chip_smoke.py phase 9). Every block after the first
agrees to ~133 dB in all three; the first block's transient differs: the
pilot filter's first outputs are exact zeros, and the PLL's atan2 takes
their signs of zero (+-pi or 0), which the CPU's framed matmul and the
card's direct-form FIR leave differently. So each line is held within 1 dB
of the CPU value recorded here and at or above the JAX receiver's SNR
against the same oracle minus 1 dB (that floor is the card's gate).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_sdr_tpu import _viz_ber as jviz_ber
from real_time_sdr_tpu.config import mode_config as jmode_config
from real_time_sdr_tpu.models import rds_framing as jframing
from real_time_sdr_tpu.models.receiver import Receiver as JReceiver
from real_time_sdr_tpu.ops import fourier as jfourier
from real_time_sdr_tpu.ops import spectrum as jspectrum
from real_time_sdr_tpu.utils import viz as jviz
from real_time_sdr_tpu_torch import viz as tviz_main
from real_time_sdr_tpu_torch.config import mode_config
from real_time_sdr_tpu_torch.models.rds_framing import SyncByOffsetDecoder
from real_time_sdr_tpu_torch.ops import fourier, spectrum
from real_time_sdr_tpu_torch.utils import golden_chain, synth, viz

CFG = mode_config(0)
# the default sheet's golden SNR lines on the CPU (24 blocks, the oracle over
# the first 8): chip_smoke.py holds the card's within 1 dB of these
GOLDEN_SNR_CPU = {"FM demod (IF)": 132.0, "Audio L": 133.2,
                  "Audio R": 133.3, "RDS RRC output": 122.1}
# the JAX receiver's SNR against the same oracle (``_jax_stage_snr``):
# chip_smoke.py's floor for the card's lines
GOLDEN_SNR_JAX = {"FM demod (IF)": 129.0, "Audio L": 78.5,
                  "Audio R": 78.6, "RDS RRC output": 45.8}
JAX_STAGE = {"FM demod (IF)": "demod", "Audio L": "left",
             "Audio R": "right", "RDS RRC output": "rds_clean"}


@pytest.mark.parametrize("method", ["matmul", "fft", "stockham"])
def test_estimate_psd_matches_jax(method):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 512 * 24))
         + np.sin(0.3 * np.arange(512 * 24))).astype(np.float32)
    fj, pj = jspectrum.estimate_psd(jnp.asarray(x), 48_000.0, method=method)
    ft, pt = spectrum.estimate_psd(torch.from_numpy(x), 48_000.0,
                                   method=method)
    np.testing.assert_array_equal(fj, ft)
    assert pt.shape == (2, 256) and pt.dtype == torch.float32
    assert np.abs(np.asarray(pj) - pt.numpy()).max() < 1e-3
    with pytest.raises(ValueError):
        spectrum.estimate_psd(torch.from_numpy(x), 48_000.0, method="dct")


def test_fourier_ladder_against_naive_dft():
    x = synth.random_samples(512, seed=3) + 1j * synth.random_samples(
        512, seed=4)
    ref = fourier.dft_naive(x)
    np.testing.assert_array_equal(ref, jfourier.dft_naive(x))
    xc = torch.from_numpy(x.astype(np.complex64))
    for fn in (fourier.fft, fourier.dft, fourier.dft_matmul,
               fourier.fft_stockham):
        np.testing.assert_allclose(fn(xc).numpy(), ref, atol=1e-2)
    xb = torch.from_numpy(np.stack([x.real, x.imag]).astype(np.float32))
    fref = torch.fft.fft(xb).numpy()
    np.testing.assert_allclose(fourier.dft_matmul(xb).numpy(), fref,
                               atol=1e-2)
    np.testing.assert_allclose(fourier.fft_stockham(xb).numpy(), fref,
                               atol=1e-2)
    np.testing.assert_allclose(fourier.idft(fourier.dft(xc)).numpy(), x,
                               atol=1e-4)
    assert fourier.magnitude(torch.from_numpy(ref)).min() >= 0
    with pytest.raises(ValueError):
        fourier.fft_stockham(torch.zeros(12))


def test_freq_response_equal():
    h = np.hanning(101)
    for a, b in zip(spectrum.freq_response(h, 240e3),
                    jspectrum.freq_response(h, 240e3)):
        np.testing.assert_array_equal(a, b)


def _framer_bits(case):
    groups = synth.ps_groups(0x8421, 7, "ALTRDS  ")
    bits = [b for g in groups for b in synth.group_to_bits(g)]
    rng = np.random.default_rng(0)
    if case == "clean":
        return np.array(list(rng.integers(0, 2, 41)) + bits * 3)
    if case == "errors":         # scattered errors and a 3-bit burst
        out = np.array(bits * 6)
        out[[500, 1201, 1700, 1701, 1702]] ^= 1
        return out
    # lifecycle: sync, sustained garbage (sync lost), re-acquisition
    return np.concatenate([np.array(bits * 3), rng.integers(0, 2, 26 * 60),
                           np.array(bits * 3)])


@pytest.mark.parametrize("span", [0, 2, 5])
@pytest.mark.parametrize("case", ["clean", "errors", "lifecycle"])
def test_sync_by_offset_matches_jax(case, span):
    """Fed in uneven chunks, the copy emits JAX's events and ends in JAX's
    state; a state saved mid-stream resumes to the same end."""
    bits = _framer_bits(case)
    logs = {}
    decs = {}
    for name, cls in (("jax", jframing.SyncByOffsetDecoder),
                      ("port", SyncByOffsetDecoder)):
        log = logs[name] = []
        dec = decs[name] = cls(on_event=lambda k, v, log=log: log.append(
            (k, v)), correct_bursts=span)
        for a, b in ((0, 333), (333, 1500), (1500, None)):
            dec.feed(bits[a:b])
    assert logs["port"] == logs["jax"]
    assert decs["port"].state_dict() == decs["jax"].state_dict()
    ev = decs["port"].events
    assert dataclasses.asdict(ev) == dataclasses.asdict(decs["jax"].events)
    assert ev.ps_name == "ALTRDS  " and ev.pi == 0x8421
    if case == "lifecycle" and span < 5:   # span 5 repairs the garbage
        assert any(k == "sync_lost" for k, _ in logs["port"])
    resumed = SyncByOffsetDecoder(correct_bursts=span)
    half = SyncByOffsetDecoder(correct_bursts=span)
    half.feed(bits[:700])
    resumed.load_state_dict(half.state_dict())
    resumed.feed(bits[700:])
    assert resumed.state_dict() == decs["port"].state_dict()


def _png_size(path):
    """(width, height) of a PNG, after checking its IDAT inflates to
    height rows of 1 + 3*width (RGB) or 1 + 4*width (RGBA) bytes."""
    import struct
    import zlib
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h, depth, ctype = struct.unpack(">IIBB", data[16:26])
    idat, pos = b"", 8
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    chans = {2: 3, 6: 4}[ctype]
    assert depth == 8 and len(zlib.decompress(idat)) == h * (1 + chans * w)
    return w, h


@pytest.fixture(params=["matplotlib", "raster"])
def backend(request, monkeypatch):
    """The figure functions through pyplot, and through the package's own
    renderer (``utils.raster``, what ``_mpl`` gives where matplotlib is
    not installed)."""
    if request.param == "raster":
        from real_time_sdr_tpu_torch.utils import raster
        monkeypatch.setattr(viz, "_mpl", lambda: raster)
    return request.param


def test_figure_functions_render(tmp_path, backend):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(512 * 24).astype(np.float32)
    paths = [
        viz.psd_figure(str(tmp_path / "psd.png"),
                       [(x, 48000.0, 1.0, "noise")], device="cpu"),
        viz.psd_overlay_figure(str(tmp_path / "ov.png"),
                               [(x, x + 1e-3, 48000.0, 1.0, "noise")],
                               device="cpu"),
        viz.waterfall(str(tmp_path / "wf.png"), x, 48000.0, n_rows=8,
                      device="cpu"),
        viz.eye_diagram(str(tmp_path / "eye.png"), x, sps=39),
        viz.constellation(str(tmp_path / "c.png"), x, sps=39, offset=3),
        viz.write_gnuplot_overlay(str(tmp_path), ["a", "b"], title="ov"),
    ]
    for p in paths:
        assert os.path.getsize(p) > 200, p
    if backend == "raster":          # figsize x dpi, as pyplot sizes them
        assert _png_size(paths[0]) == (990, 286)
        assert _png_size(paths[2]) == (990, 550)
    with open(paths[-1]) as f:
        assert f.read() == open(jviz.write_gnuplot_overlay(
            str(tmp_path / "j"), ["a", "b"], title="ov")).read()
    assert viz.snr_db(x, x + 1e-3) == jviz.snr_db(x, x + 1e-3)


def _jax_stage_snr(iq, gold):
    """The JAX receiver's SNR per golden line against the oracle's stages
    (block by block, as the JAX package's viz runs it; its Pallas frontend
    in interpret mode, whose exact x - 128 the port shares)."""
    blk = 2 * CFG.block_size_iq
    n = len(gold["demod"]) // CFG.if_block
    rx = JReceiver(CFG, stereo=True, rds=True, pll_tier=1,
                   frontend_impl="pallas_interpret")
    st = rx.init_state()
    demod, _ = rx.frontend(jnp.asarray(iq[:n * blk]), st.frontend)
    got = {"demod": [np.asarray(demod)], "left": [], "right": [],
           "rds_clean": []}
    for b in range(n):
        st, ob = rx.jit_step(st, jnp.asarray(iq[b * blk:(b + 1) * blk]))
        for k in ("left", "right", "rds_clean"):
            got[k].append(np.asarray(getattr(ob, k)).ravel())
    return {line: jviz.snr_db(gold[k], np.concatenate(got[k]))
            for line, k in JAX_STAGE.items()}


def test_viz_sheet_alt_golden(tmp_path, capsys, monkeypatch):
    """The default sheet (24 blocks: the fewest on which the alternative
    path decodes the demo station's PS) with ``--alt --golden`` on the
    CPU: every file, the alternative path's PS, and the golden lines."""
    golds = []
    run_stages = golden_chain.run_stages

    def recorded(*args, **kw):      # the oracle's stages, kept for below
        golds.append(run_stages(*args, **kw))
        return golds[-1]

    monkeypatch.setattr(golden_chain, "run_stages", recorded)
    out = tmp_path / "sheet"
    assert tviz_main.main(["0", "--cpu", "--out", str(out), "--alt",
                           "--golden"]) == 0
    cap = capsys.readouterr()
    for name in ("psd_stages.png", "waterfall.png", "rds_eye.png",
                 "rds_constellation.png", "rds_eye.gnuplot", "rds_clean.dat",
                 "psd_golden_overlay.png", "alt_rds.png"):
        assert (out / name).stat().st_size > 100, name
        assert name.endswith(".dat") or str(out / name) in cap.out
    assert "alt path: PS='VIZ-DEMO' groups=" in cap.err
    lines = {ln.split(":")[0][len("golden SNR "):]: float(ln.split()[-2])
             for ln in cap.err.splitlines() if ln.startswith("golden SNR ")}
    assert sorted(lines) == sorted(GOLDEN_SNR_CPU)
    iq, _ = synth.station_iq(CFG, 24, ps_name="VIZ-DEMO")
    jax_snr = _jax_stage_snr(iq, golds[0])
    for name, got in lines.items():
        assert abs(got - GOLDEN_SNR_CPU[name]) <= 1.0, (name, got)
        assert abs(jax_snr[name] - GOLDEN_SNR_JAX[name]) <= 0.1, name
        assert got >= jax_snr[name] - 1.0, (name, got, jax_snr[name])


def _ber_args(out, **kw):
    import argparse
    return argparse.Namespace(**dict(dict(blocks=9, sigmas="0",
                                          impair="none", out=str(out)),
                                     **kw))


def test_viz_ber_sweep(tmp_path, capsys):
    """``--ber --sigmas 0`` over 9 blocks: the JAX sweep's CSV, row for row
    (header, BER, bit counts, groups, PS flags), and its table lines. (BER
    0 and PS at sigma 0 need ~30 blocks, where both packages give 0; the
    CPU's per-sample tier-1 loop makes that ~1 minute, so chip_smoke.py
    checks it on the card. Here 1 of the 109 steady-state bits is off in
    both.)"""
    assert tviz_main.main(["0", "--cpu", "--ber", "--blocks", "9",
                           "--sigmas", "0", "--out",
                           str(tmp_path / "t")]) == 0
    err = capsys.readouterr().err
    assert jviz_ber.ber_curve(jmode_config(0),
                              _ber_args(tmp_path / "j")) == 0
    jerr = capsys.readouterr().err
    rows = {}
    for d in ("t", "j"):
        with open(tmp_path / d / "ber_curve.csv") as f:
            rows[d] = [ln.rstrip("\n").split(",") for ln in f]
        assert (tmp_path / d / "ber_curve.png").stat().st_size > 1000
    assert rows["t"] == rows["j"]
    assert len(rows["t"]) == 3                 # header + comb + tracked
    head = rows["t"][0]
    for r in rows["t"][1:]:
        cell = dict(zip(head, r))
        assert float(cell["sigma"]) == 0.0 and cell["impair"] == "none"
        assert float(cell["ber"]) < 1e-2 and int(cell["bits"]) > 100
        assert all(int(cell[k]) >= 0 for k in head if k.endswith("groups"))
    t_lines = [ln for ln in err.splitlines() if ln.startswith("sigma=")]
    assert t_lines == [ln for ln in jerr.splitlines()
                       if ln.startswith("sigma=")]
    assert [ln[:18] for ln in t_lines] == ["sigma=0.00 comb   ",
                                           "sigma=0.00 tracked"]


def test_viz_live_renders_a_snapshot(tmp_path, capsys, backend):
    """``--live`` on a snapshot in the port CLI's ``--monitor`` layout (the
    JAX CLI's keys), one frame."""
    snap = tmp_path / "snap.npz"
    t = np.arange(CFG.audio_block) / float(CFG.audio_fs)
    np.savez(snap, block=12, fs=float(CFG.audio_fs),
             audio=(8000 * np.sin(2 * np.pi * 440 * t)).astype(np.int16),
             clean=np.sin(np.arange(40 * CFG.sps) / 3.0).astype(np.float32),
             sps=int(CFG.sps), ps="LIVEVIEW", pi=0xD1D1, groups=9)
    out = tmp_path / "view"
    assert tviz_main.main(["0", "--cpu", "--live", str(snap), "--frames",
                           "1", "--refresh", "0.05", "--out",
                           str(out)]) == 0
    assert "frame 1: block 12 -> " in capsys.readouterr().err
    assert (out / "live.png").stat().st_size > 1000
    assert _png_size(out / "live.png")[0] == 750


def test_viz_without_a_card_exits_2(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tviz_main.main(["0", "--out", str(tmp_path)]) == 2
    assert "pass --cpu" in capsys.readouterr().err
    assert not any(tmp_path.iterdir())
