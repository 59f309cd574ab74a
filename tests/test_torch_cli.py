"""The port's pipe CLI (``python -m real_time_sdr_tpu_torch.cli``) on the CPU,
run in-process through ``main`` with ``--cpu --input --output``.

Bounds: PI/PTY/Program Service/RDS summary lines identical to the JAX
CLI's on the same capture; PCM byte counts exact; PCM byte-identical to
the in-process port receiver, across ``--pipeline`` depths and across
``--staged``; ``--segment 4`` within 1 LSB of per-block serving with an
identical RDS trail at tier 3 (measured 1 LSB; the JAX package holds 2 LSB
at tier 1, whose library-level segment equality tests/test_torch_modes.py
checks).
"""

import numpy as np
import pytest
import torch

from real_time_sdr_tpu_torch import cli
from real_time_sdr_tpu_torch.config import mode_config
from real_time_sdr_tpu_torch.models.receiver import Receiver
from real_time_sdr_tpu_torch.utils import synth
from real_time_sdr_tpu_torch.utils.audio import stereo_pcm

CFG = mode_config(0)
RDS_PREFIXES = ("PI:", "PTY:", "Program Service:", "RadioText:",
                "RDS summary:")


@pytest.fixture
def jcli(monkeypatch, tmp_path):
    """The JAX CLI module. Importing it sets defaults for JAX's compilation
    cache variables; set them first (to this test's directory) so nothing
    is written outside it and the process environment is restored."""
    for var, val in (("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc")),
                     ("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1"),
                     ("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")):
        monkeypatch.setenv(var, val)
    from real_time_sdr_tpu import cli as module
    return module


@pytest.fixture(scope="module")
def station(tmp_path_factory):
    iq, _ = synth.station_iq(CFG, 24, ps_name="CLI-TEST", pi=0x6D0F, pty=3)
    path = tmp_path_factory.mktemp("iq") / "station.raw"
    iq.tofile(path)
    return path, iq


def _run(main, args, inp, out, capsys):
    rc = main(["--cpu", *args, "--input", str(inp), "--output", str(out)])
    err = capsys.readouterr().err
    return rc, err, out.read_bytes() if out.exists() else b""


def _rds_lines(err):
    return [ln for ln in err.splitlines() if ln.startswith(RDS_PREFIXES)]


def test_cli_rds_lines_match_jax_cli(station, tmp_path, capsys, jcli):
    path, _ = station
    rc, err, pcm = _run(cli.main, ["0", "r", "--pll-tier", "3", "--stats"],
                        path, tmp_path / "port.pcm", capsys)
    assert rc == 0
    assert len(pcm) == 24 * CFG.audio_block * 2 * 2   # stereo int16
    jrc, jerr, jpcm = _run(jcli.main, ["0", "r", "--pll-tier", "3"], path,
                           tmp_path / "jax.pcm", capsys)
    assert jrc == 0 and len(jpcm) == len(pcm)
    lines = _rds_lines(err)
    assert lines == _rds_lines(jerr)
    assert "Program Service: CLI-TEST" in lines
    assert "PI: 6d0f" in lines and "PTY: Sports" in lines
    assert err.splitlines()[0] == jerr.splitlines()[0]   # output: ... line
    assert "x real time" in err and "block latency (ingest->PCM out)" in err


def test_cli_default_tier_equals_receiver(station, tmp_path, capsys):
    """`0 s` at the default tier 1, 3 blocks: the bytes of three per-block
    calls of the in-process receiver."""
    path, iq = station
    rc, _, pcm = _run(cli.main, ["0", "s", "--max-blocks", "3"], path,
                      tmp_path / "s.pcm", capsys)
    assert rc == 0
    rx = Receiver(0, stereo=True)
    assert rx.pll_tier == 1
    state, ref = rx.init_state(1), []
    blocks = torch.from_numpy(iq[:3 * 2 * CFG.block_size_iq]).reshape(3, -1)
    for b in range(3):
        state, out = rx.step(state, blocks[b][None])
        ref.append(stereo_pcm(out.left, out.right)[0].numpy())
    assert pcm == np.concatenate(ref).astype("<i2").tobytes()


def test_cli_no_positionals_is_mode0_mono(station, tmp_path, capsys):
    path, _ = station
    rc, err, pcm = _run(cli.main, ["--max-blocks", "2"], path,
                        tmp_path / "m.pcm", capsys)
    assert rc == 0
    assert len(pcm) == 2 * CFG.audio_block * 2
    assert err.startswith("output: 48000 Hz s16le mono")


def test_cli_pipeline_depth_identical(station, tmp_path, capsys):
    path, _ = station
    args = ["0", "r", "--pll-tier", "3", "--max-blocks", "8"]
    _, _, p0 = _run(cli.main, args + ["--pipeline", "0"], path,
                    tmp_path / "p0.pcm", capsys)
    _, _, p4 = _run(cli.main, args + ["--pipeline", "4"], path,
                    tmp_path / "p4.pcm", capsys)
    assert p0 == p4 and len(p0) == 8 * CFG.audio_block * 2 * 2


def test_cli_staged_identical(station, tmp_path, capsys):
    path, _ = station
    args = ["0", "r", "--pll-tier", "3", "--max-blocks", "6", "--segment", "2"]
    _, _, a = _run(cli.main, args + ["--staged", "0"], path,
                   tmp_path / "a.pcm", capsys)
    _, _, b = _run(cli.main, args + ["--staged", "1"], path,
                   tmp_path / "b.pcm", capsys)
    assert a == b and len(a) == 6 * CFG.audio_block * 2 * 2


def test_cli_segment_and_partial_group(station, tmp_path, capsys):
    """14 blocks as groups of 4 (the last holds 2, dispatched at its exact
    shape) against per-block serving."""
    path, _ = station
    args = ["0", "r", "--pll-tier", "3", "--max-blocks", "14"]
    _, e1, p1 = _run(cli.main, args, path, tmp_path / "b1.pcm", capsys)
    _, eg, pg = _run(cli.main, args + ["--segment", "4"], path,
                     tmp_path / "b4.pcm", capsys)
    a = np.frombuffer(p1, "<i2").astype(np.int32)
    b = np.frombuffer(pg, "<i2").astype(np.int32)
    assert len(b) == 14 * CFG.audio_block * 2
    assert a.shape == b.shape and np.abs(a - b).max() <= 1
    assert _rds_lines(eg) == _rds_lines(e1) and _rds_lines(e1)


def test_cli_survives_noise(tmp_path, capsys):
    rng = np.random.default_rng(11)
    noise = tmp_path / "noise.raw"
    rng.integers(0, 256, size=6 * 2 * CFG.block_size_iq,
                 dtype=np.uint8).tofile(noise)
    rc, _, pcm = _run(cli.main, ["0", "r", "--pll-tier", "3"], noise,
                      tmp_path / "n.pcm", capsys)
    assert rc == 0 and len(pcm) == 6 * CFG.audio_block * 2 * 2


@pytest.mark.parametrize("args", [
    ["--io-depth", "0"], ["--pipeline", "-1"],
    ["--stations", "0,300000"], ["--wide-fs", "9600000"],
    ["--output-dir", "out"], ["--retune", "0:0:100000"]])
def test_cli_bad_arguments_exit_2(args, tmp_path, capsys):
    rc = cli.main(["0", "r", "--cpu", *args, "--input",
                   str(tmp_path / "missing.raw")])
    assert rc == 2
    assert "error:" in capsys.readouterr().err


def test_cli_parser_matches_jax_surface(jcli):
    """Same positionals, flags, defaults and choices as the JAX CLI."""
    def surface(ap):
        return {a.dest: (tuple(a.option_strings), a.default,
                         None if a.choices is None else tuple(a.choices),
                         a.nargs) for a in ap._actions if a.dest != "help"}
    assert surface(cli.make_parser()) == surface(jcli.make_parser())
    with pytest.raises(SystemExit) as e:
        cli.make_parser().parse_args(["7"])
    assert e.value.code == 2


def test_cli_without_card_and_without_cpu_fails(monkeypatch, capsys):
    """No --cpu and no card: an error, never a silent CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["0", "m", "--input", "/nonexistent"]) == 2
    assert "no CUDA card" in capsys.readouterr().err
