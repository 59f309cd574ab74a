#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one card and check them.

    python3 chip_smoke.py [--profile DIR] [--sass DIR]
                          [--kernels | --loops | --experiments]

Run from the root of a checkout, on a machine with one NVIDIA Hopper card
and the CUDA toolkit. It imports no jax. Phases, each of which exits
non-zero on failure:

1. card and versions (``nvidia-smi`` name and power limit, torch, CUDA,
   ``torch.backends.cuda.matmul``'s ``allow_tf32``, which must be off, and
   ``allow_bf16_reduced_precision_reduction``, left at its default);
2. build: the kernels compile from ``real_time_sdr_tpu_torch/csrc`` into
   the git-ignored ``real_time_sdr_tpu_torch/_build/`` (one ``nvcc`` per
   source, in parallel);
3. kernels: each kernel against its plain PyTorch version on the card at
   its path's shapes, with median device times of both: frontend demod
   > 90 dB and every FIR-bank site > 110 dB (mode 0, 32 channels x 12
   blocks; each site prints the kernel body its geometry takes, tiled at
   up = down = 1 and general otherwise, its useful GFLOP and TFLOP/s);
   the channelizer epilogue byte-equal at the 64-station shape;
   the direct-form decimating FIR (``fir_decimate``, the audio resampler
   of modes 0-1) > 110 dB at mode 0's audio rails (64 rails x 88,200, K
   101, down 5) and mode 1's (64 x 158,760, K 101, down 9), both through
   its static body, at one geometry of its general body (K 101, down 4)
   and at 1 and 1,000 rows, each beside ``conv1d``, the FIR bank at the
   same geometry, the body taken and whether the output is bit-identical
   to the FIR bank's; the sequential PLL
   (``pll_scan``, the tier-1 carrier loop) > 80 dB against its plain
   version run on the same card tensors, with ``trig`` equal and the
   float carry within 1e-4 (``phase`` modulo 4*pi), at 32 channels x 1
   mode-0 block with the stereo and RDS loop parameters, from a cold carry
   and from a carry locked over 12 kernel blocks (it prints whether the
   two are bit-identical: the kernel's detector is the wrapped one, so
   they need not be), with its time at 1, 32 and 1,000 rows; the tier-2
   Newton twin > 40 dB against the kernel over 2 blocks, with its time.
   The two loops of the alternative RDS decode (``loop_checks``) against
   their plain loops on the same card tensors: ``mm_timing`` on the
   32-block baseband and on a 30,000-symbol stream (n_valid equal, > 100
   dB, bit-identical, or it fails), ``costas_scan`` on their symbols and at
   1, 64 and 4,096 rows x 1,200 samples (> 80 dB, ``freq_log`` and the
   carry within 1e-5; bit-identity printed), each with its ms, cycles per
   step at the max SM clock and share of the chain floor; then
   ``costas_scan``'s sine and cosine against ``sincosf`` over every f32 in
   [0, 2*pi] (the largest ulp difference printed).
   The FIR bank's general body alone at every case of
   ``utils/fir_digest.py``: each site of the serving path that takes it
   at its path's shape (modes 0-3 RDS baseband at 384 rows, modes 2-3
   audio at 64 rails, the alternative decode's 2 rows, the wideband
   path's 768, one CLI row, a time-sharded step's 32, and 2 and 64 rows)
   and the FIR property test's random geometries at 1, 2 and 33 rows, one
   line each (kernel and plain ms, bound from ``cost()``, useful TFLOP/s,
   the tile the shape picked, the SHA-256 of its output against the
   digest the body it replaced gave on the card, ``fir_bank_digests.json``),
   then the path sites' times beside that body's recorded ones and the
   cases where this run was slower; a digest not equal, < 110 dB, or the
   path's sites not running both tiles (lines and direct) fails.
   Beside each kernel's time stand its bound (the larger of its bytes,
   each input read and each output written once, over 3.35 TB/s and its
   f32 operations over 67 TFLOP/s, the H100 SXM data-sheet peaks of
   ``utils.logging``; the counts are the modules' ``cost()``) and,
   where one PyTorch call computes the same function (``conv1d`` for a
   FIR without upsampling), that call's time. Then the wideband fold
   products (library calls, ``models.channelizer.fold_product``) at the
   64-station shapes of both frontends and each precision they take
   (two-stage f32 and bf16, fused f32, bf16 and bf16x2) on random rails:
   the result must be float32 and > 90 dB against its plain version on the
   same card tensors (f32: the float64 product; bf16: both operands upcast
   to f32), with its time (median of 10 behind a sleep kernel), useful
   TFLOP/s and the bound of the frontend's ``cost()`` (``fold_cost`` for
   the two-stage product) against the peak of its kind (f32 67, bf16 989
   TFLOP/s); beside a bf16 product two yardsticks off the path: the same
   product with K unpadded (rows not a multiple of 16 bytes) and with a
   bf16 result (``fr @ w``); then (3b) the wideband precisions on noise:
   seeded random u8 bytes, 4 stations at 9.6 MS/s over two chained
   one-block segments, through each frontend on the card and on the CPU at
   each precision, one line per stage with the worse segment's SNR (fused:
   the fold product's output before the discriminator, then the demod;
   two-stage: the complex rails of ``forward``); the stages before the
   discriminator must hold 90 dB;
4. mode-0 path: a synthetic station tiled to 32 channels (distinct time
   shifts) through ``Receiver(0, stereo=True, rds=True, pll_tier=3,
   device="cuda").run_segment`` over three chained 12-block segments; the
   frontend, FIR-bank and ``fir_decimate`` launch counts must rise,
   through both FIR-bank bodies and the decimating FIR's static body;
   channel 0's PS/PI must decode, and PS on no fewer channels than the
   port's CPU run and the JAX receiver decode it on (30 of 32 at mode 0:
   on two shifts the capture's wrap point and the warm-up cost every copy
   of one PS segment); its left/right channels carry their tones;
   channels 0-1 of
   the first two segments must agree with the port's own CPU run (audio
   > 60 dB, RDS bits equal from a carried state); host-staged ingest: the
   three segments' staged cells (``utils.benchkit.stage_cells``, pinned
   host memory, asynchronous uploads) through ``run_segment_staged`` with
   the unstaged segment 1 between them must equal three unstaged calls in
   every output leaf and the final state (``torch.equal``), launch the
   frontend, FIR-bank and decimating-FIR kernels as often, and give the
   same ``digest_step``; the three cells through the graphed
   ``jit_run_segment_staged`` (``graph_check``: one eager call clean under
   ``torch.cuda.set_sync_debug_mode("error")``, then the chain eager and
   graphed, the first graphed call capturing: every output leaf and the
   state ``torch.equal``, the kernels' counts equal, the path's kernels
   launched by the replays); warm unstaged, staged and graphed staged
   segments in turns (8 each, host staging and H2D included, each H2D and
   the host's time to dispatch the call printed), the same calls with the
   operand on the card (``turns``: dispatch and wall ms) and one call's peak
   memory eager and graphed; the roofline
   report (``utils.logging.speed_of_light_report``) at 32 x 12, whose
   kernel rows must equal phase 3's bounds within 1 %; the channel bank's
   own entries (``ChannelBank.step`` on one block per channel,
   ``run_segment``, ``run`` over the 12 blocks, ``run_segment_demod`` on
   the frontend's demod) and the bench digest steps
   (``benchkit.digest_step``, ``digest_step_staged`` on the staged cells),
   each through ``graph_check`` against its eager form and ``graph_times``
   (eager and graphed calls in turns, each form's device busy and idle
   share, peak memory); warm segments are
   timed for the aggregate real-time multiple; then the same 32 x 12
   segments
   at the default tier 1 (``pll_scan`` launches rise, PS/PI decode, warm
   segments timed beside tier 3, the staged cells through
   ``jit_run_segment_staged`` as at tier 3, eager and graphed calls in
   turns and their peak memory, its roofline report beside the loops'
   chain floor; ``pll_scan`` again > 80 dB against its
   plain version, on the stereo and RDS pilots of one real tier-1 segment
   at (32, 88,200) with the plain version on channels 0-1, and at the
   CLI's (1, 7,350), each with kernel ms), and one 2-block segment at
   tier 2 (also through ``jit_step``, graphed against eager);
   then modes 1-3 at 32 ch x 12 blk, type r, tier 3: the frontend > 90 dB
   (mode 3 decimates by 3) and each new FIR-bank geometry (audio 1/9,
   147/800, 147/1280; RDS 247/960, 19/96, 95/768) > 110 dB against their
   plain versions, PS/PI decoded on channel 0 (PS on 31, 29 and 31 of 32
   channels, as on the CPU), channels 0-1 against the
   CPU run (audio > 60 dB, RDS bits equal from a carried state), warm
   segments timed, the segments through ``jit_step`` (``graph_check``);
   ``fir_decimate`` must launch at mode 1 and must not at modes 2-3, whose
   audio upsamples;
5. wideband paths: 64 stations on the 300 kHz raster in one 19.2 MS/s
   capture (3 real stations, the other slots empty), raw u8 bytes through
   ``ChannelBank.run_wideband_u8`` in 12-block segments, once through the
   two-stage ``Channelizer`` (the epilogue, frontend and FIR-bank kernels
   must launch, the FIR bank's tiled body among them) and once through the
   fused frontend (the FIR bank's tiled body must launch);
   ``fir_decimate`` must launch on both; PS/PI must
   decode on the 3 stations on both paths; the
   two-stage u8 of the first 2 blocks must agree with the CPU run (within
   1 LSB on < 1 % of bytes); warm segments are timed; the segments through
   ``run_wideband_u8_jit`` against ``run_wideband_u8`` (``graph_check``
   with the library gate: a leaf that differs is printed and held to > 90
   dB, integer leaves equal), eager and graphed calls in turns and their
   peak memory, at every precision below too. Then the same
   capture through the two-stage frontend at bf16 and the fused one at
   bf16 and bf16x2: PS/PI on the 3 stations (the gate), the kernels
   launched as at f32, the fused demod of the real stations > 35 dB (bf16)
   and > 45 dB (bf16x2) against the f32 run's, the two-stage u8 against
   the f32 run's (the share of bytes that differ and by how many LSB,
   printed), the RDS bits of segments 1-2 from the f32 run's carried state
   against the f32 run's (equal, or the count that differ, printed), warm
   segments beside the f32 run's. Then (5b) the JAX package's +20 dB
   adjacent-channel interferer (a weak station at -400 kHz beside one 10x
   louder at -200 kHz, 26 blocks at 9.6 MS/s, tier 1) through the
   two-stage frontend at f32 and bf16 and the fused one at f32, bf16 and
   bf16x2 into the graphed bank (``run_segment`` / ``run_segment_demod``):
   each station's left tone within 10 Hz, its PS and PI exact;
6. CLI: ``python -m real_time_sdr_tpu_torch.cli 0 r --stats`` in a
   subprocess with its defaults (tier 1, comb timing, pinned staged
   upload, one group in flight) on a 192-block synthetic capture (48
   blocks played 4 times): PS, PI
   and PTY on stderr, the exact PCM byte count, the kernels launched
   (its ``kernel launches`` line), its real-time multiple and p50/p99
   ingest->PCM latency against the 30.6 ms block deadline; the CLI serves
   the graphed ``jit_run_segment_staged``, and its PCM must equal an
   in-process eager ``run_segment_staged`` over the same one-block groups
   byte for byte; the same run on the eager entries (``EAGER_CLI``, the
   receiver's eager functions patched in; identical PCM), then
   ``--staged 0``, ``0`` and ``1`` with ``--stats`` (``1``, the default,
   serves ``jit_run_segment_staged``, ``0`` ``jit_step``: identical PCM and
   RDS lines), then the eager entries again; each run's ms per block,
   real-time multiple and p50/p99 printed; a staged ``--checkpoint`` pair over
   the capture's two halves joins to the first run's PCM byte for byte;
   ``2 r --pll-tier 1`` decodes PS;
7. wideband CLI at full width: the 64-station 19.2 MS/s capture of phase
   5 (36 blocks, 42.3 MB) in a file; ``python -m
   real_time_sdr_tpu_torch.cli 0 r --stations=<64 offsets> --wide-fs
   19200000 --output-dir D --segment 12 --stats`` in a subprocess: exit
   0, ``ch3 ps:``, ``ch32 ps:`` and ``ch62 ps:`` lines with the stations'
   PS, 64 PCM files of exactly 36 x audio_block x 2 samples, its ``kernel
   launches`` line (``fir_bank`` and ``fir_decimate`` above 0), its
   real-time multiple on the capture rate (the CLI serves the graphed
   ``run_wideband_u8_jit``); again with ``--pipeline 4`` (PCM
   byte-identical); on the bank's eager entry and then graphed again (PCM
   byte-identical; each run's ms per block, real-time multiple and
   segment p50/p99 printed); with ``--wb-fir bf16`` (the 3 stations' PS, 64
   PCM files of the exact size, the real stations' PCM against the first
   run's and both real-time multiples printed); with ``--retune
   1:0:<slot 32's offset>``
   (station 0 prints slot 32's PS after segment 1, the other 63 PCM files
   byte-identical); and as two runs with ``--checkpoint`` (18 blocks, then
   the rest: the joined PCM within 1 LSB of the first run's, the three
   stations' PS printed by the end);
8. parallel paths at full width (mode 0, type r): phase 4's 32 channels
   through ``ChannelBank.run_segment_grouped(group=8)`` (one graph of 4
   sub-batches) against its eager form (``graph_check``) and against
   ``run_segment`` (audio > 100 dB, RDS bits equal, bit-identity printed:
   a reduction's split may follow the batch rows); one 384-block capture
   (56.4 MB u8, 11.76 s of radio, synthesized whole: no two shards hold
   the same bytes) on the card, through ``time_sharded_run(rx, blocks, shards=32)`` at tier 3
   (the shards are the 32 rows of one batch) against ``rx.run_blocks`` on
   one row over all 384 blocks: audio > 100 dB on every block,
   ``rds_bits`` / ``rds_nbits`` equal, PS/PI from the sharded bits; the
   frontend, both FIR-bank bodies and ``fir_decimate`` must launch; the
   wall time and real-time multiple of both runs are printed. The same
   capture at the default tier 1 (approximate mode, ``pll_scan`` twice per
   step at 32 rows): every block after a shard's first > 25 dB against the
   sequential tier-1 run of the first 4 shards' blocks, shard 0's first
   block identical, PI decoded (PS from the 4-shard run: a 12-block shard
   re-aligns its slicer every 0.37 s). Joint: 4 shifted channels x 96
   blocks as 8 shards (32 rows) against ``run_blocks`` on the 4 rows, as
   the exact case per channel. Sharded wideband: phase 5's 64-station
   capture through ``ShardedWideband`` and ``ShardedFusedWideband`` on
   ``[cuda:0, cuda:0]`` (two replicas, 32 stations each): the 3 real
   stations > 70 dB with RDS bits equal against phase 5's unsharded
   outputs, their PS decoded, ``chan_epilogue`` launched twice per
   two-stage segment, and one ``retune`` of the last station (second
   shard) onto slot 32's transmitter that rewrites only the second
   shard's weights, decodes slot 32's PS there and leaves the first
   shard's outputs byte-identical, replaying the shards' graphs (no new
   graph). Every run of phase 8 is a graph replay: the exact, tracked
   (PS/PI decoded; its first call captures the 384-step decode loop),
   approximate and joint time-sharded runs against their eager form
   (``time_shard._sharded_run``) and each shard's wideband step against
   ``_step_one``, through ``graph_check`` and ``graph_times``;
9. the diagnostic entry point at full width: ``AltRdsReceiver(0,
   device="cuda").decode`` on phase 3's 32-block station (PS, PI, >= 5
   groups, the Costas track within 1.5 Hz of the true 11.4 Hz, bits equal
   to the port's CPU run, ``frontend_fused``, ``fir_bank``, ``mm_timing``
   and ``costas_scan`` launched once each; warm decodes timed, median of
   5, in seconds of radio per wall second; the host split of a warm
   decode, median of 5: upload, frontend, ``_device_chain``, the fetches
   and ``SyncByOffsetDecoder.feed``, eager, and graphed with the replay of
   the frontend and the chain in place of both; the device half through
   ``graph_check`` and the whole decode eager and graphed through
   ``graph_times``; one warm decode under torch.profiler:
   device busy, idle share and the top 10 device ops); then in subprocesses ``python
   -m real_time_sdr_tpu_torch.viz 0 --out D --alt --golden`` (the default
   24 blocks: every file, ``alt path: PS='VIZ-DEMO'``, each ``golden SNR``
   line at or above the JAX receiver's against the same oracle minus 1 dB,
   GOLDEN_SNR_JAX, printed beside the CPU run's) beside ``viz 0 --ber
   --blocks 30 --sigmas 0,0.08`` (4 CSV rows, BER 0 and PS by both framers
   at span 2 at sigma 0), then ``cli 0 r --monitor snap.npz
   --monitor-every 4`` on a 48-block capture with ``viz 0 --live
   snap.npz --frames 2`` beside it (both exit 0, ``live.png`` written);
10. the walkthroughs (``real_time_sdr_tpu_torch/examples/``, the ports of
   ``examples/*.py``), each ``run(device="cuda")`` on its synthesized
   fixture with its script's own check (a ``GateError`` fails the run):
   ``mono_to_wav`` (24 blocks, the WAV holds every sample at 48 kHz),
   ``stereo_rds_events`` (96 blocks at tier 3: PS, PI, PTY, RadioText, the
   clock, AF and TP as sent), ``wideband_multistation`` (4 stations at 9.6
   MS/s, 24 one-block replays of ``run_wideband_jit``: 4/4 PS as sent),
   ``retune_station`` (2 stations, 48 blocks, station 1 retuned after 24:
   ch0 ``SVC-A``, ch1 ``SVC-B`` then ``SVC-C``, no new graph, station 0
   ``torch.equal`` to a run with no retune), ``time_sharded_offline`` (16
   blocks as 8 shards against ``jit_run_blocks``: RDS bits equal, every
   block's audio > 100 dB) and ``checkpoint_resume`` (12 blocks as 6 + 6
   through a checkpoint: audio and RDS bits equal); one line each with its
   wall seconds, its result and the kernels it launched (its counts set
   to 0 just before it and read just after); ``mono_to_wav`` and
   ``stereo_rds_events`` again on the CPU on the same bytes (audio > 60 dB,
   the events identical); then ``python -m
   real_time_sdr_tpu_torch.examples.stereo_rds_events`` in a temporary
   directory (exit 0, the card run's summary line);
11. the experiments (``real_time_sdr_tpu_torch/experiments/``, the ports
   of ``experiments/*.py``) at full width: the wideband scale ladder
   (``wideband64``: the fused frontend at 64, 128 and 256 stations, 19.2 /
   38.4 / 76.8 MS/s, ``taps_factor`` 2 / 4 / 8, f32, 8-block segments, and
   256 stations at bf16; per cell ms per block, MS/s wideband, x real time
   on the capture, MS/s of station IQ, the weights' build, the first call
   and the peak memory; each cell's graphs and buffers freed before the
   next), its decode check at 128 and 256 stations at both precisions (3
   real stations up to the band edge, 26 blocks: PS and PI exact; the
   scenes synthesized in two worker processes while the card runs), every
   FIR kernel call of one eager 256-station segment held against its
   plain version on the path's own card tensors (> 110 dB; body, the
   general body's tile, ms beside its bound), ``retune_latency`` at 64
   stations (steady ms, retune p50 / min / max, no new graph, outputs
   equal to the runs with no retune), ``e2e_latency`` (the CLI paced at a
   capture's rate: p50 / p99, at the script's ``--segment 6 --pipeline
   2`` and at the CLI's defaults; under ``--drop-oldest`` behind a slow sink:
   blocks dropped through the native reader; 8 stations live in one 9.6
   MS/s capture: >= 1x real time, both PS), then ``stage_decompose``,
   ``mode_floors``, ``trace_top --mode 0`` and ``trace_wideband`` (64
   stations, fused) at their defaults (their JSON lines); each
   experiment's kernel counts, and an ``experiments:`` JSON line with
   phase 11's wall seconds.

Each path's kernel counts are set to 0 just before it and read just after
(a CLI run is a process of its own: its counts start at 0 and are read from
its ``kernel launches`` line). A graph replay calls no kernel wrapper: the
graph cache adds the counts its capture recorded on every replay
(``utils.graphs``), so a graphed path's counts are its eager path's.
A ``graphs:`` JSON line gathers the graphed paths' numbers. The last two
lines are the kernels' JSON and the device JSON.
``--profile DIR`` also writes a torch.profiler table and Chrome trace of
one warm segment of each path (the staged mode-0 segment among them, and
its graphed form) to DIR, the second of two calls recorded, and prints the
segment's device busy time, idle share, FIR-bank device time and the
device time of its matrix products (``aten::mm``: the wideband fold
product), at every precision of phase 5. Where the profiler recorded no
device time for the product, its time from CUDA events at the segment's
shapes is added to device busy (``utils.logging.device_busy``), and the
line says which of the two it is; a second line gives the same call
recorded alone in a window of its own (device busy, device records,
whether the products were recorded).
``--sass DIR`` writes ``cuobjdump -sass`` of the built library's
``pll_scan``, ``frontend_fused``, ``mm_timing`` and ``costas_scan`` kernels
to DIR. ``--kernels`` stops
after phase 3 (build and kernel checks): a short first run of a changed
kernel; it prints no result line. ``--loops`` checks and times only the two
loops of the alternative decode after the build, and stops; it runs from an
older checkout of the port too (copy this script there), so that two forms
of the loops can be timed in one call. ``--experiments`` runs phases 1-2
and then phase 11 only, and stops; it prints no result line.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import math
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

CH, BLOCKS, SEGMENTS = 32, 12, 3
CLI_BLOCKS = 192      # the CLI capture: 5.88 s of radio at mode 0
PS, PI, PTY = "H100 FM ", 0x3A5C, 5
# channels of the 32 shifted copies on which PS decodes, by mode: what the
# port's CPU run and (mode 0) the JAX receiver give on the same shifts. On
# the others the capture's wrap point and the warm-up together cost every
# copy of one PS segment of the 36-block capture.
PS_CHANNELS = {0: 30, 1: 31, 2: 29, 3: 31}
WB_STATIONS, WB_MULT, WB_SLOTS = 64, 8, (3, 32, 62)
# phase 11: the wideband ladder's cells (stations, precision), each at
# 8-block segments; the rungs whose decode check runs
LADDER_CELLS = ((64, "f32"), (128, "f32"), (256, "f32"), (256, "bf16"))
LADDER_SEG, DECODE_RUNGS = 8, (128, 256)
RDS_PREFIXES = ("PI:", "PTY:", "Program Service:", "RadioText:",
                "RDS summary:")
# the alternative RDS receiver's station (phases 3 and 9): 32 mode-0 blocks,
# a +200 ppm pilot, so the 57 kHz subcarrier lands 11.4 Hz off the mixer
ALT_BLOCKS, ALT_PS, ALT_PI, ALT_PPM = 32, "ALT-PATH", 0x2ABC, 200.0
ALT_SPS, LONG_SYMBOLS = 16, 30_000
# the figure sheet's golden SNR lines at the default 24 blocks, dB, as the
# port's CPU run prints them and as the JAX receiver's stages give them
# against the same oracle (tests/test_torch_viz.py records both). The
# first block's transient sets the audio and RDS lines: the PLL's atan2
# takes the signs of the pilot filter's leading exact zeros, which the
# CPU's framed matmul and the card's direct-form FIR leave differently, so
# the card's lines are held at or above the JAX receiver's minus 1 dB
GOLDEN_SNR_CPU = {"FM demod (IF)": 132.0, "Audio L": 133.2,
                  "Audio R": 133.3, "RDS RRC output": 122.1}
GOLDEN_SNR_JAX = {"FM demod (IF)": 129.0, "Audio L": 78.5,
                  "Audio R": 78.6, "RDS RRC output": 45.8}
# the CLI with the receiver's and the bank's eager functions in place of
# their graphed entries (the CLI has no such option): the eager side of
# the CLI measurements, and the PCM it must equal byte for byte
EAGER_CLI = (
    "import sys; "
    "from real_time_sdr_tpu_torch.models.receiver import Receiver as R; "
    "from real_time_sdr_tpu_torch.parallel.channel import ChannelBank as B; "
    "R.jit_step = R.step; R.jit_run_segment_staged = R.run_segment_staged; "
    "B.run_wideband_u8_jit = B.run_wideband_u8; "
    "from real_time_sdr_tpu_torch import cli; sys.exit(cli.main())")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def snr_db(ref, y) -> float:
    ref = ref.double()
    err = (y.double() - ref).pow(2).sum().item()
    return 10.0 * math.log10(ref.pow(2).sum().item() / max(err, 1e-300))


def csnr_db(torch, ref, y) -> float:
    """snr_db of complex tensors over their (re, im) pairs."""
    return snr_db(torch.view_as_real(ref), torch.view_as_real(y))


def device_ms(torch, fn, reps: int = 10) -> float:
    """Median device time of fn per call: the calls queue up behind a
    sleeping kernel, so host launch cost stays out of the measurement."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, flops: float, kind: str = "") -> dict:
    """The least time the card could take, in ms, and what bounds it
    (``utils.logging.roofline_ms``: the H100 SXM data-sheet peaks, the
    operations against the peak of the cost's ``kind``)."""
    from real_time_sdr_tpu_torch.utils.logging import roofline_ms
    ms, by = roofline_ms(nbytes, flops, kind)
    return dict(bound_ms=ms, bound_by=by)


def leaves(tree):
    """Tensor leaves of a state or output tree (NamedTuples, None)."""
    if isinstance(tree, tuple):
        return [x for t in tree for x in leaves(t)]
    return [] if tree is None else [tree]


def band_power(np, x, fs, f, width=30.0):
    sp = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    freqs = np.fft.rfftfreq(len(x), 1 / fs)
    return sp[(freqs > f - width) & (freqs < f + width)].sum()


def tile_channels(np, iq, cfg):
    """One station's capture tiled to CH channels with distinct time shifts,
    cut into SEGMENTS segments of BLOCKS blocks: [(CH, seg bytes)] u8."""
    seg_len = 2 * cfg.block_size_iq * BLOCKS
    pairs = iq.reshape(-1, 2)
    shifts = [0] + [int(s) for s in
                    np.random.default_rng(0).integers(1, len(pairs), CH - 1)]
    tiled = np.stack([np.roll(pairs, -s, axis=0).reshape(-1)
                      for s in shifts])
    return [np.ascontiguousarray(tiled[:, k * seg_len:(k + 1) * seg_len])
            for k in range(SEGMENTS)]


def decode(RdsFramer, bits, nbits, c):
    fr = RdsFramer()
    for b in range(bits.shape[1]):
        fr.feed(bits[c, b, :nbits[c, b]])
    return fr.events


def wideband_stages(torch, fe, raw, device):
    """One wideband frontend over the segments of raw (S, 2N) u8 from its
    initial state: {stage: [per-segment f32 tensor]}. Fused: ``y``, the
    fold product of the tail-prefixed rails (before the rotation and the
    discriminator), ``y_float64``, the same operands' product in float64,
    and ``demod``; two-stage: ``rails``, the stacked (i, q) station
    basebands of ``forward``."""
    from real_time_sdr_tpu_torch.models.channelizer import fold_product
    from real_time_sdr_tpu_torch.models.wideband_frontend import (
        FusedWidebandFrontend, u8_to_rails)
    state, out = fe.init_state(), {}
    for seg in raw:
        i, q = u8_to_rails(seg.to(device))
        if isinstance(fe, FusedWidebandFrontend):
            fr = fe.frames(torch.cat([state.i_tail, i]),
                           torch.cat([state.q_tail, q]))
            out.setdefault("y", []).append(fold_product(fr, fe.w))
            out.setdefault("y_float64", []).append(
                fr.double() @ fe.w.double())
            demod, state = fe(i, q, state)
            out.setdefault("demod", []).append(demod)
        else:
            (i_ds, q_ds), state = fe(i, q, state)
            out.setdefault("rails", []).append(torch.stack([i_ds, q_ds]))
    return out


def alt_station(torch, alt_rx):
    """The alternative RDS receiver's station: ALT_BLOCKS mode-0 blocks
    with an ALT_PPM pilot -> (u8 capture, its demod through the receiver's
    frontend on the receiver's device)."""
    from real_time_sdr_tpu_torch.utils import synth
    iq, _ = synth.station_iq(alt_rx.cfg, ALT_BLOCKS, ps_name=ALT_PS,
                             pi=ALT_PI,
                             pilot_freq=19_000.0 * (1 + ALT_PPM * 1e-6))
    x = torch.from_numpy(iq).to(alt_rx.device)[None]
    return iq, alt_rx.frontend(x, alt_rx.frontend.init_state(1))[0][0]


def loop_checks(torch, np, card, sm_mhz, alt_bb, alt_mu0, mm_gain):
    """The two loops of the alternative RDS decode, ``mm_timing`` and
    ``costas_scan``, against their plain versions on the same card tensors
    at the path's shapes: the 32-block baseband, a 30,000-symbol stream, and
    the Costas loop at 1, 64 and 4,096 rows x 1,200 samples. Each line holds
    the kernel's time (median of 10 behind a sleep kernel), its cycles per
    step at the max SM clock, its share of the chain floor (steps x chain
    operations x the latency of a dependent f32 operation) and whether it
    is bit-identical to the plain version. Fails where ``mm_timing`` is not
    bit-identical, or a loop misses its gate. Returns {name: row}."""
    from real_time_sdr_tpu_torch.ops.costas import (
        CostasCarry, coarse_freq_bpsk, costas_scan_plain)
    from real_time_sdr_tpu_torch.ops.cuda.costas_scan import (
        COSTAS_CHAIN_OPS, costas_cost, costas_kernel)
    from real_time_sdr_tpu_torch.ops.cuda.mm_timing import (
        MM_CHAIN_OPS, mm_timing_cost, mm_timing_kernel)
    from real_time_sdr_tpu_torch.ops.filters import design_rrc
    from real_time_sdr_tpu_torch.ops.symbol_timing import mm_timing_plain
    from real_time_sdr_tpu_torch.utils.logging import F32_LATENCY_CYCLES
    dev = alt_bb.device

    def plain_ms(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)

    def timing(res, steps, ops, t_k):
        """Adds the step's cycles and the chain floor's share to res."""
        res["chain_floor_ms"] = (steps * ops * F32_LATENCY_CYCLES
                                 / (sm_mhz * 1e3))
        res["cycles_per_step"] = t_k * sm_mhz * 1e3 / max(steps, 1)
        res["floor_share"] = res["chain_floor_ms"] / t_k
        return (f"kernel {t_k:.4f} ms, {res['cycles_per_step']:.1f} cycles "
                f"per step at {sm_mhz:.0f} MHz, {100 * res['floor_share']:.1f}"
                f" % of the chain floor {res['chain_floor_ms']:.4f} ms "
                f"({ops} dependent f32 operations a step); bound "
                f"{res['bound_ms']:.6f} ms ({res['bound_by']}), no library "
                f"call; on {card}")

    def check_mm(label, z, mu0, gain):
        """mm_timing on z (N,) complex64 against the plain loop: n_valid
        equal, symbols > 100 dB and bit-identical."""
        sk, nk = mm_timing_kernel.launch(z, float(ALT_SPS), gain, mu0)
        torch.cuda.synchronize()
        n_valid = int(nk)
        t_k = device_ms(torch, lambda: mm_timing_kernel.launch(
            z, float(ALT_SPS), gain, mu0))
        cost = mm_timing_cost(z.shape[0], sk.shape[0], n_valid)
        (sp, npl), t_p = plain_ms(lambda: mm_timing_plain(
            z, float(ALT_SPS), gain, mu0))
        s_ = csnr_db(torch, sp, sk)
        same = torch.equal(sk, sp) and int(npl) == n_valid
        res = dict(n=z.shape[0], symbols=n_valid, ms=t_k, plain_ms=t_p,
                   **bound(cost["bytes"], cost["flops"]), library_ms=None,
                   symbols_per_us=n_valid / (t_k * 1e3), snr_db=s_,
                   max_abs_err=(sk - sp).abs().max().item(),
                   bit_identical=same, plain_symbols=int(npl))
        text = timing(res, n_valid, MM_CHAIN_OPS, t_k)
        print(f"kernel mm_timing[{label}]: ({z.shape[0]},) complex64 -> "
              f"{n_valid} symbols (plain {int(npl)}), SNR {s_:.1f} dB vs "
              f"plain, bit-identical {same}; plain (one call) {t_p:.1f} ms; "
              f"{text}")
        if not (int(npl) == n_valid and s_ > 100.0 and same):
            fail(f"mm_timing[{label}] disagrees with its plain version "
                 f"(n_valid {n_valid} vs {int(npl)}, {s_:.1f} dB, "
                 f"bit-identical {same})")
        return res, sk

    def check_costas(label, z, carry):
        """costas_scan on z (..., N) against the plain loop: derotated
        > 80 dB, freq_log and the carry within 1e-5 rad/sample."""
        dk, fk, ck = costas_kernel.launch(z, carry, 0.02, 1e-4)
        torch.cuda.synchronize()
        t_k = device_ms(torch, lambda: costas_kernel.launch(z, carry, 0.02,
                                                            1e-4))
        rows, n = z.numel() // z.shape[-1], z.shape[-1]
        cost = costas_cost(rows, n)
        (dp, fp, cp), t_p = plain_ms(lambda: costas_scan_plain(
            z, carry, 0.02, 1e-4))
        s_ = csnr_db(torch, dp, dk)
        ferr = (fk - fp).abs().max().item()
        dph = (ck.phase - cp.phase).abs()
        cerr = max(torch.minimum(dph, 2 * math.pi - dph).max().item(),
                   (ck.freq - cp.freq).abs().max().item())
        same = (torch.equal(dk, dp) and torch.equal(fk, fp)
                and all(torch.equal(u, v) for u, v in zip(ck, cp)))
        res = dict(shape=list(z.shape), ms=t_k, plain_ms=t_p,
                   **bound(cost["bytes"], cost["flops"]), library_ms=None,
                   symbols_per_us=rows * n / (t_k * 1e3), snr_db=s_,
                   max_abs_err=max(ferr, cerr, (dk - dp).abs().max().item()),
                   freq_log_err=ferr, bit_identical=same)
        text = timing(res, n, COSTAS_CHAIN_OPS, t_k)
        print(f"kernel costas_scan[{label}]: {tuple(z.shape)} complex64: SNR "
              f"{s_:.1f} dB vs plain, freq_log max err {ferr:.3g}, carry max "
              f"err {cerr:.3g}, bit-identical {same}; plain (one call) "
              f"{t_p:.1f} ms; {text}")
        if not (s_ > 80.0 and ferr < 1e-5 and cerr < 1e-5):
            fail(f"costas_scan[{label}] disagrees with its plain version "
                 f"({s_:.1f} dB, freq_log err {ferr:.3g})")
        return res

    out = {}
    out["mm_alt"], alt_syms = check_mm(f"alt path, {ALT_BLOCKS} blk", alt_bb,
                                       alt_mu0, mm_gain)
    alt_f0 = coarse_freq_bpsk(alt_syms)
    out["costas_alt"] = check_costas(
        f"alt path, {ALT_BLOCKS} blk", alt_syms,
        CostasCarry(torch.zeros_like(alt_f0), alt_f0))
    # a long stream: ~25 s of RDS, BPSK impulses at the instants of a
    # +2000 ppm transmitter clock, RRC-shaped (the JAX package's fast-clock
    # case)
    eff_sps = ALT_SPS * (1.0 - 2000e-6)
    rng_l = np.random.default_rng(1)
    pos = np.arange(LONG_SYMBOLS) * eff_sps
    n_long = int(pos[-1]) + ALT_SPS + 2
    zl = np.zeros(n_long + 1)
    i0 = pos.astype(np.int64)
    sym_l = rng_l.choice([-1.0, 1.0], size=LONG_SYMBOLS)
    np.add.at(zl, i0, sym_l * (1.0 - (pos - i0)))
    np.add.at(zl, i0 + 1, sym_l * (pos - i0))
    zl = np.convolve(zl, design_rrc(2375.0 * ALT_SPS, 151), mode="same")
    zl = torch.from_numpy(zl[:n_long].astype(np.complex64)).to(dev)
    out["mm_long"], syms_long = check_mm(
        f"long stream, {LONG_SYMBOLS} symbols", zl,
        torch.zeros((), device=dev), 0.05)
    if not n_long / ALT_SPS + 4 < out["mm_long"]["symbols"] < \
            syms_long.shape[0]:
        fail("mm_timing on the long stream lost the fast clock's symbols "
             "or ran into its buffer")
    out["costas_long"] = check_costas(
        f"long stream, {syms_long.shape[0]} symbols", syms_long,
        CostasCarry(*(torch.zeros((), device=dev) for _ in range(2))))
    # many rows: noisy BPSK rows with residual carriers and carried phases
    rng_r = np.random.default_rng(5)
    for rows in (1, 64, 4096):
        f = rng_r.uniform(-0.05, 0.05, (rows, 1))
        zr = (rng_r.choice([-1.0, 1.0], (rows, 1200))
              * np.exp(1j * (f * np.arange(1200) + 0.7))
              + 0.05 * rng_r.standard_normal((rows, 1200)))
        out[f"costas_rows_{rows}"] = check_costas(
            f"{rows} rows x 1200", torch.from_numpy(zr.astype(
                np.complex64)).to(dev), CostasCarry(
                    torch.from_numpy(rng_r.uniform(0, 6.28, rows).astype(
                        np.float32)).to(dev),
                    torch.from_numpy(f[:, 0].astype(np.float32)).to(dev)))
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    print(f"SM clock read after the loops' timings: {clk.stdout.strip()} "
          f"MHz (cycles above at the max, {sm_mhz:.0f} MHz)")
    return out


def alt_decode_split(torch, np, alt_rx, iq, bits, graphed):
    """The host split of a warm ``AltRdsReceiver.decode``: its steps as
    decode takes them (the upload; eager: the frontend and
    ``_device_chain``, graphed: the replay of both; the ``.cpu()``
    fetches, ``SyncByOffsetDecoder.feed``), each on the host clock up to a
    synchronize, median of 5 ms each. The bits must equal decode's. Prints
    the split; returns {step: ms}."""
    from real_time_sdr_tpu_torch.models.rds_framing import \
        SyncByOffsetDecoder
    steps = (("upload", "replay", "fetch", "feed") if graphed else
             ("upload", "frontend", "device_chain", "fetch", "feed"))
    times = {k: [] for k in steps}
    for _ in range(5):
        t = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            t.append(time.perf_counter())
        x = torch.from_numpy(np.ascontiguousarray(iq)).to(alt_rx.device)
        mark()
        if graphed:
            bb, syms, derot, freq_log, bits_t, n_valid = alt_rx.graphs(
                alt_rx._device_half, ("decode",), x[None])
        else:
            demod, _ = alt_rx.frontend(x[None],
                                       alt_rx.frontend.init_state(1))
            mark()
            bb, syms, derot, freq_log, bits_t, n_valid = \
                alt_rx._device_chain(demod[0])
        mark()
        nv = int(n_valid)
        bits_np = bits_t.cpu().numpy()[:max(0, nv - 1)]
        for v in (bb, syms[:nv], derot[:nv], freq_log[:nv]):
            v.cpu().numpy()
        mark()
        SyncByOffsetDecoder().feed(bits_np)
        mark()
        for k, a, b in zip(steps, t, t[1:]):
            times[k].append((b - a) * 1e3)
    if not np.array_equal(bits_np, bits):
        fail("the alternative decode's host split gave other bits than "
             "decode")
    split = {k: statistics.median(v) for k, v in times.items()}
    print(f"alternative decode, {'graphed' if graphed else 'eager'}, host "
          "split (median of 5, host clock up to a synchronize): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
          + f"; sum {sum(split.values()):.3f} ms")
    return split


def device_busy_ms(torch, fn) -> float:
    """Device busy ms of one call of fn up to a synchronize: the self device
    time of every device op torch.profiler records (a graph replay's
    kernels among them), in the second of two profiled calls (a window's
    first records can go missing; ``utils.logging.device_busy``). Says so
    where matrix products ran that the profiler did not record."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from real_time_sdr_tpu_torch.utils.logging import device_busy
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()             # the recorded window: the second call
        fn()
        torch.cuda.synchronize()
    busy = device_busy(prof.key_averages())
    if busy["source"] == "missing":
        print(f"  (this device busy lacks {busy['calls']} matrix product(s) "
              "the profiler recorded no device time for)")
    return busy["busy_ms"]


def profile_segment(torch, card, path, name, run, run_ms, top=0,
                    product=None):
    """torch.profiler table of one warm segment -> DIR/<name>.txt and its
    Chrome trace -> DIR/<name>.json (``utils.logging.device_trace``, the
    second of two calls recorded); prints device busy time and idle share,
    and with ``top`` the top device kernels by their own device time.
    ``product`` runs one of the segment's matrix products (the wideband
    fold product) at its shapes: where the profiler recorded no device time
    for them, their time from CUDA events is added to device busy
    (``utils.logging.device_busy``), and the line says which. Beside it,
    the same call alone in a window of its own (-> DIR/<name>_cold.json):
    its device busy, its count of device records against the warm
    window's, and whether it recorded the products."""
    from torch.autograd import DeviceType

    from real_time_sdr_tpu_torch.utils.logging import (device_busy,
                                                       device_trace)
    torch.cuda.synchronize()
    # the same call alone in a window of its own (how a window used to
    # be recorded): whether a window's first records go missing
    with device_trace(path, f"{name}_cold") as prof:
        run()
        torch.cuda.synchronize()
    cold = prof.key_averages()
    with device_trace(path, name, warmup=1) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()             # the recorded window: the second call
        run()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    event_ms = None if product is None else device_ms(torch, product)
    busy = device_busy(avg, event_ms)
    cold_busy = device_busy(cold)

    def kernels(rows):
        return sum(e.count for e in rows if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("ProfilerStep"))
    fir_us = {body: sum(e.self_device_time_total for e in avg
                        if e.device_type == DeviceType.CUDA
                        and f"fir_bank_{body}" in e.key)
              for body in ("tiled", "general")}
    fd_us = sum(e.self_device_time_total for e in avg
                if e.device_type == DeviceType.CUDA
                and "fir_decimate" in e.key)
    calls = f"{busy['calls']} call(s)"
    if busy["source"] == "none":
        mm_txt = "none ran"
    elif busy["source"] == "missing":
        mm_txt = (f"{calls} not recorded by the profiler and not timed: "
                  "device busy lacks them")
    else:
        mm_txt = (f"{busy['product_ms']:.3f} ms ({calls}), "
                  + ("recorded by the profiler" if busy["source"] ==
                     "profiler" else "product from CUDA events, added to "
                     "device busy (the profiler recorded no device time "
                     "for it)")
                  + ("" if event_ms is None else
                     f"; CUDA events {event_ms:.3f} ms a call"))
    table = avg.table(sort_by="device_time_total", row_limit=40)
    out = os.path.join(path, f"{name}.txt")
    with open(out, "w") as f:
        f.write(f"{card}\n{table}\n")
    print(f"profile of one warm {name} segment -> {out}: device busy "
          f"{busy['busy_ms']:.3f} ms of the ~{run_ms:.3f} ms run (idle share "
          f"{1 - busy['busy_ms'] / run_ms:.2f}); FIR-bank kernels "
          f"{sum(fir_us.values()) / 1e3:.3f} ms (tiled "
          f"{fir_us['tiled'] / 1e3:.3f}, general "
          f"{fir_us['general'] / 1e3:.3f}); fir_decimate "
          f"{fd_us / 1e3:.3f} ms; matrix products (aten::mm) {mm_txt}")
    print(f"  {name}, the same call in a window of its own: device busy "
          f"{cold_busy['busy_ms']:.3f} ms, {kernels(cold)} device records "
          f"against {kernels(avg)} in the warm window; matrix products "
          + {"none": "none ran", "profiler": "recorded",
             "missing": "not recorded"}[cold_busy["source"]])
    print("\n".join(table.splitlines()[:22]))
    if top:
        dev_ev = sorted((e for e in avg if e.device_type == DeviceType.CUDA
                         and e.self_device_time_total > 0
                         and not e.key.startswith("ProfilerStep")),
                        key=lambda e: -e.self_device_time_total)
        print(f"top {top} device ops of the {name} run by device time: "
              + "; ".join(f"{e.key[:60]} {e.self_device_time_total:.1f} us "
                          f"x{e.count}" for e in dev_ev[:top]))
    return busy


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="write a torch.profiler table of one warm segment "
                    "of each path into this directory")
    ap.add_argument("--sass", metavar="DIR",
                    help="write cuobjdump -sass of the pll_scan, "
                    "frontend_fused, mm_timing and costas_scan kernels into "
                    "this directory")
    ap.add_argument("--kernels", action="store_true",
                    help="stop after the kernel checks (phase 3); prints "
                    "no result line")
    ap.add_argument("--experiments", action="store_true",
                    help="run the card check and the build, then only phase "
                    "11 (the experiments), and stop; prints no result line")
    ap.add_argument("--loops", action="store_true",
                    help="check and time only the two loops of the "
                    "alternative RDS decode (mm_timing, costas_scan) after "
                    "the build, and stop; runs from an older checkout too, "
                    "to time its form in the same call; prints no result "
                    "line")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a card")
    try:
        from real_time_sdr_tpu_torch.examples import GateError
        from real_time_sdr_tpu_torch.experiments import (
            e2e_latency, mode_floors, retune_latency, stage_decompose,
            trace_top, trace_wideband, wideband64)
        from real_time_sdr_tpu_torch.examples import snr_db as ex_snr_db
        from real_time_sdr_tpu_torch.examples import (
            checkpoint_resume, mono_to_wav, retune_station,
            stereo_rds_events, time_sharded_offline, wideband_multistation)
        from real_time_sdr_tpu_torch.models.channelizer import (
            Channelizer, fold_product, fold_product_plain)
        from real_time_sdr_tpu_torch.models.rds_alt import AltRdsReceiver
        from real_time_sdr_tpu_torch.models.rds_framing import RdsFramer
        from real_time_sdr_tpu_torch.models.receiver import Receiver
        from real_time_sdr_tpu_torch.models.wideband_frontend import (
            WB_DTYPES, FusedWidebandFrontend, make_wideband_frontend,
            u8_to_rails)
        from real_time_sdr_tpu_torch.ops.cuda import _build
        from real_time_sdr_tpu_torch.ops.cuda import (KERNELS, chan_epilogue,
                                                      fir_bank, fir_decimate,
                                                      frontend_fused)
        from real_time_sdr_tpu_torch.ops.cuda.chan_epilogue import \
            chan_epilogue_plain
        from real_time_sdr_tpu_torch.ops.cuda.fir_bank import (
            fir_bank_plain, kernel_body)
        from real_time_sdr_tpu_torch.ops.cuda.fir_kernels import \
            fir_decimate_plain
        from real_time_sdr_tpu_torch.ops.cuda.fir_kernels import \
            kernel_body as decimate_body
        from real_time_sdr_tpu_torch.ops.cuda.frontend_fused import \
            frontend_plain
        from real_time_sdr_tpu_torch.ops.cuda.chan_epilogue import \
            epilogue_cost
        from real_time_sdr_tpu_torch.ops.cuda.costas_scan import \
            costas_kernel
        from real_time_sdr_tpu_torch.ops.cuda.mm_timing import \
            mm_timing_kernel
        from real_time_sdr_tpu_torch.ops.cuda.pll_scan import (
            PLL_CHAIN_OPS, pll_scan_kernel)
        from real_time_sdr_tpu_torch.ops.fir import (DecimatingFIR, PolyFIR,
                                                     make_bank)
        from real_time_sdr_tpu_torch.ops.pll import (PllCarry, pll_init,
                                                     pll_newton,
                                                     pll_scan_plain)
        from real_time_sdr_tpu_torch.ops.symbol_timing import comb_acquire
        from real_time_sdr_tpu_torch.ops.sync import PllLoop
        from real_time_sdr_tpu_torch.parallel.channel import (ChannelBank,
                                                              gather,
                                                              grouped_step)
        from real_time_sdr_tpu_torch.parallel.time_shard import (
            _sharded_run, time_sharded_run, time_sharded_run_bank)
        from real_time_sdr_tpu_torch.parallel.wideband import (
            ShardedFusedWideband, ShardedWideband)
        from real_time_sdr_tpu_torch.utils import benchkit, fir_digest, synth
        from real_time_sdr_tpu_torch.utils.audio import stereo_pcm
        from real_time_sdr_tpu_torch.utils.logging import (
            F32_LATENCY_CYCLES, launch_cost, peak_flops,
            speed_of_light_report)
        from real_time_sdr_tpu_torch.utils.state import map_state
    except ImportError as e:
        fail(f"the port is not importable here ({e}); run from the root "
             "of a checkout")
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)

    # -- 1. card ------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card)
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    sm_mhz = float(clk.stdout.strip().splitlines()[0])
    print(f"max SM clock {sm_mhz:.0f} MHz")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    # both left at torch's defaults: f32 products in full f32, and the
    # bf16 fold products accumulate in f32 (out_dtype=float32)
    print(f"torch.backends.cuda.matmul: allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          "allow_bf16_reduced_precision_reduction "
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on for float32 matmuls")
    dev = torch.device("cuda")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{lib_path.relative_to(_build.CSRC.parent.parent)}")
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")

    if args.sass:
        os.makedirs(args.sass, exist_ok=True)
        cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
        res = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            fail(f"cuobjdump failed: {res.stderr.strip()}")
        for key in ("pll_scan", "frontend_fused", "mm_timing",
                    "costas_scan"):
            parts = [f for f in res.stdout.split("\t\tFunction : ")[1:]
                     if key in f.split("\n", 1)[0]]
            out = os.path.join(args.sass, f"{key}.sass")
            with open(out, "w") as f:
                f.write(f"{card}\n" + "\n\t\tFunction : ".join([""] + parts))
            print(f"sass of {len(parts)} {key} kernel(s) -> {out}")

    if args.loops:
        alt_rx = AltRdsReceiver(0, device=dev)
        alt_bb = alt_rx.baseband(alt_station(torch, alt_rx)[1])
        loop_checks(torch, np, card, sm_mhz, alt_bb,
                    comb_acquire(alt_bb, ALT_SPS), alt_rx.mm_gain)
        print("--loops: stopping after the two loops' checks")
        return

    launches = {k.name: 0 for k in KERNELS}
    graph_stats = {}         # the graphed paths' numbers, one JSON line
    by_path, bodies_by_path, fd_bodies_by_path = {}, {}, {}

    def reset_counts():
        for k in KERNELS:
            k.launches = 0
        for k in (fir_bank, fir_decimate):
            k.body_launches = dict.fromkeys(k.body_launches, 0)

    def count_path(path, needed, bodies):
        """Read the counts of the path just driven. ``needed`` kernels must
        have launched, through these FIR-bank ``bodies``. ``fir_decimate``
        must have launched through its static body when it is needed and
        not at all when it is not (modes 2-3 upsample their audio)."""
        got = {k.name: k.launches for k in KERNELS}
        by_path[path] = got
        bodies_by_path[path] = dict(fir_bank.body_launches)
        fd_bodies_by_path[path] = dict(fir_decimate.body_launches)
        for name, n in got.items():
            launches[name] += n
        print(f"{path} launches {got}, fir_bank bodies "
              f"{bodies_by_path[path]}, fir_decimate bodies "
              f"{fd_bodies_by_path[path]}")
        for name in needed:
            if got[name] <= 0:
                fail(f"kernel {name} was not launched on the {path} path")
        for body in bodies:
            if bodies_by_path[path][body] <= 0:
                fail(f"fir_bank's {body} body was not launched on the "
                     f"{path} path")
        if fir_decimate.name in needed:
            if fd_bodies_by_path[path]["static"] <= 0:
                fail(f"fir_decimate's static body was not launched on the "
                     f"{path} path")
        elif got[fir_decimate.name] != 0:
            fail(f"fir_decimate was launched on the {path} path, whose "
                 "audio resampler upsamples")

    def count_child(path, got, needed):
        """The counts a child process printed on its ``kernel launches``
        line, read as ``count_path`` reads a path of this process."""
        if got is None:
            fail(f"the {path} child printed no kernel launches line")
        by_path[path] = {k.name: got.get(k.name, 0) for k in KERNELS}
        for name, n in by_path[path].items():
            launches[name] += n
        print(f"{path} launches {by_path[path]} (the child's count)")
        for name in needed:
            if by_path[path][name] <= 0:
                fail(f"kernel {name} was not launched on the {path} path")

    def ladder_site_checks(rung):
        """Every FIR kernel call of one eager segment of ``rung``, its
        arguments recorded (the path's own card tensors), each kernel
        against its plain version on them (> 110 dB), with the body and
        the general body's tile the shape picks, ms beside the plain
        version's and the bound of the site's ``cost()``."""
        from real_time_sdr_tpu_torch.ops.cuda.fir_bank import (
            FirBankKernel, general_plan)
        from real_time_sdr_tpu_torch.ops.cuda.fir_kernels import \
            FirDecimateKernel
        from real_time_sdr_tpu_torch.ops.fir import FIRBank
        owner = {}
        for mname, m in rung.rx.named_modules():
            if isinstance(m, FIRBank):
                owner[id(m.ptaps)] = (mname, m)
            elif isinstance(m, DecimatingFIR):
                owner[id(m.taps)] = (mname, m)
        calls = []
        orig = FirBankKernel.__call__, FirDecimateKernel.__call__

        def rec_bank(self, xx, ptaps, w, geom):
            calls.append((fir_bank.name, xx, ptaps, w, geom))
            return orig[0](self, xx, ptaps, w, geom)

        def rec_decimate(self, xx, h, down):
            calls.append((fir_decimate.name, xx, h, down))
            return orig[1](self, xx, h, down)

        FirBankKernel.__call__ = rec_bank
        FirDecimateKernel.__call__ = rec_decimate
        try:
            iw, qw = wideband64.noise_rails(rung)
            rung.bank.run_wideband(rung.bank.init_state(), rung.fe, iw, qw,
                                   rung.fe.init_state())
            torch.cuda.synchronize()
        finally:
            FirBankKernel.__call__, FirDecimateKernel.__call__ = orig
        sites = {}
        for call in calls:
            kname, xx = call[0], call[1]
            mname, mod = owner[id(call[2])]
            rows = xx.shape[0]
            if kname == fir_bank.name:
                _, _, ptaps, w, g = call
                n = xx.shape[1] - (g.T - 1)
                body = kernel_body(g)
                tile = (general_plan(g, rows, g.n_out(n), ptaps.shape[0]).form
                        if body == "general" else "-")
                kern = functools.partial(fir_bank.launch, xx, ptaps, g)
                plain = functools.partial(fir_bank_plain, xx, w, g)
            else:
                _, _, h, down = call
                n = xx.shape[1] - (h.shape[0] - 1)
                body, tile = decimate_body(h.shape[0], down), "-"
                kern = functools.partial(fir_decimate.launch, xx, h, down)
                plain = functools.partial(fir_decimate_plain, xx, h, down)
            yk, yp = kern(), plain()
            torch.cuda.synchronize()
            s_ = snr_db(yp, yk)
            err = (yk - yp).abs().max().item()
            t_k, t_p = device_ms(torch, kern), device_ms(torch, plain)
            bnd = bound(*launch_cost(mod.cost(n), rows))
            print(f"kernel {kname}[ladder {len(rung.offsets)} st, {mname}]: "
                  f"rows {rows}, n {n} -> {tuple(yk.shape)}, body {body}, "
                  f"tile {tile}: SNR {s_:.1f} dB vs plain, max abs err "
                  f"{err:.3g}; kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
                  f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, "
                  f"{100 * bnd['bound_ms'] / t_k:.0f} % of it reached)")
            if not s_ > 110.0:
                fail(f"{kname}[ladder, {mname}] disagrees with its plain "
                     f"version ({s_:.1f} dB)")
            tiles = {}
            if body == "general":       # every tile the shape admits
                for tname, tp in fir_digest.tile_plans(
                        g, rows, g.n_out(n), ptaps.shape[0]).items():
                    run_t = functools.partial(fir_digest.launch_plan, xx,
                                              ptaps, g, tp)
                    yt = run_t()
                    tiles[tname] = dict(equal=torch.equal(yt, yk),
                                        snr_db=snr_db(yp, yt),
                                        ms=device_ms(torch, run_t))
                print(f"  {mname}, each tile on the same tensors: "
                      + "; ".join(f"{k} {v['ms']:.4f} ms, {v['snr_db']:.1f} "
                                  f"dB, equal to the picked tile "
                                  f"{v['equal']}" for k, v in tiles.items()))
                if not all(v["equal"] and v["snr_db"] > 110.0
                           for v in tiles.values()):
                    fail(f"fir_bank[ladder, {mname}]: a general-body tile "
                         "disagrees")
            sites[f"{kname}:{mname}"] = dict(
                kernel=kname, rows=rows, n=n, body=body, tile=tile,
                snr_db=s_, max_abs_err=err, ms=t_k, plain_ms=t_p, **bnd,
                tiles=tiles)
        bodies = {v["body"] for v in sites.values()
                  if v["kernel"] == fir_bank.name}
        n_dec = sum(v["kernel"] == fir_decimate.name for v in sites.values())
        if bodies != {"tiled", "general"} or not n_dec:
            fail(f"the ladder's segment ran fir_bank bodies {bodies} and "
                 f"{n_dec} fir_decimate calls")
        return sites

    def phase_11(kernels):
        """The experiments (``real_time_sdr_tpu_torch/experiments/``) at
        full width on the card; with ``kernels`` (phase 3's dict) the
        ladder's kernel sites are added to it."""
        t11 = time.perf_counter()
        fb, fd = fir_bank.name, fir_decimate.name
        ff, pl = frontend_fused.name, pll_scan_kernel.name
        both = ("tiled", "general")
        summary = {}

        def gated(what, call):
            try:
                return call()
            except GateError as e:
                fail(f"{what}: {e}")

        def free():
            gc.collect()
            torch.cuda.empty_cache()
            return torch.cuda.memory_allocated(dev) / 1e9

        # the decode checks' scenes, synthesized on the host in worker
        # processes while the card runs the ladder
        ladder = {}
        with ProcessPoolExecutor(
                max_workers=len(DECODE_RUNGS),
                mp_context=multiprocessing.get_context("spawn")) as pool:
            scenes = {n: pool.submit(wideband64.scene_rails_for, n)
                      for n in DECODE_RUNGS}
            for n, wb in LADDER_CELLS:
                tag = f"{n}_{wb}"
                reset_counts()
                rung = wideband64.build(n, "fused", wb_fir=wb, seg=LADDER_SEG,
                                        device=dev)
                res = wideband64.measure(rung)
                count_path(f"ladder_{tag}", (fb, fd), both)
                print(f"ladder {tag}: {n} stations from one "
                      f"{res['wide_fs'] / 1e6:g} MS/s capture ({res['mult']}x"
                      f", taps_factor {res['taps_factor']}, K_eq "
                      f"{res['k_eq']}, {wb}), {res['seg']}-block segments, "
                      f"{res['reps']} reps: {res['ms_per_block']:.4f} ms/block"
                      f", {res['wideband_msps']:.1f} MS/s wideband = "
                      f"{res['x_realtime']:.2f}x real time on the capture, "
                      f"{res['station_msps']:g} MS/s of station IQ; weights "
                      f"built in {res['build_s']:.2f} s, first call (graph "
                      f"capture included) {res['first_s']:.2f} s, peak "
                      f"memory {res['peak_gb']:.2f} GB; on {card}")
                if n in scenes:
                    t_ = time.perf_counter()
                    rails = scenes[n].result()
                    wait_s = time.perf_counter() - t_
                    reset_counts()
                    t_ = time.perf_counter()
                    res["decode"] = gated(
                        f"ladder {tag} decode check",
                        lambda: wideband64.decode_check(rung, rails))
                    dec_s = time.perf_counter() - t_
                    count_path(f"ladder_{tag}_decode", (fb, fd), both)
                    got = "; ".join(
                        f"station {r['slot']} @ {r['offset_hz'] / 1e6:+.2f} "
                        f"MHz PS {r['ps']!r} PI {r['pi']:#06x} groups "
                        f"{r['groups']}" for r in res["decode"])
                    print(f"ladder {tag} decode check, 26 blocks: {got}: "
                          f"{len(res['decode'])}/{len(res['decode'])} PS and "
                          f"PI as sent ({dec_s:.1f} s; waited {wait_s:.1f} s "
                          "for the scene's synthesis)")
                    del rails
                if (n, wb) == (256, "f32"):
                    res["sites"] = ladder_site_checks(rung)
                del rung
                res["memory_after_free_gb"] = free()
                print(f"ladder {tag}: freed, {res['memory_after_free_gb']:.3f}"
                      " GB still allocated")
                ladder[tag] = res
        summary["ladder"] = ladder
        if kernels is not None:
            sites = ladder["256_f32"]["sites"]
            for name in (fb, fd):
                kernels[name]["ladder_256_sites"] = {
                    k: v for k, v in sites.items() if v["kernel"] == name}

        reset_counts()
        rt = gated("retune_latency",
                   lambda: retune_latency.run(64, 8, 32, dev))
        count_path("retune_latency", (fb, fd), both)
        for line in retune_latency.lines(rt):
            print("retune_latency: " + line[2:])
        summary["retune_latency"] = rt
        free()

        e2e = {}
        e2e["paced"] = gated("e2e_latency run 1",
                             lambda: e2e_latency.paced_run(device=dev))
        count_child("e2e_paced", e2e["paced"]["launches"], (ff, fb, fd, pl))
        # the same feed at the CLI's own defaults (one block a group, one
        # group in flight): beside phase 6's unpaced run of those flags
        e2e["paced_defaults"] = gated(
            "e2e_latency run 1 at the CLI's defaults",
            lambda: e2e_latency.paced_run(pipeline=1, segment=1,
                                          device=dev))
        count_child("e2e_paced_defaults", e2e["paced_defaults"]["launches"],
                    (ff, fb, fd, pl))
        e2e["overload"] = gated("e2e_latency run 2",
                                lambda: e2e_latency.overload_run(device=dev))
        count_child("e2e_overload", e2e["overload"]["launches"],
                    (ff, fb, fd, pl))
        e2e["wideband"] = gated(
            "e2e_latency --wideband 8",
            lambda: e2e_latency.wideband_run(8, device=dev))
        count_child("e2e_wideband", e2e["wideband"]["launches"],
                    (fb, fd, pl))
        for run_name, r in e2e.items():
            for line in r.pop("stderr").splitlines():
                if line.startswith(("warmed", "total:", "block latency",
                                    "dropped", "wideband frontend",
                                    "warning:")) or " ps: " in line:
                    print(f"e2e {run_name}: {line}")
        lat, lat1 = (e2e[k]["latency"] for k in ("paced", "paced_defaults"))
        print(f"e2e paced (--segment 6 --pipeline 2): p50 {lat['p50_ms']:.1f}"
              f" ms, p99 {lat['p99_ms']:.1f} ms; at the CLI's defaults: p50 "
              f"{lat1['p50_ms']:.1f} ms, p99 {lat1['p99_ms']:.1f} ms; beside "
              f"the {lat['deadline_ms']:.2f} ms block deadline; overload: "
              f"{e2e['overload']['dropped']} input blocks dropped through "
              f"the native reader "
              f"({e2e['overload']['native']}); live wideband, 8 stations: "
              f"{e2e['wideband']['total']['x_realtime']:.1f}x real time, PS "
              f"{e2e['wideband']['ps']}")
        summary["e2e_latency"] = e2e

        reset_counts()
        summary["stage_decompose"] = stage_decompose.run(
            device=dev, log=lambda ln: print("stage_decompose: " + ln))
        count_path("stage_decompose", (ff, fb, fd), both)
        print("stage_decompose: " + json.dumps(summary["stage_decompose"]))
        reset_counts()
        summary["mode_floors"] = mode_floors.run(
            device=dev, log=lambda ln: print("mode_floors: " + ln))
        count_path("mode_floors", (ff, fb, fd), both)
        print("mode_floors: " + json.dumps(summary["mode_floors"]))
        reset_counts()
        with tempfile.TemporaryDirectory() as tdir:
            tt = trace_top.run(mode=0, trace_dir=tdir, device=dev)
        count_path("trace_top", (ff, fb, fd), both)
        if tt["clock"] != "device" or not tt["busy_ms"] > 0:
            fail("trace_top recorded no device time")
        print("trace_top: " + json.dumps(tt))
        summary["trace_top"] = tt
        reset_counts()
        with tempfile.TemporaryDirectory() as tdir:
            tw = trace_wideband.run(trace_dir=tdir, device=dev)
        count_path("trace_wideband", (fb, fd), both)
        if tw["clock"] != "device" or not tw["busy_ms"] > 0:
            fail("trace_wideband recorded no device time")
        print("trace_wideband: " + json.dumps(tw))
        summary["trace_wideband"] = tw
        free()
        summary["wall_s"] = time.perf_counter() - t11
        print(f"phase 11 (experiments) {summary['wall_s']:.1f} s; on {card}")
        print("experiments: " + json.dumps(summary))

    if args.experiments:
        phase_11(None)
        print("--experiments: stopping after phase 11")
        return

    # -- fixture: one station, 36 blocks, tiled to 32 shifted channels -------
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3, device=dev)
    cfg = rx.cfg
    iq, truth = synth.station_iq(cfg, BLOCKS * SEGMENTS, ps_name=PS, pi=PI,
                                 pty=PTY)
    segs = tile_channels(np, iq, cfg)
    print(f"fixture: {CH} ch x {BLOCKS} blk x {SEGMENTS} segments, "
          f"{segs[0].nbytes / 1e6:.1f} MB IQ per segment")

    # -- 3. kernels vs plain ------------------------------------------------
    rng = np.random.default_rng(1)
    kernels = {}
    pi0, pq0 = (torch.from_numpy(rng.uniform(-0.5, 0.5, CH).astype(
        np.float32)).to(dev) for _ in range(2))

    def frontend_bound(fe_, xx_):
        """The bound of one frontend launch on the tail-prefixed rows xx_,
        from ``Frontend.cost``: the u8 rows in, the f32 demod out, K FMAs
        for I and for Q per output, the taps once."""
        return bound(*launch_cost(fe_.cost(xx_.shape[1] - fe_.tail_len),
                                  xx_.shape[0]))

    def check_frontend(label, seg_u8):
        """The mode-0 frontend kernel on (CH, n) u8 rows behind a zero
        tail against its plain version: demod > 90 dB, carried samples
        within 1e-4."""
        fe = rx.frontend
        xx = torch.cat([fe.init_state(CH).iq_tail,
                        torch.from_numpy(seg_u8).to(dev)], dim=-1)
        dk, ik, qk = frontend_fused.launch(xx, fe.rf_fir.taps,
                                           fe.rf_fir.down, pi0, pq0)
        dp, ip, qp = frontend_plain(xx, fe.rf_fir, pi0, pq0)
        torch.cuda.synchronize()
        fe_snr = snr_db(dp, dk)
        fe_err = (dk - dp).abs().max().item()
        prev_err = max((ik - ip).abs().max().item(),
                       (qk - qp).abs().max().item())
        fe_ms = device_ms(torch, lambda: frontend_fused.launch(
            xx, fe.rf_fir.taps, fe.rf_fir.down, pi0, pq0))
        fe_plain_ms = device_ms(torch, lambda: frontend_plain(
            xx, fe.rf_fir, pi0, pq0))
        fe_bound = frontend_bound(fe, xx)
        print(f"kernel frontend_fused[{label}]: ({CH}, {xx.shape[1]}) u8 "
              f"-> {tuple(dk.shape)}: SNR {fe_snr:.1f} dB vs plain, max abs "
              f"err {fe_err:.3g}, prev err {prev_err:.3g}; kernel "
              f"{fe_ms:.4f} ms, plain {fe_plain_ms:.4f} ms, bound "
              f"{fe_bound['bound_ms']:.4f} ms ({fe_bound['bound_by']}), no "
              "library call")
        if not (fe_snr > 90.0 and prev_err < 1e-4):
            fail(f"frontend kernel [{label}] disagrees with its plain "
                 f"version ({fe_snr:.1f} dB, prev err {prev_err:.3g})")
        return dict(max_abs_err=fe_err, ms=fe_ms, plain_ms=fe_plain_ms,
                    **fe_bound, library_ms=None)

    kernels[frontend_fused.name] = check_frontend(
        f"{CH} ch x {BLOCKS} blk", segs[0])

    n_if = cfg.if_block * BLOCKS
    sites = [  # (name, bank, rows, n) at the main path's shapes
        ("if_triple", rx.if_bank, CH, n_if),
        ("stereo_sync", rx.audio.sync.bank, CH, n_if),
        ("rds_pilot", rx.rds_path.pilot_bank, CH, n_if),
        ("rds_sync", rx.rds_path.sync.bank, CH, n_if),
        ("rds_baseband_247_640", rx.rds_path.baseband_bank, CH * BLOCKS,
         cfg.if_block),
        ("rrc", rx.rds_path.rrc_bank, CH * BLOCKS, cfg.rds_block),
    ]
    def check_site(name, bank, rows, n):
        """One FIR-bank site against its plain version: (ms, plain ms,
        max abs err, body)."""
        xb = torch.from_numpy(rng.standard_normal(
            (rows, bank.tail_len + n)).astype(np.float32)).to(dev)
        g = bank.geometry
        yk = fir_bank.launch(xb, bank.ptaps, g)
        yp = fir_bank_plain(xb, bank.w, g)
        torch.cuda.synchronize()
        s = snr_db(yp, yk)
        err = (yk - yp).abs().max().item()
        t_k = device_ms(torch, lambda: fir_bank.launch(xb, bank.ptaps, g))
        t_p = device_ms(torch, lambda: fir_bank_plain(xb, bank.w, g))
        body = kernel_body(g)
        nbytes, flops = launch_cost(bank.cost(n), rows)   # FIRBank.cost
        gflop = flops / 1e9                               # useful
        bnd = bound(nbytes, flops)
        # one library call computes a FIR without upsampling: conv1d with
        # the filters as output channels (flipped taps, stride = down)
        t_l = None
        if g.up == 1:
            w_l = bank.taps.flip(-1)[:, None, :].contiguous()
            xl = xb[:, None, :]
            yl = torch.nn.functional.conv1d(xl, w_l, stride=g.down)
            lib_snr = snr_db(yp, yl[..., :yk.shape[-1]])
            if not lib_snr > 100.0:
                fail(f"fir_bank[{name}]: the conv1d yardstick computes "
                     f"another function ({lib_snr:.1f} dB)")
            t_l = device_ms(torch, lambda: torch.nn.functional.conv1d(
                xl, w_l, stride=g.down))
        print(f"kernel fir_bank[{name}]: rows {rows}, n {n}, nf {bank.nf}, "
              f"K {g.num_taps}, {g.up}/{g.down} -> {tuple(yk.shape)}: "
              f"SNR {s:.1f} dB, max abs err {err:.3g}; body {body}, "
              f"{gflop:.4f} GFLOP useful; kernel {t_k:.4f} ms "
              f"({gflop / t_k:.2f} TFLOP/s), plain {t_p:.4f} ms "
              f"({gflop / t_p:.2f} TFLOP/s), bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}), conv1d "
              + (f"{t_l:.4f} ms" if t_l is not None else "n/a (up > 1)"))
        if not s > 110.0:
            fail(f"fir_bank[{name}] disagrees with its plain version "
                 f"({s:.1f} dB)")
        return t_k, t_p, err, body, dict(**bnd, library_ms=t_l)

    bank_err, bank_ms, bank_plain_ms, bank_sites = 0.0, 0.0, 0.0, {}
    for name, bank, rows, n in sites:
        t_k, t_p, err, body, extra = check_site(name, bank, rows, n)
        bank_err = max(bank_err, err)
        bank_ms += t_k
        bank_plain_ms += t_p
        bank_sites[name] = dict(ms=t_k, plain_ms=t_p, body=body, **extra)
    # the row's bound is the sum of its sites' bounds; the row has no one
    # library call (the 247/640 site upsamples), the up = 1 sites have
    up1 = [v for v in bank_sites.values() if v["library_ms"] is not None]
    kernels[fir_bank.name] = dict(
        max_abs_err=bank_err, ms=bank_ms, plain_ms=bank_plain_ms,
        bound_ms=sum(v["bound_ms"] for v in bank_sites.values()),
        bound_by=("operations" if sum(
            v["bound_ms"] for v in bank_sites.values()
            if v["bound_by"] == "operations") * 2 > sum(
                v["bound_ms"] for v in bank_sites.values()) else "bytes"),
        library_ms=None, ms_up1_sites=sum(v["ms"] for v in up1),
        library_ms_up1_sites=sum(v["library_ms"] for v in up1),
        sites=bank_sites)
    tiled = [v for v in bank_sites.values() if v["body"] == "tiled"]
    print(f"fir_bank over the {len(sites)} sites of one segment: kernel "
          f"{bank_ms:.4f} ms, plain {bank_plain_ms:.4f} ms; the "
          f"{len(tiled)} tiled sites: kernel "
          f"{sum(v['ms'] for v in tiled):.4f} ms, plain "
          f"{sum(v['plain_ms'] for v in tiled):.4f} ms; bound "
          f"{kernels['fir_bank']['bound_ms']:.4f} ms; the {len(up1)} sites "
          f"without upsampling: kernel "
          f"{kernels['fir_bank']['ms_up1_sites']:.4f} ms, conv1d "
          f"{kernels['fir_bank']['library_ms_up1_sites']:.4f} ms")

    # the general body alone: every site of the serving path that takes it
    # at its path's shape and the FIR property test's random geometries at
    # 1, 2 and 33 rows (utils/fir_digest.py), each > 110 dB against its
    # plain version and bit-identical to the recorded digest of the body
    # it replaced; beside each, that body's time recorded on the card
    gen = fir_digest.run_cases(dev)
    rec = fir_digest.recorded()
    bad = sorted(k for k, v in gen.items() if v["equal"] is not True)
    low = sorted(k for k, v in gen.items() if not v["snr_db"] > 110.0)
    if bad or low:
        fail(f"fir_bank's general body: digest not equal at {bad}; under "
             f"110 dB at {low}")
    for v in gen.values():
        kernels[fir_bank.name]["max_abs_err"] = max(
            kernels[fir_bank.name]["max_abs_err"], v["max_abs_err"])
    # the shape picks the general body's tile: path sites on each side
    sites_gen = [k for k in gen if not k.startswith("sweep")]
    forms = {gen[k]["form"] for k in sites_gen}
    if forms != {"lines", "direct"}:
        fail(f"fir_bank's general body: the path's sites ran the tiles "
             f"{sorted(forms)}, not both lines and direct")
    print("fir_bank general body against the recorded body (ms, this run "
          "/ recorded on the card before the redesign): " + "; ".join(
              f"{k} [{gen[k]['form']}] {gen[k]['ms']:.4f} / "
              f"{rec[k]['ms']:.4f} ({rec[k]['ms'] / gen[k]['ms']:.2f}x)"
              for k in sites_gen))
    slower = sorted(k for k, v in gen.items() if v["ms"] > rec[k]["ms"])
    print(f"fir_bank general body: {len(gen)} cases, every digest equal "
          f"to the recorded body's; slower than it at {slower or 'none'}")
    kernels[fir_bank.name]["general_sites"] = {
        k: {f: v[f] for f in ("rows", "n", "nf", "up", "down", "K", "form",
                              "plan", "ms", "plain_ms", "bound_ms",
                              "bound_by", "gflop", "snr_db", "equal")}
        for k, v in gen.items()}

    # channelizer epilogue at the 12-block, 19.2 MS/s shape (R = 16, c =
    # n_out / R frames): all 64 stations, as the unsharded two-stage path
    # gives them, and the 32 of one shard of the station-sharded path
    r_n = 16
    n_out_wb = BLOCKS * cfg.block_size_iq                 # station rate
    gen = torch.Generator(device=dev).manual_seed(3)

    def check_epilogue(label, s_ch):
        y = 0.5 * torch.randn((n_out_wb // r_n, r_n * 2 * s_ch), device=dev,
                              generator=gen)
        ang = 7.0 * torch.rand(s_ch, device=dev, generator=gen)
        pc, ps = torch.cos(ang), torch.sin(ang)
        uk = chan_epilogue.launch(y, pc, ps, r_n, s_ch, n_out_wb)
        up = chan_epilogue_plain(y, pc, ps, r_n, s_ch, n_out_wb)
        torch.cuda.synchronize()
        err = (uk.int() - up.int()).abs().max().item()
        t_k = device_ms(torch, lambda: chan_epilogue.launch(
            y, pc, ps, r_n, s_ch, n_out_wb))
        t_p = device_ms(torch, lambda: chan_epilogue_plain(
            y, pc, ps, r_n, s_ch, n_out_wb))
        cost = epilogue_cost(tuple(y.shape), s_ch, n_out_wb)
        moved = cost["bytes"]
        bnd = bound(moved, cost["flops"])
        print(f"kernel chan_epilogue[{label}]: y {tuple(y.shape)} f32, R "
              f"{r_n}, S {s_ch} -> {tuple(uk.shape)} u8: byte-equal "
              f"{torch.equal(uk, up)}, max abs err {err} LSB; kernel "
              f"{t_k:.4f} ms ({moved / t_k / 1e9:.2f} TB/s of "
              f"{moved / 1e6:.1f} MB), plain {t_p:.4f} ms, bound "
              f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), no library "
              f"call")
        if not torch.equal(uk, up):
            fail(f"chan_epilogue[{label}] kernel is not byte-equal to its "
                 f"plain version")
        return dict(shape=list(y.shape), stations=s_ch,
                    max_abs_err=float(err), ms=t_k, plain_ms=t_p, **bnd,
                    library_ms=None)

    epi = check_epilogue(f"{WB_STATIONS} stations", WB_STATIONS)
    epi_shard = check_epilogue(
        f"{WB_STATIONS // 2} stations, one shard of two", WB_STATIONS // 2)
    kernels[chan_epilogue.name] = dict(
        max_abs_err=max(epi["max_abs_err"], epi_shard["max_abs_err"]),
        **{k: epi[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms")},
        sharded_step=epi_shard)

    # direct-form decimating FIR (the audio resampler of modes 0-1): mode
    # 0's rails (64 rails x 12 blocks of IF, K 101, down 5), mode 1's (down
    # 9), a geometry of the general body, and 1 and 1,000 rows; beside each
    # conv1d and the FIR bank at the same geometry
    def check_decimate(label, h, rows, n, down):
        k_taps = h.shape[0]
        xd = torch.randn((rows, k_taps - 1 + n), device=dev, generator=gen)
        yk = fir_decimate.launch(xd, h, down)
        yp = fir_decimate_plain(xd, h, down)
        torch.cuda.synchronize()
        s_ = snr_db(yp, yk)
        err = (yk - yp).abs().max().item()
        t_k = device_ms(torch, lambda: fir_decimate.launch(xd, h, down))
        t_p = device_ms(torch, lambda: fir_decimate_plain(xd, h, down))
        dbank = make_bank([PolyFIR(h.double().cpu().numpy(),
                                   down=down)]).to(dev)
        t_b = device_ms(torch, lambda: fir_bank.launch(xd, dbank.ptaps,
                                                       dbank.geometry))
        same = torch.equal(
            fir_bank.launch(xd, dbank.ptaps, dbank.geometry)[:, 0], yk)
        site = DecimatingFIR(PolyFIR(h.double().cpu().numpy(), down=down))
        bnd = bound(*launch_cost(site.cost(n), rows))    # its cost()
        w_l = h.flip(0)[None, None, :].contiguous()
        t_l = device_ms(torch, lambda: torch.nn.functional.conv1d(
            xd[:, None, :], w_l, stride=down))
        body = decimate_body(k_taps, down)
        print(f"kernel fir_decimate[{label}]: ({rows}, {xd.shape[1]}) K "
              f"{k_taps} down {down} -> {tuple(yk.shape)}: SNR {s_:.1f} dB "
              f"vs plain, max abs err {err:.3g}; body {body}, "
              f"bit_identical_to_fir_bank {same}; kernel {t_k:.4f} ms, plain "
              f"(conv1d) {t_p:.4f} ms, fir_bank at the same geometry "
              f"{t_b:.4f} ms; bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}, {100 * bnd['bound_ms'] / t_k:.0f} % of "
              f"it reached), one conv1d call {t_l:.4f} ms")
        if not s_ > 110.0:
            fail(f"fir_decimate[{label}] disagrees with its plain version "
                 f"({s_:.1f} dB)")
        return dict(shape=[rows, xd.shape[1]], k_taps=k_taps, down=down,
                    body=body, snr_db=s_, max_abs_err=err, ms=t_k,
                    plain_ms=t_p, fir_bank_ms=t_b, **bnd, library_ms=t_l,
                    bit_identical_to_fir_bank=same)

    h0 = rx.audio.resamp_bank.taps
    rx_m1 = Receiver(1, device=dev)
    h1, n_if1 = rx_m1.audio.audio_bank.taps, rx_m1.cfg.if_block * BLOCKS
    fd_cases = {
        "mode0_rails": check_decimate("mode 0 audio rails", h0, 2 * CH,
                                      n_if, cfg.audio_down),
        "mode1_rails": check_decimate("mode 1 audio rails", h1, 2 * CH,
                                      n_if1, rx_m1.cfg.audio_down),
        "general_down4": check_decimate("general body", h0, 2 * CH, n_if, 4),
        "one_row": check_decimate("1 row", h0, 1, n_if, cfg.audio_down),
        "rows_1000": check_decimate("1,000 rows x 1 block", h0, 1000,
                                    cfg.if_block, cfg.audio_down),
    }
    for name in ("mode0_rails", "mode1_rails", "one_row", "rows_1000"):
        if fd_cases[name]["body"] != "static":
            fail(f"fir_decimate[{name}] did not take the static body")
    if fd_cases["general_down4"]["body"] != "general":
        fail("fir_decimate at down 4 did not take the general body")
    main_case = fd_cases["mode0_rails"]
    kernels[fir_decimate.name] = dict(
        max_abs_err=max(v["max_abs_err"] for v in fd_cases.values()),
        **{k: main_case[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
        cases=fd_cases)
    del rx_m1

    def check_pll(label, xk, c0, p, rows, plain_reps):
        """pll_scan on (xk, c0) against its plain version run on the first
        ``rows`` rows of the same card tensors: SNR > 80 dB, trig exact
        and the float carry within 1e-4 (phase modulo 4*pi). Kernel ms:
        median of 10 launches; plain ms: median of ``plain_reps`` calls, or
        the one comparison call when 0. Bound: x read and the carrier
        written once; about 20 f32 operations per sample (``PllLoop.cost``).
        Chain floor: N dependent steps of PLL_CHAIN_OPS operations at the
        max SM clock."""
        yk, ck = pll_scan_kernel.launch(xk, c0, p)
        cp0 = PllCarry(*(t[:rows] for t in c0))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        yp, cp = pll_scan_plain(xk[:rows], cp0, p)
        b.record()
        b.synchronize()
        yk, ck = yk[:rows], PllCarry(*(t[:rows] for t in ck))
        s_ = snr_db(yp, yk)
        err = (yk - yp).abs().max().item()
        cerr = 0.0
        for leaf, u, v in zip(ck._fields, ck, cp):
            d = (u.double() - v.double()).abs()
            if leaf == "phase":         # a multiple of 4*pi is no error
                d = torch.minimum(d, (d - 4.0 * math.pi).abs())
            cerr = max(cerr, d.max().item())
        same = (torch.equal(yk, yp)
                and all(torch.equal(u, v) for u, v in zip(ck, cp)))
        t_k = device_ms(torch, lambda: pll_scan_kernel.launch(xk, c0, p))
        t_p = (device_ms(torch, lambda: pll_scan_plain(xk[:rows], cp0, p),
                         reps=plain_reps) if plain_reps else a.elapsed_time(b))
        bnd = bound(*launch_cost(PllLoop(p, 1).cost(xk.shape[1]),
                                 xk.shape[0]))
        floor_ms = (xk.shape[1] * PLL_CHAIN_OPS * F32_LATENCY_CYCLES
                    / (sm_mhz * 1e3))
        print(f"kernel pll_scan[{label}]: {tuple(xk.shape)}, plain on "
              f"{rows} row(s): SNR {s_:.1f} dB vs plain, max abs err "
              f"{err:.3g}, carry max err {cerr:.3g}, bit-identical {same}; "
              f"kernel {t_k:.4f} ms "
              f"({t_k * sm_mhz * 1e3 / xk.shape[1]:.1f} cycles per sample "
              f"at {sm_mhz:.0f} MHz), plain {t_p:.2f} ms "
              f"({max(plain_reps, 1)} call(s), {rows} row(s)); bound "
              f"{bnd['bound_ms']:.5f} ms ({bnd['bound_by']}), chain floor "
              f"{floor_ms:.4f} ms, no library call")
        if not (s_ > 80.0 and torch.equal(ck.trig, cp.trig)
                and cerr < 1e-4):
            fail(f"pll_scan[{label}] disagrees with its plain version "
                 f"({s_:.1f} dB, carry err {cerr:.3g})")
        return dict(shape=list(xk.shape), plain_rows=rows, ms=t_k,
                    plain_ms=t_p, snr_db=s_, max_abs_err=max(err, cerr),
                    bit_identical=same, **bnd, chain_floor_ms=floor_ms,
                    library_ms=None)

    # sequential PLL (the tier-1 carrier loop) at 32 channels x 1 mode-0
    # block, with the stereo (19 kHz, x2) and RDS (114 kHz, x0.5) loops, on
    # pilots with a frequency offset and noise; the plain version runs the
    # same card tensors. Cold: from pll_init; locked: from the carry after
    # 12 kernel blocks.
    n_blk = cfg.if_block
    t_pil = np.arange(13 * n_blk) / cfg.if_fs
    pilots, pll_cases = {}, {}
    for loop, p, off in (("stereo", rx.audio.pll_params, 30.0),
                         ("rds", rx.rds_path.pll_params, -6.0)):
        ph = rng.uniform(0.0, 2.0 * np.pi, (CH, 1))
        pil = torch.from_numpy((np.cos(2 * np.pi * (p.freq + off) * t_pil
                                       + ph)
                                + 0.05 * rng.standard_normal(
                                    (CH, t_pil.size))).astype(
                                        np.float32)).to(dev)
        blocks = [pil[:, k * n_blk:(k + 1) * n_blk] for k in range(13)]
        pilots[loop] = (p, blocks)
        carry = pll_init(CH, dev)
        for k in range(12):
            _, carry = pll_scan_kernel.launch(blocks[k], carry, p)
        pll_cases[f"{loop}_cold"] = check_pll(
            f"{loop}, cold", blocks[0], pll_init(CH, dev), p, CH, 0)
        pll_cases[f"{loop}_locked"] = check_pll(
            f"{loop}, locked", blocks[12], carry, p, CH, 3)
    locked = [v for k, v in pll_cases.items() if "locked" in k]
    kernels[pll_scan_kernel.name] = dict(
        ms=sum(v["ms"] for v in locked),
        plain_ms=sum(v["plain_ms"] for v in locked),
        bound_ms=sum(v["bound_ms"] for v in locked), bound_by="bytes",
        chain_floor_ms=sum(v["chain_floor_ms"] for v in locked),
        library_ms=None, cases=pll_cases)
    print(f"pll_scan, both loops of one mode-0 block at {CH} ch (locked): "
          f"kernel {kernels['pll_scan']['ms']:.4f} ms, plain "
          f"{kernels['pll_scan']['plain_ms']:.2f} ms, bound "
          f"{kernels['pll_scan']['bound_ms']:.5f} ms, chain floor "
          f"{kernels['pll_scan']['chain_floor_ms']:.4f} ms")
    # flat in the row count: the locked stereo block at 1, 32 and 1,000 rows
    p_, blocks_ = pilots["stereo"]
    flat = {}
    for rows_ in (1, CH, 1000):
        xr = blocks_[12].repeat(-(-rows_ // CH), 1)[:rows_].contiguous()
        cr = pll_init(rows_, dev)
        flat[rows_] = device_ms(
            torch, lambda: pll_scan_kernel.launch(xr, cr, p_))
    kernels[pll_scan_kernel.name]["ms_by_rows"] = flat
    print(f"pll_scan[stereo] ms by rows at N {n_blk}: "
          + ", ".join(f"{r}: {t:.4f}" for r, t in flat.items()))
    # tier 2 (Newton, plain torch on the card) against the kernel over 2
    # blocks from the carry locked over 11 kernel blocks. (From a cold carry
    # Newton's linearization fails for initial phase errors near pi -- the
    # JAX package's pll_newton as well -- so its bound holds in lock.)
    for loop, (p, blocks) in pilots.items():
        ck_ = pll_init(CH, dev)
        for k in range(11):
            _, ck_ = pll_scan_kernel.launch(blocks[k], ck_, p)
        cn_, snrs2 = ck_, []
        for k in (11, 12):
            yk, ck_ = pll_scan_kernel.launch(blocks[k], ck_, p)
            yn, cn_ = pll_newton(blocks[k], cn_, p)
            snrs2.append(min(snr_db(yk[c], yn[c]) for c in range(CH)))
        t_n = device_ms(torch, lambda: pll_newton(blocks[12], cn_, p),
                        reps=3)
        print(f"tier 2 pll_newton[{loop}]: ({CH}, {n_blk}), 2 blocks from a "
              f"locked carry: worst channel {min(snrs2):.1f} dB vs the "
              f"kernel; {t_n:.2f} ms per block")
        if not min(snrs2) > 40.0:
            fail(f"tier 2 [{loop}] disagrees with tier 1 "
                 f"({min(snrs2):.1f} dB)")
    del pilots
    # the shapes a time-sharded step gives the kernels: 32 rows (shards) x
    # 1 block per launch (pll_scan's (32, 7,350) is the block checked above)
    one_blk = np.ascontiguousarray(segs[0][:, :2 * cfg.block_size_iq])
    ts_fe = check_frontend(f"{CH} rows x 1 blk, a time-sharded step",
                           one_blk)
    kernels[frontend_fused.name]["max_abs_err"] = max(
        kernels[frontend_fused.name]["max_abs_err"], ts_fe["max_abs_err"])
    kernels[frontend_fused.name]["time_sharded_step"] = ts_fe
    ts_sites = {}
    for name, bank, rows, n in [
            (f"{nm}, 1 blk", bk, CH, cfg.if_block) for nm, bk, _, _ in
            sites[:4]] + [
            ("rds_baseband_247_640, 1 blk", rx.rds_path.baseband_bank, CH,
             cfg.if_block),
            ("rrc, 1 blk", rx.rds_path.rrc_bank, CH, cfg.rds_block)]:
        t_k, t_p, err, body, extra = check_site(name, bank, rows, n)
        ts_sites[name] = dict(ms=t_k, plain_ms=t_p, body=body, **extra)
        kernels[fir_bank.name]["max_abs_err"] = max(
            kernels[fir_bank.name]["max_abs_err"], err)
    kernels[fir_bank.name]["time_sharded_step_sites"] = ts_sites
    print(f"fir_bank over the {len(ts_sites)} sites of one time-sharded "
          f"step ({CH} rows x 1 blk): kernel "
          f"{sum(v['ms'] for v in ts_sites.values()):.4f} ms, plain "
          f"{sum(v['plain_ms'] for v in ts_sites.values()):.4f} ms, bound "
          f"{sum(v['bound_ms'] for v in ts_sites.values()):.4f} ms")
    fd_cases["time_sharded_step"] = check_decimate(
        "a time-sharded step's audio rails", h0, 2 * CH, cfg.if_block,
        cfg.audio_down)
    kernels[fir_decimate.name]["max_abs_err"] = max(
        kernels[fir_decimate.name]["max_abs_err"],
        fd_cases["time_sharded_step"]["max_abs_err"])

    # -- the alternative RDS receiver's kernels at its path's shape: the
    # 32-block +200 ppm station through the frontend, then the baseband
    # bank (2 rows, up 19, down 240, 1,919 taps), then the two loops
    alt_rx = AltRdsReceiver(0, device=dev)
    alt_iq, alt_demod = alt_station(torch, alt_rx)
    t_k, t_p, err, body, extra = check_site(
        "alt_baseband_19_240", alt_rx.bb_bank, 2, alt_demod.shape[-1])
    kernels[fir_bank.name]["max_abs_err"] = max(
        kernels[fir_bank.name]["max_abs_err"], err)
    kernels[fir_bank.name]["alt_baseband_site"] = dict(
        ms=t_k, plain_ms=t_p, body=body, **extra)
    alt_bb = alt_rx.baseband(alt_demod)
    alt_mu0 = comb_acquire(alt_bb, ALT_SPS)

    loops = loop_checks(torch, np, card, sm_mhz, alt_bb, alt_mu0,
                        alt_rx.mm_gain)
    main_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "chain_floor_ms", "bit_identical")
    kernels[mm_timing_kernel.name] = dict(
        **{k: loops["mm_alt"][k] for k in main_keys},
        alt_path=loops["mm_alt"], long_stream=loops["mm_long"])
    kernels[costas_kernel.name] = dict(
        **{k: loops["costas_alt"][k] for k in main_keys},
        alt_path=loops["costas_alt"], long_stream=loops["costas_long"],
        rows={k: v for k, v in loops.items() if k.startswith("costas_rows")})
    # the carried phase's sine and cosine against sincosf, exhaustively
    from real_time_sdr_tpu_torch.ops.cuda.costas_scan import sincos_max_ulp
    ulp = sincos_max_ulp(dev)
    print(f"costas_scan sine and cosine against sincosf over every f32 in "
          f"[0, 2*pi] ({ulp['values']} values): largest difference "
          f"{ulp['max_ulp_sin']} ulp (sine), {ulp['max_ulp_cos']} ulp "
          f"(cosine); {ulp['values_differing']} values differ")
    kernels[costas_kernel.name]["sincos_check"] = ulp
    del alt_demod, alt_bb

    # -- the wideband fold products (library calls, not kernels of the
    # port) at the 64-station shapes of both frontends, at each precision
    # each takes: the product on random rails against its plain version on
    # the same card tensors (f32: the float64 product; bf16 and bf16x2:
    # both operands upcast to f32, exact products), the result dtype, the
    # time, useful TFLOP/s and the bound of the frontend's cost() (the
    # two-stage fold_cost counts the product alone; the fused cost() the
    # whole frontend, whose operations are all the product's). The
    # frontends are kept for phase 5.
    wide_fs = WB_MULT * cfg.rf_fs
    offs = [int((k - (WB_STATIONS - 1) / 2) * 300_000)
            for k in range(WB_STATIONS)]
    n_wb = BLOCKS * cfg.block_size_iq * WB_MULT          # samples a rail
    wb_fe = {("two_stage", dt): Channelizer(cfg, wide_fs, offs,
                                            compute_dtype=dt, device=dev)
             for dt in ("f32", "bf16")}
    for dt in WB_DTYPES:
        wb_fe["fused", dt] = make_wideband_frontend(
            cfg, wide_fs, offs, compute_dtype=dt, device=dev)
        if not isinstance(wb_fe["fused", dt], FusedWidebandFrontend):
            fail("make_wideband_frontend did not pick the fused frontend")

    def fold_operands(fe_w, rails_):
        """The fold product's operands (frames, weights) of a wideband
        frontend on ``rails_`` (2, n_wb + 4096), at one segment's shapes,
        and the cost() that counts the product."""
        if isinstance(fe_w, Channelizer):
            tl = fe_w.fold_tail
            fr_ = fe_w.fold_frames(rails_[0, :tl + n_wb],
                                   rails_[1, :tl + n_wb],
                                   -(-(n_wb // fe_w.decim) // fe_w.fold_R))
            return fr_, fe_w.fold_W, fe_w.fold_cost(n_wb)
        tl = fe_w.tail_len
        fr_ = fe_w.frames(rails_[0, :tl + n_wb], rails_[1, :tl + n_wb])
        return fr_, fe_w.w, fe_w.cost(n_wb)

    rails = 0.3 * torch.randn((2, n_wb + 4096), device=dev, generator=gen)
    fold_rows = {}
    for (path, dt), fe_w in wb_fe.items():
        fr, w_op, cost = fold_operands(fe_w, rails)
        y = fold_product(fr, w_op)
        if dt == "f32":
            plain = lambda: fr.double() @ w_op.double()        # noqa: E731
        else:
            plain = lambda: fold_product_plain(fr, w_op)       # noqa: E731
        yp = plain()
        torch.cuda.synchronize()
        if y.dtype != torch.float32:
            fail(f"the {dt} fold product [{path}] returned {y.dtype}")
        s_ = snr_db(yp, y)
        err = (y.double() - yp.double()).abs().max().item()
        t_k = device_ms(torch, lambda: fold_product(fr, w_op))
        t_p = device_ms(torch, plain)
        bnd = bound(*launch_cost(cost, 1), cost["kind"])
        tflops = cost["flops"] / t_k / 1e9
        yard = {}
        if dt != "f32":
            # two yardsticks of the library's bf16 product, not on the
            # path: the depth K unpadded (the operands' rows not a multiple
            # of 16 bytes), and the bf16 result that fr @ w gives
            k = cost["dims"][1]
            fru, wu = fr[:, :k].contiguous(), w_op[:k].contiguous()
            yard = dict(k=k, k_padded=fr.shape[1], unpadded_ms=device_ms(
                torch, lambda: fold_product(fru, wu)),
                bf16_result_ms=device_ms(torch, lambda: fr @ w_op))
            del fru, wu
        print(f"fold product [{path}, {dt}]: {tuple(fr.shape)} {fr.dtype} @ "
              f"{tuple(w_op.shape)} {w_op.dtype} -> {tuple(y.shape)} "
              f"{y.dtype}: SNR {s_:.1f} dB against the plain version "
              f"({'float64' if dt == 'f32' else 'f32 upcast'}), max abs err "
              f"{err:.3g}; {t_k:.4f} ms ({tflops:.1f} TFLOP/s useful), plain "
              f"{t_p:.4f} ms; bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}, {peak_flops(cost['kind'])[1]} peak; "
              f"{100 * bnd['bound_ms'] / t_k:.0f} % of it reached) on {card}")
        if yard:
            print(f"  yardsticks: K {yard['k']} unpadded (path: "
                  f"{yard['k_padded']}) {yard['unpadded_ms']:.4f} ms; a bf16 "
                  f"result (fr @ w) {yard['bf16_result_ms']:.4f} ms")
        if not s_ > 90.0:
            fail(f"the {dt} fold product [{path}] disagrees with its plain "
                 f"version ({s_:.1f} dB)")
        fold_rows[f"{path}_{dt}"] = dict(
            shape=[list(fr.shape), list(w_op.shape)], snr_db=s_,
            max_abs_err=err, ms=t_k, plain_ms=t_p, tflops=tflops, **bnd,
            peak=peak_flops(cost["kind"])[1], **yard)
        del fr, y, yp
    del rails
    print("fold products: " + json.dumps(fold_rows))

    # -- 3b. the wideband precisions on noise: seeded random u8 bytes (4
    # stations at 9.6 MS/s, two chained one-block segments) through each
    # frontend on the card and on its CPU twin, at every precision. Fused:
    # the fold product's output y (before the rotation and the
    # discriminator), then the demod; two-stage: the complex station rails
    # of forward (before call_u8 quantises them). Each line holds the worse
    # segment's SNR; what is before the discriminator must hold 90 dB.
    offs4 = [-450_000, -150_000, 150_000, 450_000]
    raw4 = torch.from_numpy(np.random.default_rng(11).integers(
        0, 256, (2, 8 * cfg.block_size_iq), dtype=np.uint8))
    noise_rows = {}
    for path, cls, dts in (("fused", FusedWidebandFrontend, WB_DTYPES),
                           ("two_stage", Channelizer, ("f32", "bf16"))):
        for dt in dts:
            fes = [cls(cfg, 4 * cfg.rf_fs, offs4, compute_dtype=dt,
                       device=d) for d in (dev, "cpu")]
            outs = [wideband_stages(torch, fe_n, raw4, d)
                    for fe_n, d in zip(fes, (dev, "cpu"))]
            row = {stage: min(snr_db(c, g.cpu()) for g, c in zip(
                outs[0][stage], outs[1][stage])) for stage in outs[0]
                if stage != "y_float64"}
            if "y" in row:
                # each side's product against the float64 product of its
                # operands: where the card's and the CPU's sums part
                for side, o in zip(("card", "cpu"), outs):
                    row[f"y_vs_float64_{side}"] = min(
                        snr_db(e.cpu(), y.cpu())
                        for e, y in zip(o["y_float64"], o["y"]))
                if dt != "f32":
                    # the card's bf16 product without reduced-precision
                    # reductions (torch's flag; on by default)
                    mm_flags = torch.backends.cuda.matmul
                    keep = mm_flags.allow_bf16_reduced_precision_reduction
                    mm_flags.allow_bf16_reduced_precision_reduction = False
                    try:
                        o = wideband_stages(torch, fes[0], raw4, dev)
                    finally:
                        mm_flags.allow_bf16_reduced_precision_reduction = \
                            keep
                    row["y_vs_float64_card_no_reduced_precision"] = min(
                        snr_db(e.cpu(), y.cpu())
                        for e, y in zip(o["y_float64"], o["y"]))
            noise_rows[f"{path}_{dt}"] = row
            for stage, s_ in row.items():
                print(f"wideband on noise [{path}, {dt}] {stage}: "
                      + (f"{s_:.1f} dB" if stage.startswith("y_vs")
                         else f"card against CPU {s_:.1f} dB"))
            if min(s_ for st, s_ in row.items()
                   if st in ("y", "rails")) <= 90.0:
                fail(f"the {dt} {path} frontend on noise parts from its CPU "
                     f"run before the discriminator: {row}")
    print("wideband on noise: " + json.dumps(noise_rows))
    if args.kernels:
        for mode in (1, 2, 3):      # frontend at the other modes' geometry
            fe_m = Receiver(mode, device=dev).frontend
            n_iq = fe_m.tail_len // 2 + BLOCKS * fe_m.cfg.block_size_iq
            # a constant-envelope carrier with a slow random phase walk
            ph = torch.cumsum(0.1 * torch.rand((CH, n_iq), device=dev,
                                               generator=gen) - 0.05, -1)
            xm = torch.stack([128 + 100 * torch.cos(ph),
                              128 + 100 * torch.sin(ph)], -1).round().to(
                                  torch.uint8).reshape(CH, -1)
            del ph
            dm = frontend_fused.launch(xm, fe_m.rf_fir.taps,
                                       fe_m.rf_fir.down, pi0, pq0)[0]
            sm_ = snr_db(frontend_plain(xm, fe_m.rf_fir, pi0, pq0)[0], dm)
            tm = device_ms(torch, lambda: frontend_fused.launch(
                xm, fe_m.rf_fir.taps, fe_m.rf_fir.down, pi0, pq0))
            bm = frontend_bound(fe_m, xm)
            print(f"kernel frontend_fused[mode {mode}, synthetic carrier]: "
                  f"down {fe_m.rf_fir.down}, {tuple(xm.shape)} -> "
                  f"{tuple(dm.shape)}: SNR {sm_:.1f} dB; kernel {tm:.4f} ms, "
                  f"bound {bm['bound_ms']:.4f} ms ({bm['bound_by']})")
            if not sm_ > 90.0:
                fail(f"mode {mode}: frontend kernel disagrees with its "
                     f"plain version ({sm_:.1f} dB)")
        print("--kernels: stopping after the kernel checks")
        return

    def run_path(path, rxp, segs_p, needed, min_ps):
        """SEGMENTS chained segments of CH ch x BLOCKS blk through
        ``rxp.run_segment``, each timed with events (H2D included); counts
        reset just before and read just after; output shapes, finite
        audio, channel 0's PS/PI and PS on at least ``min_ps`` channels
        (what the port's CPU run decodes on the same shifts) checked.
        Returns (outs, states, segment ms, left, right)."""
        c = rxp.cfg
        reset_counts()
        st = rxp.init_state(CH)
        outs_p, states_p, ms = [], [], []
        for seg in segs_p:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            st, out = rxp.run_segment(st, torch.from_numpy(seg).to(dev))
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
            outs_p.append(out)
            states_p.append(st)
        count_path(path, needed, ("tiled", "general"))
        print(f"{path} path: {SEGMENTS} chained segments of {CH} ch x "
              f"{BLOCKS} blk, {', '.join(f'{t:.2f}' for t in ms)} ms (H2D "
              "included)")
        n_audio = c.audio_block * BLOCKS
        for out in outs_p:
            for t, shape in ((out.left, (CH, n_audio)),
                             (out.right, (CH, n_audio)),
                             (out.rds_bits, (CH, BLOCKS, c.max_bits)),
                             (out.rds_nbits, (CH, BLOCKS))):
                if tuple(t.shape) != shape:
                    fail(f"{path}: output shape {tuple(t.shape)} != {shape}")
            if not (torch.isfinite(out.left).all() and
                    torch.isfinite(out.right).all()):
                fail(f"{path}: non-finite audio")
        left = torch.cat([o.left for o in outs_p], -1).cpu().numpy()
        right = torch.cat([o.right for o in outs_p], -1).cpu().numpy()
        bits = torch.cat([o.rds_bits for o in outs_p], 1).cpu().numpy()
        nbits = torch.cat([o.rds_nbits for o in outs_p], 1).cpu().numpy()
        decoded = [decode(RdsFramer, bits, nbits, ch_) for ch_ in range(CH)]
        ev = decoded[0]
        n_ps = sum(e.ps_name == PS for e in decoded)
        print(f"{path} channel 0: PS {ev.ps_name!r}, PI "
              f"{ev.pi and hex(ev.pi)}, PTY {ev.pty!r}, groups "
              f"{ev.groups_decoded}; PS decoded on {n_ps}/{CH} channels "
              f"(the CPU run: {min_ps})")
        if ev.ps_name != PS or ev.pi != PI:
            fail(f"{path}: channel 0 did not decode the station's PS/PI")
        if n_ps < min_ps:
            fail(f"{path}: PS decoded on {n_ps} channels, fewer than the "
                 f"CPU run's {min_ps}")
        return outs_p, states_p, ms, left, right

    def vs_cpu(path, rxp, segs_p, outs_p, states_p):
        """The port's own CPU run (plain versions) on channels 0-1. Segment
        1 from a cold start: audio (the cold-start RDS carrier sign is set
        by rounding at ~1e-31 magnitudes, which differential decoding
        absorbs). Segment 2 from the card's state after segment 1, moved
        to the CPU: audio and RDS bits."""
        ref = Receiver(rxp.cfg, stereo=True, rds=True, pll_tier=rxp.pll_tier,
                       device="cpu")
        _, r1 = ref.run_segment(ref.init_state(2),
                                torch.from_numpy(segs_p[0][:2]))
        _, r2 = ref.run_segment(map_state(states_p[0],
                                          lambda t: t[:2].cpu()),
                                torch.from_numpy(segs_p[1][:2]))
        pairs_ = ((r1, outs_p[0]), (r2, outs_p[1]))
        snrs = [snr_db(getattr(r, rail)[c], getattr(o, rail)[c].cpu())
                for rail in ("left", "right") for r, o in pairs_
                for c in range(2)]
        same_bits = (torch.equal(r2.rds_bits, outs_p[1].rds_bits[:2].cpu())
                     and torch.equal(r2.rds_nbits,
                                     outs_p[1].rds_nbits[:2].cpu()))
        print(f"{path} card vs CPU run (ch 0-1, segments 1-2): audio SNR "
              f"min {min(snrs):.1f} dB, segment-2 RDS bits equal: "
              f"{same_bits}")
        if not (min(snrs) > 60.0 and same_bits):
            fail(f"the card's {path} path disagrees with the CPU run")

    def warm(path, rxp, st, segs_p, ms, reps):
        """Warm segments: the chain continues over the same segments;
        events split each into its H2D copy (pageable host memory) and the
        receiver's run. Returns (median ms, median H2D ms, state)."""
        warm_ms, h2d = ms[1:], []
        for k in range(reps):
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            marks[0].record()
            x = torch.from_numpy(segs_p[k % SEGMENTS]).to(dev)
            marks[1].record()
            st, _ = rxp.run_segment(st, x)
            marks[2].record()
            marks[2].synchronize()
            warm_ms.append(marks[0].elapsed_time(marks[2]))
            h2d.append(marks[0].elapsed_time(marks[1]))
        med_ = statistics.median(warm_ms)
        radio = BLOCKS * rxp.cfg.block_size_iq / rxp.cfg.rf_fs
        print(f"{path} warm segment: median {med_:.3f} ms over "
              f"{len(warm_ms)} (min {min(warm_ms):.3f}, max "
              f"{max(warm_ms):.3f}), of which H2D "
              f"{statistics.median(h2d):.3f} ms; aggregate "
              f"{CH * radio / (med_ / 1e3):.1f}x real time ({CH} ch x "
              f"{radio:.4f} s of radio per segment) on {card}")
        return med_, statistics.median(h2d), st

    def graph_check(path, eager, jit, calls, st0, needed, bodies,
                    library=False):
        """The graphed form of a path against its eager form. One warm
        eager call runs under ``torch.cuda.set_sync_debug_mode("error")``:
        the path makes no host sync, which a capture could not hold. Then
        ``calls`` chained from ``st0`` eagerly and through ``jit`` (its
        first call captures), the counts reset before each chain: every
        output leaf and the final state ``torch.equal`` and the kernels'
        counts (and bodies) equal, the ``needed`` kernels launched by the
        replays (``count_path``). With ``library`` (a path through a
        library GEMM, which may choose another algorithm under capture)
        leaves that differ are printed and held to the gates instead:
        every float leaf > 90 dB against eager, integer leaves equal.
        Also records what the new graph holds: its pool and static buffers
        stay reserved after the allocator's cache is emptied, and each
        form's first call (the graphed one's is its capture). Returns the
        graphed chain's [(state, *outputs)]."""
        eager(st0, *calls[0])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager(st0, *calls[0])
        except RuntimeError as e:
            torch.cuda.set_sync_debug_mode(0)
            fail(f"{path}: the eager path syncs with the host: {e}")
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        chains, counts, first_ms = {}, {}, {}
        for form, fn in (("eager", eager), ("graphed", jit)):
            reset_counts()
            st, res = st0, []
            for a in calls:
                t_call = time.perf_counter()
                st, *out = fn(st, *a)
                res.append((st, *out))
                if form not in first_ms:
                    torch.cuda.synchronize()
                    first_ms[form] = (time.perf_counter() - t_call) * 1e3
            torch.cuda.synchronize()
            chains[form] = res
            counts[form] = ({k.name: k.launches for k in KERNELS},
                            dict(fir_bank.body_launches),
                            dict(fir_decimate.body_launches))
        count_path(f"{path}_graphed", needed, bodies)
        bad = []
        for k, (ref, got) in enumerate(zip(chains["eager"],
                                           chains["graphed"])):
            for i, (a, b) in enumerate(zip(leaves(ref), leaves(got))):
                if not torch.equal(a, b):
                    bad.append((k, i, a, b))
        print(f"{path} graphed: {len(calls)} chained calls (the first "
              f"captures) against eager: every output leaf and the state "
              f"torch.equal {not bad}; launch counts equal "
              f"{counts['eager'] == counts['graphed']}; eager warm call "
              "clean under set_sync_debug_mode('error'); first call eager "
              f"{first_ms['eager']:.1f} ms, graphed (warm-up and capture) "
              f"{first_ms['graphed']:.1f} ms")
        for k, i, a, b in bad:
            diff = (f"{snr_db(a, b):.1f} dB" if a.is_floating_point() else
                    f"{int((a != b).sum())} of {a.numel()} differ")
            print(f"  {path} call {k} leaf {i} {tuple(a.shape)} {a.dtype}: "
                  f"{diff}")
            if not library:
                fail(f"{path}: the graphed path differs from the eager one")
            if not (a.is_floating_point() and snr_db(a, b) > 90.0):
                fail(f"{path}: a graphed library product is off its gate")
        if counts["eager"] != counts["graphed"]:
            fail(f"{path}: the replays counted {counts['graphed']}, the "
                 f"eager calls {counts['eager']}")
        del chains["eager"], bad
        torch.cuda.empty_cache()
        held = (torch.cuda.memory_reserved() - reserved0) / 1e9
        graph_stats[path] = dict(graph_holds_gb=held,
                                 first_call_ms=first_ms)
        print(f"{path} graph: {held:.3f} GB more device memory reserved "
              "after emptying the cache than before its capture (its pool "
              "and static buffers, and the graphed chain's results)")
        return chains["graphed"]

    def turns(path, forms, reps=8):
        """Warm calls of each form in turns (the order rotates), each form
        chaining its own state: ``forms[name] = (call(state) -> state,
        state)``. Host clock: ms until the call returns (the host's time to
        dispatch it) and ms to a synchronize after it. Prints and returns
        the medians {name: (dispatch ms, wall ms)}."""
        names = list(forms)
        states = {n: forms[n][1] for n in names}
        dispatch = {n: [] for n in names}
        wall = {n: [] for n in names}
        for rep in range(reps):
            for n in names[rep % len(names):] + names[:rep % len(names)]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                states[n] = forms[n][0](states[n])
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                dispatch[n].append((t1 - t0) * 1e3)
                wall[n].append((time.perf_counter() - t0) * 1e3)
        med_ = {n: (statistics.median(dispatch[n]),
                    statistics.median(wall[n]))
                for n in names}
        print(f"{path} warm calls, {reps} of each in turns, the input on "
              f"the card: " + "; ".join(
                  f"{n} dispatch {v[0]:.3f} ms, wall {v[1]:.3f} ms (min "
                  f"{min(wall[n]):.3f}, max {max(wall[n]):.3f})"
                  for n, v in med_.items()) + f"; on {card}")
        return med_

    def peak_memory(path, eager_call, graphed_call):
        """Peak device memory of one warm eager call and one graphed call,
        and the memory the card holds reserved (the graphs' pools among
        it). Returns the numbers in GB."""
        out = {}
        for form, call in (("eager", eager_call), ("graphed", graphed_call)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            call()
            torch.cuda.synchronize()
            out[form] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()
        out["reserved"] = torch.cuda.memory_reserved() / 1e9
        print(f"{path} peak device memory: eager call {out['eager']:.3f} GB, "
              f"graphed call {out['graphed']:.3f} GB (the graph's pool is "
              f"not in the allocator's count); reserved after emptying the "
              f"cache (live tensors and every graph's pool) "
              f"{out['reserved']:.3f} GB; on {card}")
        return out

    def graph_times(path, eager_step, graphed_step, st0, reps=8):
        """The numbers of a graphed path beside its eager form, into
        ``graph_stats[path]``: warm calls in turns (``turns``: the host's
        time to dispatch and the wall, each form chaining its state
        through ``step(state) -> state``), each form's device busy in one
        profiled call and its idle share of the median wall, and one
        call's peak memory (``peak_memory``)."""
        tr = turns(path, {"eager": (eager_step, st0),
                          "graphed": (graphed_step, st0)}, reps)
        busy = {form: device_busy_ms(torch, lambda: step(st0))
                for form, step in (("eager", eager_step),
                                   ("graphed", graphed_step))}
        idle = {form: 1.0 - busy[form] / tr[form][1] for form in busy}
        print(f"{path} device busy (torch.profiler, one warm call): "
              + "; ".join(f"{form} {busy[form]:.3f} ms, idle share "
                          f"{idle[form]:.2f} of the median wall"
                          for form in busy) + f"; on {card}")
        graph_stats[path].update(
            turns=tr, device_busy_ms=busy, idle_share=idle,
            memory_gb=peak_memory(path, lambda: eager_step(st0),
                                  lambda: graphed_step(st0)))

    def staged_path(segs_p, st0):
        """Host-staged ingest at the flagship shape. The segments' staged
        cells (``benchkit.stage_cells``: pinned host memory, asynchronous
        uploads; segment 0's tail is segment 2's end, the state ``st0``
        holds after one pass) run through ``run_segment_staged`` with the
        unstaged segment 1 between them, against three unstaged calls from
        ``st0``: every output leaf and the final state equal, and the
        kernels launched as often as on the unstaged path. The digests
        equal. The three cells through ``jit_run_segment_staged``
        (``graph_check``). Then warm segments of the unstaged, staged and
        graphed staged forms in turns, host staging and H2D included, the
        host's time to dispatch each call, peak memory, and the roofline
        report against phase 3's bounds. Returns the cells."""
        n2 = segs_p[0].shape[1]
        tl = rx.frontend.tail_len
        cells = benchkit.stage_cells(rx, np.concatenate(segs_p, axis=1), 1,
                                     CH, SEGMENTS, n2)[0]
        st_ref, ref_outs = st0, []
        for seg in segs_p:
            st_ref, o = rx.run_segment(st_ref, torch.from_numpy(seg).to(dev))
            ref_outs.append(o)
        reset_counts()
        st_s, outs_s = st0, []
        for k in range(SEGMENTS):
            if k == 1:
                st_s, o = rx.run_segment(st_s,
                                         torch.from_numpy(segs_p[k]).to(dev))
            else:
                st_s, o = rx.run_segment_staged(st_s, cells[k], n2)
            outs_s.append(o)
        torch.cuda.synchronize()
        count_path("mode0_staged", (frontend_fused.name, fir_bank.name,
                                    fir_decimate.name), ("tiled", "general"))
        same = (all(torch.equal(a, b) for o, r in zip(outs_s, ref_outs)
                    for a, b in zip(leaves(o), leaves(r)))
                and all(torch.equal(a, b)
                        for a, b in zip(leaves(st_s), leaves(st_ref))))
        got, want = by_path["mode0_staged"], by_path["mode0"]
        d_u = benchkit._digest_fn(rx, st0,
                                  torch.from_numpy(segs_p[0]).to(dev))[1]
        d_s = benchkit._digest_staged_fn(rx, n2, st0, cells[0])[1]
        print(f"mode0 staged: {SEGMENTS} chained segments of {CH} ch x "
              f"{BLOCKS} blk (staged from pinned stage_cells, unstaged, "
              f"staged) against {SEGMENTS} unstaged calls: every output "
              f"leaf and the final state torch.equal {same}; digest_step "
              f"{d_u.item():.6e}, digest_step_staged {d_s.item():.6e}, equal "
              f"{torch.equal(d_u, d_s)}")
        if not (same and torch.equal(d_u, d_s)):
            fail("the staged mode-0 path differs from the unstaged one")
        for name in (frontend_fused.name, fir_bank.name, fir_decimate.name):
            if got[name] != want[name]:
                fail(f"{name} launched {got[name]} times on the staged path, "
                     f"{want[name]} on the unstaged one")
        graph_check("mode0_staged", rx.run_segment_staged,
                    rx.jit_run_segment_staged, [(c, n2) for c in cells], st0,
                    (frontend_fused.name, fir_bank.name, fir_decimate.name),
                    ("tiled", "general"))
        # warm segments of the three forms in turns (the order rotates),
        # each chain carrying its own state and host tail; host clock
        # around (host staging +) upload + run + synchronize, and until the
        # call returns (its dispatch); events around the upload
        ring = [torch.empty((CH, rx.frontend.staged_len(n2)),
                            dtype=torch.uint8, pin_memory=True)
                for _ in range(2)]
        forms = ("unstaged", "staged", "graphed")
        chains = {"unstaged": st_ref, "staged": st_s, "graphed": st_s}
        tails = dict.fromkeys(forms[1:], np.ascontiguousarray(
            segs_p[-1][:, n2 - tl:]))
        wall = {f: [] for f in forms}
        h2d = {f: [] for f in forms}
        dispatch = {f: [] for f in forms}
        host_ms = []
        reps = 8
        for rep in range(reps):
            seg = segs_p[rep % SEGMENTS]
            for path in forms[rep % 3:] + forms[:rep % 3]:
                marks = [torch.cuda.Event(enable_timing=True)
                         for _ in range(3)]
                t0 = time.perf_counter()
                if path != "unstaged":
                    buf = ring[rep % 2]
                    rx.frontend.stage_segment(tails[path], seg,
                                              out=buf.numpy())
                    host_ms.append((time.perf_counter() - t0) * 1e3)
                    marks[0].record()
                    x = buf.to(dev, non_blocking=True)
                    marks[1].record()
                    t1 = time.perf_counter()
                    run = (rx.run_segment_staged if path == "staged"
                           else rx.jit_run_segment_staged)
                    chains[path], _ = run(chains[path], x, n2)
                    tails[path] = seg[:, n2 - tl:]
                else:
                    marks[0].record()
                    x = torch.from_numpy(seg).to(dev)
                    marks[1].record()
                    t1 = time.perf_counter()
                    chains[path], _ = rx.run_segment(chains[path], x)
                dispatch[path].append((time.perf_counter() - t1) * 1e3)
                marks[2].record()
                marks[2].synchronize()
                wall[path].append((time.perf_counter() - t0) * 1e3)
                h2d[path].append(marks[0].elapsed_time(marks[1]))
        radio = BLOCKS * cfg.block_size_iq / cfg.rf_fs
        med_ = {p: statistics.median(v) for p, v in wall.items()}
        h2d_ = {p: statistics.median(v) for p, v in h2d.items()}
        print(f"mode0 warm segment at {CH} ch x {BLOCKS} blk, {reps} of each "
              f"in turns, host clock around (staging +) upload + run + "
              f"synchronize: staged median {med_['staged']:.3f} ms (min "
              f"{min(wall['staged']):.3f}, max {max(wall['staged']):.3f}; "
              f"host staging into pinned memory "
              f"{statistics.median(host_ms):.3f} ms, H2D pinned "
              f"{h2d_['staged']:.3f} ms), unstaged median "
              f"{med_['unstaged']:.3f} ms (min {min(wall['unstaged']):.3f}, "
              f"max {max(wall['unstaged']):.3f}; H2D pageable "
              f"{h2d_['unstaged']:.3f} ms); graphed staged median "
              f"{med_['graphed']:.3f} ms (min {min(wall['graphed']):.3f}, "
              f"max {max(wall['graphed']):.3f}; H2D pinned "
              f"{h2d_['graphed']:.3f} ms); aggregate "
              f"{CH * radio / (med_['graphed'] / 1e3):.1f}x graphed, "
              f"{CH * radio / (med_['staged'] / 1e3):.1f}x staged, "
              f"{CH * radio / (med_['unstaged'] / 1e3):.1f}x unstaged real "
              f"time; host time to dispatch the call: graphed "
              f"{statistics.median(dispatch['graphed']):.3f} ms, staged "
              f"{statistics.median(dispatch['staged']):.3f} ms, unstaged "
              f"{statistics.median(dispatch['unstaged']):.3f} ms; on {card}")
        graph_stats["mode0_staged"].update(
            turns=turns("mode0_staged", {
                "eager": (lambda st: rx.run_segment_staged(st, cells[0],
                                                           n2)[0], st0),
                "graphed": (lambda st: rx.jit_run_segment_staged(
                    st, cells[0], n2)[0], st0)}),
            wall_ms={f: med_[f] for f in forms},
            dispatch_ms={f: statistics.median(dispatch[f]) for f in forms},
            host_staging_ms=statistics.median(host_ms),
            memory_gb=peak_memory(
                "mode0_staged",
                lambda: rx.run_segment_staged(st0, cells[0], n2),
                lambda: rx.jit_run_segment_staged(st0, cells[0], n2)))
        if args.profile:     # the operand is on the card already
            profile_segment(torch, card, args.profile, "mode0_staged",
                            lambda: rx.run_segment_staged(st0, cells[0], n2),
                            med_["staged"] - statistics.median(host_ms)
                            - h2d_["staged"])
            # the graphed call's wall with its operand on the card
            profile_segment(torch, card, args.profile, "mode0_staged_graphed",
                            lambda: rx.jit_run_segment_staged(st0, cells[0],
                                                              n2),
                            graph_stats["mode0_staged"]["turns"]["graphed"][1])
        # the roofline from the modules' cost(): each kernel's row at the
        # flagship shape against phase 3's bound of the same launches
        sol = speed_of_light_report(rx, file=sys.stdout, channels=CH,
                                    blocks=BLOCKS,
                                    sm_clock_hz=sm_mhz * 1e6)
        for name in (frontend_fused.name, fir_bank.name, fir_decimate.name):
            row, ph3 = sol["kernels"][name]["floor_ms"], \
                kernels[name]["bound_ms"]
            print(f"roofline kernel row {name}: {row:.5f} ms at {CH} x "
                  f"{BLOCKS}, phase 3's bound {ph3:.5f} ms "
                  f"({100 * (row / ph3 - 1):+.3f} %)")
            if abs(row / ph3 - 1) > 0.01:
                fail(f"the roofline row of {name} is not phase 3's bound")
        print(f"roofline, mode 0 tier 3 at {CH} x {BLOCKS}: floor "
              f"{sol['floor_s'] * CH * BLOCKS * 1e3:.4f} ms per segment")
        del ring, chains
        return cells

    # -- 4. mode-0 path -------------------------------------------------------
    outs, states, seg_ms, left, right = run_path(
        "mode0", rx, segs,
        (frontend_fused.name, fir_bank.name, fir_decimate.name),
        PS_CHANNELS[0])
    fs = float(cfg.audio_fs)
    skip = 3 * cfg.audio_block
    sep_l = (band_power(np, left[0, skip:], fs, 440)
             / band_power(np, right[0, skip:], fs, 440))
    sep_r = (band_power(np, right[0, skip:], fs, 1200)
             / band_power(np, left[0, skip:], fs, 1200))
    print(f"channel 0 stereo separation: 440 Hz L/R {sep_l:.1f}, "
          f"1200 Hz R/L {sep_r:.1f}")
    if not (sep_l > 30 and sep_r > 30):
        fail("left/right do not carry their tones")
    vs_cpu("mode0", rx, segs, outs, states)
    cells = staged_path(segs, states[-1])
    n2_0 = segs[0].shape[1]
    # 4-. the bank's own entries and the bench digest steps at 32 x 12,
    # each against its eager form: step (one block per channel) and
    # run_segment through the receiver's jit_step, run (the 12 blocks as 12
    # one-block steps in one graph), run_segment_demod (the frontend's
    # demod of each segment), digest_step and digest_step_staged (phase 4's
    # staged cells); then each form's warm calls in turns, device busy and
    # memory
    bank = ChannelBank(rx, CH)
    blk = 2 * cfg.block_size_iq
    dsegs = [torch.from_numpy(sg).to(dev) for sg in segs]
    f_st, demods = states[-1].frontend, []
    for d in dsegs:
        dm, f_st = rx.frontend(d, f_st)
        demods.append(dm)
    full = (frontend_fused.name, fir_bank.name, fir_decimate.name)
    for path, eager_f, jit_f, calls, needed in (
            ("bank_step", bank._step, bank.step,
             [(d[:, :blk].contiguous(),) for d in dsegs], full),
            ("bank_run_segment", bank._step, bank.run_segment,
             [(d,) for d in dsegs], full),
            ("bank_run", bank._run, bank.run,
             [(d.reshape(CH, BLOCKS, blk).transpose(0, 1).contiguous(),)
              for d in dsegs], full),
            ("bank_run_segment_demod", bank._run_segment_demod,
             bank.run_segment_demod, [(dm,) for dm in demods],
             (fir_bank.name, fir_decimate.name)),
            ("digest", lambda st, x: benchkit._digest_fn(rx, st, x),
             benchkit.digest_step(rx), [(d,) for d in dsegs], full),
            ("digest_staged",
             lambda st, x: benchkit._digest_staged_fn(rx, n2_0, st, x),
             benchkit.digest_step_staged(rx, n2_0), [(c,) for c in cells],
             full)):
        graph_check(path, eager_f, jit_f, calls, states[-1], needed,
                    ("tiled", "general"))
        graph_times(path, lambda st, f=eager_f, a=calls[0]: f(st, *a)[0],
                    lambda st, f=jit_f, a=calls[0]: f(st, *a)[0],
                    states[-1])
    del bank, dsegs, demods, f_st
    med, h2d_med, state = warm("mode0", rx, states[-1], segs, seg_ms, 10)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"GB on {card}")
    if args.profile:
        seg = torch.from_numpy(segs[0]).to(dev)
        profile_segment(torch, card, args.profile, "mode0",
                        lambda: rx.run_segment(state, seg), med - h2d_med)
    del outs, states, state

    # -- 4b. mode 0 at the default carrier tier 1, and at tier 2 -------------
    rx1 = Receiver(0, stereo=True, rds=True, device=dev)
    if rx1.pll_tier != 1:
        fail(f"the receiver's default tier is {rx1.pll_tier}, not 1")
    outs, states, seg_ms, _, _ = run_path(
        "mode0_tier1", rx1, segs,
        (frontend_fused.name, fir_bank.name, fir_decimate.name,
         pll_scan_kernel.name), PS_CHANNELS[0])
    vs_cpu("mode0_tier1", rx1, segs, outs, states)
    med1, _, _ = warm("mode0_tier1", rx1, states[-1], segs, seg_ms, 5)
    print(f"mode-0 warm segment, tier 1 vs tier 3: {med1:.3f} ms vs "
          f"{med:.3f} ms")
    # the same staged cells at tier 1 through jit_run_segment_staged (the
    # operand depends on the frontend alone, which the tiers share)
    graph_check("mode0_tier1_staged", rx1.run_segment_staged,
                rx1.jit_run_segment_staged, [(c, n2_0) for c in cells],
                states[-1], (frontend_fused.name, fir_bank.name,
                             fir_decimate.name, pll_scan_kernel.name),
                ("tiled", "general"))
    graph_stats["mode0_tier1_staged"].update(
        turns=turns("mode0_tier1_staged", {
            "eager": (lambda st: rx1.run_segment_staged(st, cells[0],
                                                        n2_0)[0],
                      states[-1]),
            "graphed": (lambda st: rx1.jit_run_segment_staged(
                st, cells[0], n2_0)[0], states[-1])}),
        memory_gb=peak_memory(
            "mode0_tier1_staged",
            lambda: rx1.run_segment_staged(states[-1], cells[0], n2_0),
            lambda: rx1.jit_run_segment_staged(states[-1], cells[0], n2_0)))
    # pll_scan at the shapes the tier-1 paths give it: the stereo and RDS
    # pilots of one real segment, (32, 12 x 7,350) as mode0_tier1 runs
    # them, and channel 0's first block, (1, 7,350) as the CLI runs them.
    # The plain version is launch-bound (~1 s per 7,350 samples), so at the
    # segment shape it runs channels 0-1 against the kernel's rows 0-1.
    seen = {}

    def capture(loop):
        def hook(mod, args_):          # returns None: the inputs stay
            seen.setdefault(loop, (mod.p, *args_))
        return hook
    hooks = [m.register_forward_pre_hook(capture(loop))
             for loop, m in (("stereo", rx1.audio.sync),
                             ("rds", rx1.rds_path.sync))]
    rx1.run_segment(states[0], torch.from_numpy(segs[1]).to(dev))
    for h in hooks:
        h.remove()
    seg_pll_ms = 0.0
    for loop, (p, xs, cs) in seen.items():
        case = check_pll(f"{loop}, tier-1 segment", xs, cs, p, 2, 0)
        pll_cases[f"{loop}_segment"] = case
        seg_pll_ms += case["ms"]
        pll_cases[f"{loop}_cli"] = check_pll(
            f"{loop}, CLI block", xs[:1, :n_blk].contiguous(),
            PllCarry(*(t[:1] for t in cs)), p, 1, 3)
    print(f"pll_scan per mode0_tier1 segment ({CH} x {BLOCKS * n_blk}, both "
          f"loops): kernel {seg_pll_ms:.3f} ms of the {med1:.3f} ms warm "
          f"segment; per CLI block (1 x {n_blk}, both loops): kernel "
          f"{pll_cases['stereo_cli']['ms'] + pll_cases['rds_cli']['ms']:.4f}"
          f" ms; on {card}")
    kernels[pll_scan_kernel.name]["max_abs_err"] = max(
        v["max_abs_err"] for v in pll_cases.values())
    sol1 = speed_of_light_report(rx1, file=sys.stdout, channels=CH,
                                 blocks=BLOCKS, sm_clock_hz=sm_mhz * 1e6)
    print(f"roofline, mode 0 tier 1 at {CH} x {BLOCKS}: floor "
          f"{sol1['floor_s'] * CH * BLOCKS * 1e3:.4f} ms per segment beside "
          f"the loops' chain floor "
          f"{sol1['kernels'][pll_scan_kernel.name]['floor_ms']:.3f} ms "
          f"(pll_scan measured {seg_pll_ms:.3f} ms)")
    del outs, states, seen
    rx2 = Receiver(0, stereo=True, rds=True, pll_tier=2, device=dev)
    x2 = torch.from_numpy(np.ascontiguousarray(
        segs[0][:, :2 * 2 * cfg.block_size_iq])).to(dev)
    t2 = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, o2 = rx2.run_segment(rx2.init_state(CH), x2)
        torch.cuda.synchronize()
        t2.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(o2.left).all():
            fail("tier 2: non-finite audio")
    print(f"mode0_tier2: one {CH} ch x 2 blk segment, "
          f"{statistics.median(t2):.2f} ms (median of 3, host clock)")
    graph_check("mode0_tier2", rx2.step, rx2.jit_step, [(x2,), (x2,)],
                rx2.init_state(CH), (frontend_fused.name, fir_bank.name,
                                     fir_decimate.name), ("tiled", "general"))
    del rx2, x2, cells

    # -- 4c. modes 1-3 at 32 ch x 12 blk, type r, tier 3 ---------------------
    pi0m, pq0m = (torch.from_numpy(rng.uniform(-0.5, 0.5, CH).astype(
        np.float32)).to(dev) for _ in range(2))
    fe_modes, mode_sites = {}, {}
    for mode in (1, 2, 3):
        rxm = Receiver(mode, stereo=True, rds=True, pll_tier=3, device=dev)
        cm = rxm.cfg
        iq_m, _ = synth.station_iq(cm, BLOCKS * SEGMENTS, ps_name=PS, pi=PI,
                                   pty=PTY)
        segs_m = tile_channels(np, iq_m, cm)
        fe = rxm.frontend
        xx = torch.cat([fe.init_state(CH).iq_tail,
                        torch.from_numpy(segs_m[0]).to(dev)], dim=-1)
        dk, ik, qk = frontend_fused.launch(xx, fe.rf_fir.taps,
                                           fe.rf_fir.down, pi0m, pq0m)
        dp, ip, qp = frontend_plain(xx, fe.rf_fir, pi0m, pq0m)
        torch.cuda.synchronize()
        s_ = snr_db(dp, dk)
        err = (dk - dp).abs().max().item()
        t_k = device_ms(torch, lambda: frontend_fused.launch(
            xx, fe.rf_fir.taps, fe.rf_fir.down, pi0m, pq0m))
        t_p = device_ms(torch, lambda: frontend_plain(xx, fe.rf_fir, pi0m,
                                                      pq0m))
        bnd = frontend_bound(fe, xx)
        print(f"kernel frontend_fused[mode {mode}]: down {fe.rf_fir.down}, "
              f"({CH}, {xx.shape[1]}) u8 -> {tuple(dk.shape)}: SNR "
              f"{s_:.1f} dB vs plain, max abs err {err:.3g}; kernel "
              f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound "
              f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        if not s_ > 90.0:
            fail(f"mode {mode}: frontend kernel disagrees with its plain "
                 f"version ({s_:.1f} dB)")
        fe_modes[mode] = dict(ms=t_k, plain_ms=t_p, snr_db=s_, **bnd)
        kernels[frontend_fused.name]["max_abs_err"] = max(
            kernels[frontend_fused.name]["max_abs_err"], err)
        del xx, dk, dp
        a_up, a_down = cm.audio_up, cm.audio_down
        r_up, r_down = cm.rds_resample
        # mode 1's audio does not upsample: its resampler is fir_decimate
        # (checked above at this geometry), not a FIR-bank site
        audio_site = [] if a_up == 1 else [
            (f"mode{mode}_audio_{a_up}_{a_down}", rxm.audio.resamp_bank,
             2 * CH, cm.if_block * BLOCKS)]
        for name, bank, rows, n in audio_site + [
                (f"mode{mode}_rds_baseband_{r_up}_{r_down}",
                 rxm.rds_path.baseband_bank, CH * BLOCKS, cm.if_block)]:
            t_k, t_p, err, body, extra = check_site(name, bank, rows, n)
            mode_sites[name] = dict(ms=t_k, plain_ms=t_p, body=body, **extra)
            kernels[fir_bank.name]["max_abs_err"] = max(
                kernels[fir_bank.name]["max_abs_err"], err)
        outs, states, seg_ms, _, _ = run_path(
            f"mode{mode}", rxm, segs_m,
            (frontend_fused.name, fir_bank.name)
            + ((fir_decimate.name,) if a_up == 1 else ()),
            PS_CHANNELS[mode])
        vs_cpu(f"mode{mode}", rxm, segs_m, outs, states)
        warm(f"mode{mode}", rxm, states[-1], segs_m, seg_ms, 5)
        graph_check(f"mode{mode}", rxm.step, rxm.jit_step,
                    [(torch.from_numpy(sg).to(dev),) for sg in segs_m],
                    rxm.init_state(CH), (frontend_fused.name, fir_bank.name)
                    + ((fir_decimate.name,) if a_up == 1 else ()),
                    ("tiled", "general"))
        del outs, states, segs_m, rxm
    kernels[frontend_fused.name]["modes"] = fe_modes
    kernels[fir_bank.name]["mode_sites"] = mode_sites

    # -- 5. wideband paths ----------------------------------------------------
    stations = [dict(offset_hz=offs[k], ps_name=f"WB64-{k:03d}"[:8],
                     pi=0x1000 + k, pty=4, tone_left=400.0 + 200 * j,
                     tone_right=1500.0) for j, k in enumerate(WB_SLOTS)]
    t0 = time.perf_counter()
    iw, qw, _ = synth.wideband_iq(cfg, wide_fs, stations,
                                  BLOCKS * SEGMENTS)
    x = np.empty(2 * len(iw), np.float32)
    x[0::2], x[1::2] = iw, qw
    raw = np.clip(np.round(128.0 + 127.0 * x), 0, 255).astype(np.uint8)
    del iw, qw, x
    wseg = 2 * BLOCKS * cfg.block_size_iq * WB_MULT      # bytes per segment
    wsegs = [raw[k * wseg:(k + 1) * wseg] for k in range(SEGMENTS)]
    print(f"wideband fixture: {WB_STATIONS} stations on the 300 kHz raster "
          f"in {wide_fs / 1e6:g} MS/s, real stations at slots "
          f"{list(WB_SLOTS)}, {SEGMENTS} segments of {BLOCKS} blk = "
          f"{wseg / 1e6:.1f} MB u8 each (synthesized in "
          f"{time.perf_counter() - t0:.1f} s)")
    wbank = ChannelBank(rx, WB_STATIONS)
    radio_s = BLOCKS * cfg.block_size_iq / cfg.rf_fs

    def run_wideband(path, fe, needed):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        bs, fs_ = wbank.init_state(), fe.init_state()
        bits, nbits, seg_t, rails = [], [], [], []
        for seg in wsegs:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            bs, out, fs_ = wbank.run_wideband_u8(
                bs, fe, torch.from_numpy(seg).to(dev), fs_)
            b.record()
            b.synchronize()
            seg_t.append(a.elapsed_time(b))
            if len(seg_t) == 1:     # the carried state after segment 0
                state0 = map_state((bs, fs_), lambda t: t.clone())
            if not torch.isfinite(out.left).all():
                fail(f"{path}: non-finite audio")
            bits.append(out.rds_bits)
            nbits.append(out.rds_nbits)
            rails.append((out.left, out.right))
        count_path(path, needed, ("tiled",))
        kept = dict(left=torch.cat([r[0] for r in rails], -1).cpu(),
                    right=torch.cat([r[1] for r in rails], -1).cpu(),
                    bits=torch.cat(bits, 1).cpu(),
                    nbits=torch.cat(nbits, 1).cpu(), state0=state0)
        bits, nbits = kept["bits"].numpy(), kept["nbits"].numpy()
        for st in stations:
            k = offs.index(st["offset_hz"])
            ev = decode(RdsFramer, bits, nbits, k)
            print(f"{path} station {k} @ {st['offset_hz'] / 1e6:+.2f} MHz: "
                  f"PS {ev.ps_name!r}, PI {ev.pi and hex(ev.pi)}, groups "
                  f"{ev.groups_decoded}")
            if ev.ps_name != st["ps_name"] or ev.pi != st["pi"]:
                fail(f"{path}: station {k} did not decode its PS/PI")
        warm, h2d = seg_t[1:], []
        for k in range(8):
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            marks[0].record()
            seg = torch.from_numpy(wsegs[k % SEGMENTS]).to(dev)
            marks[1].record()
            bs, _, fs_ = wbank.run_wideband_u8(bs, fe, seg, fs_)
            marks[2].record()
            marks[2].synchronize()
            warm.append(marks[0].elapsed_time(marks[2]))
            h2d.append(marks[0].elapsed_time(marks[1]))
        med = statistics.median(warm)
        kept["warm_ms"] = med
        rt = radio_s / (med / 1e3)
        print(f"{path} wideband segment ({WB_STATIONS} st x {BLOCKS} blk, "
              f"H2D of {wseg / 1e6:.1f} MB included): first "
              f"{seg_t[0]:.2f} ms; warm median {med:.3f} ms over "
              f"{len(warm)} (min {min(warm):.3f}, max {max(warm):.3f}), of "
              f"which H2D {statistics.median(h2d):.3f} ms; "
              f"{rt:.2f}x real time on the {wide_fs / 1e6:g} MS/s input, "
              f"{WB_STATIONS * cfg.rf_fs * rt / 1e6:.1f} MS/s of station IQ "
              f"decoded; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; on {card}")

        # the graphed entry: three chained segments from a fresh state
        # against the eager ones (a library fold product inside: held to
        # its gates where a leaf differs), then warm calls in turns
        def eager_wb(st, seg, fe=fe):
            b_, o_, f_ = wbank.run_wideband_u8(st[0], fe, seg, st[1])
            return (b_, f_), o_

        def jit_wb(st, seg, fe=fe):
            b_, o_, f_ = wbank.run_wideband_u8_jit(st[0], fe, seg, st[1])
            return (b_, f_), o_
        dsegs = [torch.from_numpy(sg).to(dev) for sg in wsegs]
        s0 = (wbank.init_state(), fe.init_state())
        graph_check(f"{path}_wideband", eager_wb, jit_wb,
                    [(d,) for d in dsegs], s0, needed, ("tiled",),
                    library=True)
        graph_stats[f"{path}_wideband"].update(
            turns=turns(f"{path}_wideband", {
                "eager": (lambda st: eager_wb(st, dsegs[0])[0], s0),
                "graphed": (lambda st: jit_wb(st, dsegs[0])[0], s0)}),
            memory_gb=peak_memory(f"{path}_wideband",
                                  lambda: eager_wb(s0, dsegs[0]),
                                  lambda: jit_wb(s0, dsegs[0])))
        del dsegs
        if args.profile:
            seg = torch.from_numpy(wsegs[0]).to(dev)
            # one fold product at the segment's shapes, for the device
            # busy of a window in which the profiler missed its kernels
            fr_p, w_p, _ = fold_operands(fe, 0.3 * torch.randn(
                (2, n_wb + 4096), device=dev, generator=gen))
            profile_segment(torch, card, args.profile, path,
                            lambda: wbank.run_wideband_u8(bs, fe, seg, fs_),
                            med - statistics.median(h2d),
                            product=lambda: fold_product(fr_p, w_p))
            del fr_p, w_p
        return kept

    ch = wb_fe["two_stage", "f32"]
    if not (ch.fold_static and ch.fold_R == 16 and ch.fold_J == 323):
        fail(f"unexpected channelizer geometry (static {ch.fold_static}, "
             f"R {ch.fold_R}, J {ch.fold_J})")
    wb_ref = {"two_stage": run_wideband(
        "two_stage", ch, (chan_epilogue.name, frontend_fused.name,
                          fir_bank.name, fir_decimate.name))}
    # card against the port's own CPU run on the first 2 blocks
    first = torch.from_numpy(raw[:2 * 2 * cfg.block_size_iq * WB_MULT])
    u8_card, _ = ch.call_u8(*u8_to_rails(first.to(dev)), ch.init_state())
    ch_cpu = Channelizer(cfg, wide_fs, offs, device="cpu")
    u8_cpu, _ = ch_cpu.call_u8(*u8_to_rails(first), ch_cpu.init_state())
    diff = (u8_card.cpu().int() - u8_cpu.int()).abs()
    frac = (diff != 0).float().mean().item()
    print(f"two_stage u8 card vs CPU run (2 blocks, {tuple(u8_cpu.shape)}): "
          f"max diff {diff.max().item()} LSB on {frac:.2e} of bytes")
    if not (diff.max().item() <= 1 and frac < 0.01):
        fail("the card's channelizer disagrees with the CPU run")
    del ch_cpu, u8_card, u8_cpu, diff

    wf = wb_fe["fused", "f32"]
    print(f"fused frontend: lo {wf.lo}, R {wf.r_n}, J {wf.j_w}, weights "
          f"{tuple(wf.w.shape)}")
    wb_ref["fused"] = run_wideband("fused", wf,
                                   (fir_bank.name, fir_decimate.name))

    # the same capture at the other precisions: PS/PI on the 3 stations
    # (the gate); the fused demod of the real stations against the f32
    # run's (> 35 dB at bf16, > 45 at bf16x2: the JAX package's bounds);
    # the two-stage u8 against the f32 run's (bytes that differ, printed);
    # RDS bits of segments 1-2 from the f32 run's carried state after
    # segment 0 (the states are f32 at every precision); warm segments
    # beside the f32 run's
    real_k = [offs.index(st["offset_hz"]) for st in stations]

    def frontend_out(fe_):
        """The frontend alone over the 3 segments: the fused demod or the
        two-stage u8 of every station, on the host."""
        st_, outs_ = fe_.init_state(), []
        for seg in wsegs:
            rails_ = u8_to_rails(torch.from_numpy(seg).to(dev))
            if isinstance(fe_, FusedWidebandFrontend):
                o_, st_ = fe_(*rails_, st_)
            else:
                o_, st_ = fe_.call_u8(*rails_, st_)
            outs_.append(o_.cpu())
        return torch.cat(outs_, -1)

    wb_prec = {}
    for path, needed in (("two_stage", (chan_epilogue.name,
                                        frontend_fused.name, fir_bank.name,
                                        fir_decimate.name)),
                         ("fused", (fir_bank.name, fir_decimate.name))):
        ref_out = frontend_out(wb_fe[path, "f32"])
        for dt in ("bf16", "bf16x2"):
            if (path, dt) not in wb_fe:
                continue
            fe_p = wb_fe[path, dt]
            kept_p = run_wideband(f"{path}_{dt}", fe_p, needed)
            out_p = frontend_out(fe_p)
            row = dict(warm_ms=kept_p["warm_ms"],
                       warm_ms_f32=wb_ref[path]["warm_ms"])
            if path == "fused":
                row["demod_snr_db"] = [snr_db(ref_out[k], out_p[k])
                                       for k in real_k]
                print(f"{path}_{dt} demod of stations {real_k} against the "
                      f"f32 run: " + ", ".join(
                          f"{v:.1f}" for v in row["demod_snr_db"]) + " dB")
                if min(row["demod_snr_db"]) <= (35.0 if dt == "bf16"
                                                else 45.0):
                    fail(f"the {dt} fused demod is too far from the f32 "
                         "run's")
            else:
                diff = (out_p.int() - ref_out.int()).abs()
                hist = torch.bincount(diff.flatten(), minlength=3)
                row.update(bytes_differing=(diff != 0).float().mean().item(),
                           lsb_hist={str(i): int(v) for i, v in
                                     enumerate(hist.tolist()) if v},
                           real_bytes_differing=(
                               diff[real_k] != 0).float().mean().item())
                print(f"{path}_{dt} u8 against the f32 run ({tuple(diff.shape)}"
                      f"): {row['bytes_differing']:.3e} of bytes differ "
                      f"({row['real_bytes_differing']:.3e} on the real "
                      f"stations), bytes by LSB of difference "
                      f"{row['lsb_hist']}")
            # RDS bits from the f32 run's carried state after segment 0
            bs, fs_ = map_state(wb_ref[path]["state0"], lambda t: t.clone())
            bits_p, nb_p = [], []
            for seg in wsegs[1:]:
                bs, o_, fs_ = wbank.run_wideband_u8(
                    bs, fe_p, torch.from_numpy(seg).to(dev), fs_)
                bits_p.append(o_.rds_bits.cpu())
                nb_p.append(o_.rds_nbits.cpu())
            bits_p, nb_p = torch.cat(bits_p, 1), torch.cat(nb_p, 1)
            ref_bits = wb_ref[path]["bits"][:, -bits_p.shape[1]:]
            ref_nb = wb_ref[path]["nbits"][:, -nb_p.shape[1]:]
            nb_same = torch.equal(nb_p[real_k], ref_nb[real_k])
            bits_diff = sum(
                int((bits_p[k, b, :nb_p[k, b]]
                     != ref_bits[k, b, :nb_p[k, b]]).sum())
                for k in real_k for b in range(nb_p.shape[1])) if nb_same \
                else None
            row.update(rds_nbits_equal=nb_same, rds_bits_differing=bits_diff)
            print(f"{path}_{dt} RDS bits of segments 1-{SEGMENTS - 1} from "
                  f"the f32 run's carried state: bit counts equal {nb_same}, "
                  f"{bits_diff} of "
                  f"{int(ref_nb[real_k].sum())} bits of the real stations "
                  f"differ; warm segment {kept_p['warm_ms']:.3f} ms against "
                  f"f32 {wb_ref[path]['warm_ms']:.3f} ms")
            wb_prec[f"{path}_{dt}"] = row
    print("wideband precisions: " + json.dumps(wb_prec))
    del wbank

    # 5b. the +20 dB adjacent-channel interferer, the JAX package's case
    # (tests/test_channelizer.py, tests/test_wideband_fused.py): a weak
    # station at -400 kHz beside one 10x louder 200 kHz away, 26 blocks at
    # 9.6 MS/s, tier 1, through each frontend at each precision into the
    # graphed bank (run_segment, run_segment_demod): each station's left
    # tone within 10 Hz, its PS and PI exact
    int_st = [dict(offset_hz=-400_000, ps_name="WEAK-OK ", pi=0x3E3E, pty=4,
                   tone_left=700.0, tone_right=700.0, amp=1.0),
              dict(offset_hz=-200_000, ps_name="LOUD-ADJ", pi=0x4F4F, pty=8,
                   tone_left=1800.0, tone_right=1800.0, amp=10.0)]
    int_fs, int_offs = 4 * cfg.rf_fs, [st["offset_hz"] for st in int_st]
    iw, qw, _ = synth.wideband_iq(cfg, int_fs, int_st, 26)
    iw, qw = torch.from_numpy(iw).to(dev), torch.from_numpy(qw).to(dev)
    rx_i = Receiver(0, stereo=True, rds=True, pll_tier=1, device=dev)
    ibank = ChannelBank(rx_i, 2)
    interferer = {}
    for path, dt in (("two_stage", "f32"), ("two_stage", "bf16"),
                     ("fused", "f32"), ("fused", "bf16"),
                     ("fused", "bf16x2")):
        if path == "two_stage":
            fe_i = Channelizer(cfg, int_fs, int_offs, compute_dtype=dt,
                               device=dev)
            u8, _ = fe_i.call_u8(iw, qw, fe_i.init_state())
            _, out = ibank.run_segment(ibank.init_state(), u8)
        else:
            fe_i = FusedWidebandFrontend(cfg, int_fs, int_offs,
                                         compute_dtype=dt, device=dev)
            demod, _ = fe_i(iw, qw, fe_i.init_state())
            _, out = ibank.run_segment_demod(ibank.init_state(), demod)
        bits, nbits = out.rds_bits.cpu().numpy(), out.rds_nbits.cpu().numpy()
        row = []
        for k, (st, tone_hz) in enumerate(zip(int_st, (700.0, 1800.0))):
            left = out.left[k].cpu().numpy()
            left = left[len(left) // 3:]
            sp = np.abs(np.fft.rfft(left * np.hanning(len(left))))
            tone = float(np.fft.rfftfreq(len(left), 1 / cfg.audio_fs)[
                sp.argmax()])
            ev = decode(RdsFramer, bits, nbits, k)
            row.append(dict(station=st["ps_name"], tone_hz=tone,
                            ps=ev.ps_name, pi=ev.pi))
            if not (abs(tone - tone_hz) < 10 and ev.ps_name == st["ps_name"]
                    and ev.pi == st["pi"]):
                fail(f"interferer [{path}, {dt}]: station {k} gave tone "
                     f"{tone:.1f} Hz, PS {ev.ps_name!r}, PI "
                     f"{ev.pi and hex(ev.pi)}")
        interferer[f"{path}_{dt}"] = row
        print(f"interferer [{path}, {dt}], 26 blocks through the graphed "
              f"bank: " + "; ".join(
                  f"{r['station']!r} tone {r['tone_hz']:.1f} Hz, PS "
                  f"{r['ps']!r}, PI {hex(r['pi'])}" for r in row))
    print(f"interferer: {len(rx_i.graphs)} graphs (the bank's run_segment "
          "and run_segment_demod) served every frontend and precision")
    if len(rx_i.graphs) != 2:
        fail("the interferer's bank did not replay its two graphs")
    del rx_i, ibank, fe_i, iw, qw

    # -- 6. the pipe CLI, in a subprocess, at its defaults --------------------
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")

    def run_cli(args_, capture, out_path, label=None, eager=False):
        """`python -m real_time_sdr_tpu_torch.cli ARGS < capture > out`:
        (stderr text, PCM bytes); fails on a non-zero exit. ``eager``: the
        CLI on the eager entries (``EAGER_CLI``)."""
        label = (label or " ".join(args_)) + (" (eager entries)" if eager
                                              else "")
        t0 = time.perf_counter()
        cmd = ([sys.executable, "-c", EAGER_CLI] if eager else
               [sys.executable, "-m", "real_time_sdr_tpu_torch.cli"])
        with open(capture, "rb") as fin, open(out_path, "wb") as fout:
            res = subprocess.run(
                [*cmd, *args_], stdin=fin, stdout=fout,
                stderr=subprocess.PIPE, text=True, env=env, cwd=root,
                timeout=300)
        if res.returncode != 0:
            fail(f"CLI {label} exited {res.returncode}:\n"
                 f"{res.stderr[-3000:]}")
        print(f"CLI {label}: {time.perf_counter() - t0:.1f} s "
              "wall, process start and set-up included")
        with open(out_path, "rb") as f:
            return res.stderr, f.read()

    def cli_stats(err):
        """(ms per block, x real time, p50 ms, p99 ms) from a --stats run's
        ``total`` and ``block latency`` lines."""
        lines_ = err.splitlines()
        tot = next(ln for ln in lines_ if ln.startswith("total:")).split()
        lat = next(ln for ln in lines_ if ln.startswith("block latency"))
        return (float(tot[4]), float(tot[6].rstrip("x")),
                float(lat.split("p50 ")[1].split()[0]),
                float(lat.split("p99 ")[1].split()[0]))

    with tempfile.TemporaryDirectory() as tmp:
        cap0 = os.path.join(tmp, "mode0.raw")
        # 48 synthesized blocks played 4 times: enough blocks that p99
        # latency is not just the first block's set-up
        iq_cli, _ = synth.station_iq(cfg, CLI_BLOCKS // 4, ps_name=PS,
                                     pi=PI, pty=PTY)
        np.tile(iq_cli, 4).tofile(cap0)
        err, pcm = run_cli(["0", "r", "--stats"], cap0,
                           os.path.join(tmp, "a.pcm"))
        lines = err.splitlines()
        want = CLI_BLOCKS * cfg.audio_block * 2 * 2
        for line in lines:
            if line.startswith(("total:", "block latency", "output:",
                                "RDS summary", "kernel launches")):
                print(f"  cli: {line}")
        got = json.loads(next(ln for ln in lines if ln.startswith(
            "kernel launches: "))[len("kernel launches: "):])
        count_child("cli", got, (frontend_fused.name, fir_bank.name,
                                 fir_decimate.name, pll_scan_kernel.name))
        if not (f"Program Service: {PS}" in lines and f"PI: {PI:x}" in lines
                and any(ln.startswith("PTY: ") for ln in lines)):
            fail("the CLI did not print the station's PS/PI/PTY")
        if len(pcm) != want:
            fail(f"the CLI wrote {len(pcm)} PCM bytes, not {want}")
        print(f"CLI on {card}: {CLI_BLOCKS} blocks, {len(pcm)} PCM bytes, "
              f"PS/PI/PTY decoded")
        # the CLI serves jit_run_segment_staged: its PCM is the eager
        # run_segment_staged's over the same one-block groups, in process
        rx_cli = Receiver(0, stereo=True, rds=True, device=dev)
        st_c = rx_cli.init_state(1)
        tail_c = st_c.frontend.iq_tail[0].cpu().numpy()
        raw_c = np.fromfile(cap0, np.uint8).reshape(CLI_BLOCKS, -1)
        pcm_ref = []
        for blk_c in raw_c:
            xp = torch.from_numpy(rx_cli.frontend.stage_segment(
                tail_c, blk_c)).to(dev)[None]
            st_c, o_c = rx_cli.run_segment_staged(st_c, xp, blk_c.shape[0])
            pcm_ref.append(stereo_pcm(o_c.left, o_c.right)[0].cpu().numpy()
                           .tobytes())
            tail_c = blk_c[blk_c.shape[0] - tail_c.shape[0]:]
        if b"".join(pcm_ref) != pcm:
            fail("the CLI's PCM differs from the eager run_segment_staged "
                 "run over the same groups")
        print(f"CLI PCM byte-identical to an in-process eager "
              f"run_segment_staged over the same {CLI_BLOCKS} one-block "
              "groups")
        del rx_cli, st_c, raw_c, pcm_ref
        err_e, pcm_e = run_cli(["0", "r", "--stats"], cap0,
                               os.path.join(tmp, "e0.pcm"), eager=True)
        if pcm_e != pcm:
            fail("the CLI on the eager entries wrote other PCM")
        eager_runs = [cli_stats(err_e)]
        # the two upload paths in the order 0, 0, 1 after the first run's
        # default (auto = 1): per-block time and latency of each run
        runs = {"1": [cli_stats(err)]}
        rds = [ln for ln in lines if ln.startswith(RDS_PREFIXES)]
        for k, staged in enumerate(("0", "0", "1")):
            err_k, pcm_k = run_cli(["0", "r", "--stats", "--staged", staged],
                                   cap0, os.path.join(tmp, f"s{k}.pcm"))
            if pcm_k != pcm:
                fail(f"--staged {staged} PCM differs from the first run's")
            if [ln for ln in err_k.splitlines()
                    if ln.startswith(RDS_PREFIXES)] != rds:
                fail(f"--staged {staged} RDS lines differ from the first "
                     "run's")
            runs.setdefault(staged, []).append(cli_stats(err_k))
        err_e, pcm_e = run_cli(["0", "r", "--stats"], cap0,
                               os.path.join(tmp, "e1.pcm"), eager=True)
        if pcm_e != pcm:
            fail("the CLI on the eager entries wrote other PCM")
        eager_runs.append(cli_stats(err_e))
        runs["1 (eager entries)"] = eager_runs
        for staged, rs in runs.items():
            print(f"CLI --staged {staged} on {card}: "
                  + "; ".join(f"{r[0]:.2f} ms/block, {r[1]:.1f}x real time, "
                              f"p50 {r[2]:.1f} ms, p99 {r[3]:.1f} ms"
                              for r in rs))
        graph_stats["cli"] = {k: [dict(ms_per_block=r[0], x_real_time=r[1],
                                       p50_ms=r[2], p99_ms=r[3]) for r in v]
                              for k, v in runs.items()}
        print(f"CLI --staged 0 and 1 (1 serves run_segment_staged): PCM "
              f"byte-identical, {len(rds)} RDS lines equal")
        # a --checkpoint pair over the two halves of the capture (staged):
        # the resumed run's host tail comes from the saved state, so the
        # joined PCM is the uninterrupted run's
        half = os.path.getsize(cap0) // 2
        raw0 = np.fromfile(cap0, np.uint8)
        ck = os.path.join(tmp, "ck")
        joined = b""
        for k, part in enumerate((raw0[:half], raw0[half:])):
            part_path = os.path.join(tmp, f"part{k}.raw")
            part.tofile(part_path)
            err_k, pcm_k = run_cli(["0", "r", "--staged", "1",
                                    "--checkpoint", ck], part_path,
                                   os.path.join(tmp, f"ck{k}.pcm"))
            joined += pcm_k
        if f"resumed state from {ck}" not in err_k.splitlines():
            fail("the CLI did not resume its checkpoint")
        if joined != pcm:
            fail("the staged --checkpoint pair's joined PCM differs from "
                 "the uninterrupted run's")
        print(f"CLI --staged 1 --checkpoint, {CLI_BLOCKS // 2} blocks then "
              f"the rest: joined PCM byte-identical to the uninterrupted "
              f"run's")
        cfg2 = Receiver(2, device=dev).cfg
        cap2 = os.path.join(tmp, "mode2.raw")
        synth.station_iq(cfg2, 40, ps_name=PS, pi=PI, pty=PTY)[0].tofile(cap2)
        err2, pcm2 = run_cli(["2", "r", "--pll-tier", "1"], cap2,
                             os.path.join(tmp, "c.pcm"))
        if f"Program Service: {PS}" not in err2.splitlines():
            fail("the mode-2 tier-1 CLI run did not decode PS")
        if len(pcm2) != 40 * cfg2.audio_block * 2 * 2:
            fail("the mode-2 CLI run wrote the wrong PCM byte count")
        print("CLI 2 r --pll-tier 1: PS decoded")

    # -- 7. the wideband CLI at full width, in subprocesses -------------------
    wb_blocks = BLOCKS * SEGMENTS
    n_pcm = wb_blocks * cfg.audio_block * 2 * 2     # bytes per station file
    wb_args = ["0", "r", "--stations=" + ",".join(map(str, offs)),
               "--wide-fs", str(wide_fs), "--segment", str(BLOCKS), "--stats"]
    real = {offs.index(st["offset_hz"]): st["ps_name"] for st in stations}

    def run_wb(label, extra, capture, outdir, eager=False):
        """One wideband CLI run: (stderr lines, [PCM bytes per station])."""
        err, _ = run_cli(wb_args + ["--output-dir", outdir] + extra, capture,
                         outdir + ".stdout",
                         label=f"0 r --stations=<{WB_STATIONS} offsets> "
                         f"--wide-fs {wide_fs} --segment {BLOCKS} --stats "
                         + label, eager=eager)
        pcm = []
        for k in range(WB_STATIONS):
            with open(os.path.join(outdir, f"station_{k}.pcm"), "rb") as f:
                pcm.append(f.read())
        lines_ = err.splitlines()
        # the per-segment times: the first segment holds the process's
        # set-up (CUDA context, library loads), the later ones are warm
        print("  cli segments: " + "; ".join(
            ln.split(": ", 1)[1] for ln in lines_
            if ln.startswith("block ")))
        return lines_, pcm

    def wb_launches(lines_):
        return json.loads(next(ln for ln in lines_ if ln.startswith(
            "kernel launches: "))[len("kernel launches: "):])

    with tempfile.TemporaryDirectory() as tmp:
        cap = os.path.join(tmp, "wide.raw")
        raw.tofile(cap)
        lines, pcm_a = run_wb("", [], cap, os.path.join(tmp, "a"))
        for line in lines:
            if line.startswith(("wideband frontend", "total:", "channelized",
                                "kernel launches")):
                print(f"  cli: {line}")
        count_child("cli_wideband", wb_launches(lines),
                    (fir_bank.name, fir_decimate.name, pll_scan_kernel.name))
        for k, ps_name in real.items():
            if f"ch{k} ps: {ps_name}" not in lines:
                fail(f"the wideband CLI did not print station {k}'s PS")
        if any(len(p) != n_pcm for p in pcm_a):
            fail(f"the wideband CLI's PCM files are not {n_pcm} bytes each: "
                 f"{sorted(set(map(len, pcm_a)))}")
        if lines[-1] != (f"channelized {WB_STATIONS} stations x {wb_blocks} "
                         "blocks"):
            fail(f"the wideband CLI ended with {lines[-1]!r}")
        tot = next(ln for ln in lines if ln.startswith("total:")).split()
        print(f"wideband CLI on {card}: {WB_STATIONS} stations x {wb_blocks} "
              f"blocks, PS of stations {sorted(real)} decoded, "
              f"{WB_STATIONS} PCM files of {n_pcm} bytes; {tot[4]} ms per "
              f"block, {tot[6]} real time on the {wide_fs / 1e6:g} MS/s "
              "capture over all 3 segments, the first with the process's "
              "set-up (tier 1, segments of 12, pinned upload, one segment "
              "in flight)")

        lines_b, pcm_b = run_wb("--pipeline 4", ["--pipeline", "4"], cap,
                                os.path.join(tmp, "b"))
        if pcm_b != pcm_a:
            fail("--pipeline 4 PCM differs from the first run's")
        tot_b = next(ln for ln in lines_b if ln.startswith("total:")).split()
        print(f"wideband CLI --pipeline 4: PCM byte-identical; {tot_b[4]} ms "
              f"per block, {tot_b[6]} real time")
        # on the bank's eager entry (EAGER_CLI), then graphed again: the
        # same PCM; each run's segment times
        lines_e, pcm_e = run_wb("", [], cap, os.path.join(tmp, "e"),
                                eager=True)
        if pcm_e != pcm_a:
            fail("the wideband CLI on the eager entry wrote other PCM")
        lines_g, pcm_g = run_wb("(again)", [], cap, os.path.join(tmp, "g"))
        if pcm_g != pcm_a:
            fail("the wideband CLI's second graphed run wrote other PCM")
        wb_runs = {}
        for form, lines_k in (("graphed", lines), ("eager", lines_e),
                              ("graphed", lines_g)):
            segs_ms = sorted(float(ln.split(": ")[1].split()[0])
                             for ln in lines_k if ln.startswith("block "))
            tot_k = next(ln for ln in lines_k
                         if ln.startswith("total:")).split()
            wb_runs.setdefault(form, []).append(dict(
                ms_per_block=float(tot_k[4]),
                x_real_time=float(tot_k[6].rstrip("x")),
                segment_p50_ms=segs_ms[len(segs_ms) // 2],
                segment_p99_ms=segs_ms[min(len(segs_ms) - 1,
                                           int(len(segs_ms) * 0.99))]))
        graph_stats["cli_wideband"] = wb_runs
        print(f"wideband CLI, graphed and eager entries in turns (graphed, "
              f"eager, graphed), PCM byte-identical: " + "; ".join(
                  f"{form} {r['ms_per_block']:.2f} ms per block, "
                  f"{r['x_real_time']:.1f}x real time, segment p50 "
                  f"{r['segment_p50_ms']:.1f} ms, p99 "
                  f"{r['segment_p99_ms']:.1f} ms"
                  for form, rs in wb_runs.items() for r in rs)
              + f"; on {card}")

        lines_f, pcm_f = run_wb("--wb-fir bf16", ["--wb-fir", "bf16"], cap,
                                os.path.join(tmp, "f"))
        for k, ps_name in real.items():
            if f"ch{k} ps: {ps_name}" not in lines_f:
                fail(f"the --wb-fir bf16 CLI did not print station {k}'s PS")
        if any(len(p) != n_pcm for p in pcm_f):
            fail("the --wb-fir bf16 CLI's PCM files are not "
                 f"{n_pcm} bytes each")
        pcm_snr = [snr_db(*(torch.from_numpy(np.frombuffer(
            p, "<i2").astype(np.float64)) for p in (pcm_a[k], pcm_f[k])))
            for k in sorted(real)]
        tot_f = next(ln for ln in lines_f if ln.startswith("total:")).split()
        print(f"wideband CLI --wb-fir bf16 on {card}: PS of stations "
              f"{sorted(real)} decoded, {WB_STATIONS} PCM files of {n_pcm} "
              f"bytes, the real stations' PCM against the f32 run's "
              + ", ".join(f"{v:.1f}" for v in pcm_snr) + f" dB; "
              f"{tot_f[4]} ms per block, {tot_f[6]} real time (f32 run: "
              f"{tot[4]} ms, {tot[6]})")

        # retune station 0 (an empty slot) onto slot 32's transmitter at
        # segment 1. PS needs ~30 blocks from a cold framer, so this run
        # plays the capture twice; the other 63 stations' first 36 blocks
        # must not change by a byte
        cap2 = os.path.join(tmp, "wide_twice.raw")
        np.tile(raw, 2).tofile(cap2)
        lines_c, pcm_c = run_wb(f"--retune 1:0:{offs[32]} (capture twice)",
                                ["--retune", f"1:0:{offs[32]}"], cap2,
                                os.path.join(tmp, "c"))
        mark = f"retuned station 0 -> {offs[32]} Hz at segment 1"
        if mark not in lines_c:
            fail("the wideband CLI did not print its retune line")
        if f"ch0 ps: {real[32]}" not in lines_c[lines_c.index(mark):]:
            fail("station 0 did not decode slot 32's PS after the retune")
        if f"ch0 ps: {real[32]}" in lines_c[:lines_c.index(mark)]:
            fail("station 0 printed slot 32's PS before the retune")
        if any(pcm_c[k][:n_pcm] != pcm_a[k] or len(pcm_c[k]) != 2 * n_pcm
               for k in range(1, WB_STATIONS)):
            fail("--retune of station 0 changed another station's PCM")
        print(f"wideband CLI --retune 1:0:{offs[32]}: station 0 prints "
              f"{real[32]!r} after segment 1; the other "
              f"{WB_STATIONS - 1} PCM files byte-identical over the first "
              f"{wb_blocks} blocks")

        # checkpoint: 18 blocks, then the rest. The segment boundaries differ
        # from the first run's (12 + 6 | 12 + 6 against 12 + 12 + 12), so
        # f32 rounding differs: the three real stations must agree within 1
        # LSB; an empty slot's audio is the discriminator of a zero signal,
        # which no rounding bound holds
        half = raw.shape[0] // 2
        cap_1, cap_2 = (os.path.join(tmp, f"half{k}.raw") for k in (1, 2))
        raw[:half].tofile(cap_1)
        raw[half:].tofile(cap_2)
        ck = os.path.join(tmp, "ck")
        lines_d1, pcm_d1 = run_wb("--checkpoint (first 18 blocks)",
                                  ["--checkpoint", ck], cap_1,
                                  os.path.join(tmp, "d1"))
        lines_d2, pcm_d2 = run_wb("--checkpoint (the rest)",
                                  ["--checkpoint", ck], cap_2,
                                  os.path.join(tmp, "d2"))
        if not (f"saved state to {ck}" in lines_d1
                and f"resumed state from {ck}" in lines_d2
                and any(ln.startswith(f"resumed {WB_STATIONS} RDS framers")
                        for ln in lines_d2)):
            fail("the wideband CLI did not save and resume its checkpoint")
        joined = [a + b for a, b in zip(pcm_d1, pcm_d2)]
        if any(len(p) != n_pcm for p in joined):
            fail("the checkpointed halves do not join to the full length")
        worst = 0
        for k in real:
            a, b = (np.frombuffer(p, "<i2").astype(np.int32)
                    for p in (pcm_a[k], joined[k]))
            worst = max(worst, int(np.abs(a - b).max()))
        same = sum(a == b for a, b in zip(pcm_a, joined))
        for k, ps_name in real.items():
            if f"ch{k} ps: {ps_name}" not in lines_d1 + lines_d2:
                fail(f"station {k}'s PS was not printed across the "
                     "checkpoint")
        print(f"wideband CLI --checkpoint, 18 blocks then the rest: the "
              f"real stations' joined PCM within {worst} LSB of the first "
              f"run's, {same}/{WB_STATIONS} files byte-identical, PS of "
              f"{sorted(real)} printed")
        if worst > 1:
            fail(f"the checkpointed run differs by {worst} LSB")

    # -- 8. parallel paths at full width (mode 0, type r) ---------------------
    # 8-. run_segment_grouped: phase 4's 32 channels as 4 sub-batches of 8
    # in one graph, against its eager form (bit for bit) and against
    # run_segment on the whole batch: the channels never interact, but a
    # reduction's split over the rows may follow the batch, so the audio is
    # held to 100 dB and the RDS bits equal, and bit-identity is printed
    gbank = ChannelBank(rx, CH)
    gsegs = [torch.from_numpy(sg).to(dev) for sg in segs]
    g0 = rx.init_state(CH)
    grouped = graph_check(
        "grouped", lambda st, x: grouped_step(rx, 8, st, x),
        lambda st, x: gbank.run_segment_grouped(st, x, 8),
        [(x,) for x in gsegs], g0,
        (frontend_fused.name, fir_bank.name, fir_decimate.name),
        ("tiled", "general"))
    st_w, whole = g0, []
    for x in gsegs:
        st_w, o_w = gbank.run_segment(st_w, x)
        whole.append((st_w, o_w))
    same = all(torch.equal(a, b) for w, g in zip(whole, grouped)
               for a, b in zip(leaves(w), leaves(g)))
    g_snr = min(snr_db(getattr(w[1], rail)[c], getattr(g[1], rail)[c])
                for w, g in zip(whole, grouped) for rail in ("left", "right")
                for c in range(CH))
    g_bits = all(torch.equal(w[1].rds_bits, g[1].rds_bits)
                 and torch.equal(w[1].rds_nbits, g[1].rds_nbits)
                 for w, g in zip(whole, grouped))
    print(f"run_segment_grouped ({CH} ch as {CH // 8} groups of 8, "
          f"{SEGMENTS} chained segments) against run_segment: bit-identical "
          f"{same}, worst channel audio "
          f"{'identical' if g_snr > 1000 else f'{g_snr:.1f} dB'}, RDS bits "
          f"equal {g_bits}")
    if not (g_snr > 100.0 and g_bits):
        fail("run_segment_grouped disagrees with run_segment")
    graph_stats["grouped"].update(bit_identical_to_run_segment=same,
                                  worst_audio_snr_db=min(g_snr, 1e9))
    del gbank, gsegs, grouped, whole, segs
    blk = 2 * cfg.block_size_iq
    ts_blocks, ts_shards = 2 * CLI_BLOCKS, 32
    # one 384-block capture, 11.76 s of radio, synthesized whole so that no
    # two shards hold the same bytes and a join in the wrong order shows
    long_np, _ = synth.station_iq(cfg, ts_blocks, ps_name=PS, pi=PI, pty=PTY)
    long_iq = torch.from_numpy(long_np.reshape(ts_blocks, blk)).to(dev)
    radio_ts = ts_blocks * cfg.block_size_iq / cfg.rf_fs

    def timed(fn):
        """(result, wall ms) of fn, the device's work included."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    def worst_block(ref, got):
        """Least per-block SNR of (B, n) audio against its reference."""
        return min(snr_db(ref[b], got[b]) for b in range(ref.shape[0]))

    def decode_stream(bits, nbits):
        fr = RdsFramer()
        bits, nbits = bits.cpu().numpy(), nbits.cpu().numpy()
        for b in range(bits.shape[0]):
            fr.feed(bits[b, :nbits[b]])
        return fr.events

    def sharded_eager(rx_, x, shards, exact=None):
        """The eager form of time_sharded_run on this card."""
        return map_state(_sharded_run(rx_, x[None], shards, 1, exact,
                                      [[rx_.device]], None),
                         lambda t: t[0])

    def sharded_graph_check(path, eager_f, jit_f, x, needed, reps=4):
        """A time-sharded run (no state) through graph_check and
        graph_times; returns the graphed output."""
        none = torch.zeros((), device=dev)
        out = graph_check(path, lambda st, x_: (st, eager_f(x_)),
                          lambda st, x_: (st, jit_f(x_)), [(x,)], none,
                          needed, ("tiled", "general"))[0][1]
        graph_times(path, lambda st: (eager_f(x), st)[1],
                    lambda st: (jit_f(x), st)[1], none, reps)
        return out

    # 8a. exact time sharding of one station (tier 3): the shards are the
    # 32 rows of one batch, against the sequential receiver on one row;
    # graph_check captures the run's graph, the runs after it replay it
    full = (frontend_fused.name, fir_bank.name, fir_decimate.name)
    sharded_graph_check(
        "time_sharded", lambda x: sharded_eager(rx, x, ts_shards),
        lambda x: time_sharded_run(rx, x, ts_shards), long_iq, full)
    reset_counts()
    ts_out, ts_first_ms = timed(lambda: time_sharded_run(
        rx, long_iq, ts_shards, overlap=1))
    count_path("time_sharded", (frontend_fused.name, fir_bank.name,
                                fir_decimate.name), ("tiled", "general"))
    ts_warm = [timed(lambda: time_sharded_run(rx, long_iq, ts_shards))[1]
               for _ in range(3)]
    (_, seq_out), seq_ms = timed(lambda: rx.run_blocks(rx.init_state(1),
                                                       long_iq[None]))
    ts_ms = statistics.median(ts_warm)
    worst = min(worst_block(seq_out.left[0], ts_out.left),
                worst_block(seq_out.right[0], ts_out.right))
    same_bits = (torch.equal(ts_out.rds_bits, seq_out.rds_bits[0])
                 and torch.equal(ts_out.rds_nbits, seq_out.rds_nbits[0]))
    ev = decode_stream(ts_out.rds_bits, ts_out.rds_nbits)
    print(f"time sharding, exact (tier 3): {ts_blocks} blocks "
          f"({long_iq.numel() / 1e6:.1f} MB u8, {radio_ts:.2f} s of radio) "
          f"as {ts_shards} shards x {ts_blocks // ts_shards} blocks, overlap "
          f"1: graph replays {ts_first_ms:.1f}, "
          f"{', '.join(f'{t:.1f}' for t in ts_warm)} ms (median "
          f"{radio_ts / (ts_ms / 1e3):.1f}x real time); sequential "
          f"run_blocks on one row {seq_ms:.1f} ms "
          f"({radio_ts / (seq_ms / 1e3):.1f}x real time); host clock, the "
          f"capture already on the card; on {card}")
    print(f"time sharding against sequential: worst block {worst:.1f} dB "
          f"over {ts_blocks} blocks x 2 rails, RDS bits equal {same_bits} "
          f"({int(seq_out.rds_nbits.sum())} bits), PS {ev.ps_name!r}, PI "
          f"{ev.pi and hex(ev.pi)}")
    if not (worst > 100.0 and same_bits and ev.ps_name == PS
            and ev.pi == PI):
        fail("exact time sharding disagrees with the sequential receiver")
    del ts_out, seq_out

    # the tracked symbol timing: the global decode is a loop over the 384
    # blocks, captured as 384 steps (the first graphed call's time)
    rx_t = Receiver(0, stereo=True, rds=True, pll_tier=3,
                    rds_timing="tracked", device=dev)
    tr_out = sharded_graph_check(
        "time_sharded_tracked", lambda x: sharded_eager(rx_t, x, ts_shards),
        lambda x: time_sharded_run(rx_t, x, ts_shards), long_iq, full)
    ev = decode_stream(tr_out.rds_bits, tr_out.rds_nbits)
    print(f"time sharding, exact, tracked timing: PS {ev.ps_name!r}, PI "
          f"{ev.pi and hex(ev.pi)}")
    if not (ev.ps_name == PS and ev.pi == PI):
        fail("the tracked time-sharded run did not decode PS/PI")
    del rx_t, tr_out

    # 8b. approximate time sharding at the default tier 1: pll_scan at 32
    # rows; against the sequential tier-1 run of the first 4 shards' blocks.
    # Every shard's slicer re-aligns after its warm-up gate, so a 12-block
    # shard gives ~0.2 s of bits at a time: PI (in every group) decodes, a
    # whole PS name (4 groups of one kind) only from longer shards, here 4
    per = ts_blocks // ts_shards
    sharded_graph_check(
        "time_sharded_tier1", lambda x: sharded_eager(rx1, x, ts_shards),
        lambda x: time_sharded_run(rx1, x, ts_shards), long_iq,
        full + (pll_scan_kernel.name,))
    reset_counts()
    ap_out, ap_ms = timed(lambda: time_sharded_run(rx1, long_iq, ts_shards))
    count_path("time_sharded_tier1",
               (frontend_fused.name, fir_bank.name, fir_decimate.name,
                pll_scan_kernel.name), ("tiled", "general"))
    if by_path["time_sharded_tier1"][pll_scan_kernel.name] != 2 * (per + 1):
        fail("pll_scan did not launch twice per step of the 32-row batch")
    (_, seq1), seq1_ms = timed(lambda: rx1.run_blocks(
        rx1.init_state(1), long_iq[None, :4 * per]))
    steady = min(snr_db(getattr(seq1, rail)[0, k * per + j],
                        getattr(ap_out, rail)[k * per + j])
                 for rail in ("left", "right") for k in range(4)
                 for j in range(1, per))
    head_same = torch.equal(ap_out.left[0], seq1.left[0, 0])
    ev = decode_stream(ap_out.rds_bits, ap_out.rds_nbits)
    ap4_out, ap4_ms = timed(lambda: time_sharded_run(rx1, long_iq, 4))
    ev4 = decode_stream(ap4_out.rds_bits, ap4_out.rds_nbits)
    print(f"time sharding, approximate (tier 1): {ts_shards} shards, "
          f"{ap_ms:.1f} ms ({radio_ts / (ap_ms / 1e3):.1f}x real time; "
          f"sequential tier 1 on the first {4 * per} blocks {seq1_ms:.1f} "
          f"ms); blocks after each shard's first, shards 0-3: worst "
          f"{steady:.1f} dB; shard 0's first block identical {head_same}; "
          f"PI {ev.pi and hex(ev.pi)}, PS {ev.ps_name!r}, groups "
          f"{ev.groups_decoded}; as 4 shards x {ts_blocks // 4} blocks "
          f"{ap4_ms:.1f} ms: PS {ev4.ps_name!r}, PI "
          f"{ev4.pi and hex(ev4.pi)}; on {card}")
    if not (steady > 25.0 and head_same and ev.pi == PI
            and ev4.ps_name == PS and ev4.pi == PI):
        fail("approximate time sharding disagrees with the sequential "
             "tier-1 receiver")
    del ap_out, ap4_out, seq1

    # 8c. joint channel x time: 4 shifted channels x 96 blocks as 8 shards
    jt_ch, jt_blocks, jt_shards = 4, CLI_BLOCKS // 2, 8
    pairs = long_np[:jt_blocks * blk].reshape(-1, 2)
    shifts = [0] + [int(v) for v in np.random.default_rng(5).integers(
        1, len(pairs), jt_ch - 1)]
    joint = torch.from_numpy(np.stack([
        np.roll(pairs, -v, axis=0).reshape(jt_blocks, blk)
        for v in shifts])).to(dev)
    sharded_graph_check(
        "time_sharded_bank",
        lambda x: _sharded_run(rx, x, jt_shards, 1, True, [[rx.device]],
                               None),
        lambda x: time_sharded_run_bank(rx, x, jt_shards), joint, full)
    reset_counts()
    jt_out, jt_ms = timed(lambda: time_sharded_run_bank(rx, joint,
                                                        jt_shards))
    count_path("time_sharded_bank", (frontend_fused.name, fir_bank.name,
                                     fir_decimate.name),
               ("tiled", "general"))
    (_, seq_j), seqj_ms = timed(lambda: rx.run_blocks(rx.init_state(jt_ch),
                                                      joint))
    worst = min(worst_block(getattr(seq_j, rail)[c], getattr(jt_out, rail)[c])
                for rail in ("left", "right") for c in range(jt_ch))
    same_bits = (torch.equal(jt_out.rds_bits, seq_j.rds_bits)
                 and torch.equal(jt_out.rds_nbits, seq_j.rds_nbits))
    names = [decode_stream(jt_out.rds_bits[c], jt_out.rds_nbits[c]).ps_name
             for c in range(jt_ch)]
    print(f"joint channel x time: {jt_ch} ch x {jt_blocks} blocks as "
          f"{jt_shards} shards ({jt_ch * jt_shards} rows): {jt_ms:.1f} ms, "
          f"run_blocks on the {jt_ch} rows {seqj_ms:.1f} ms; worst block "
          f"{worst:.1f} dB, RDS bits equal {same_bits}, PS {names}; on "
          f"{card}")
    if not (worst > 100.0 and same_bits and names[0] == PS):
        fail("joint channel x time sharding disagrees with run_blocks")
    del jt_out, seq_j, joint, long_iq, long_np, pairs

    # 8d. sharded wideband: the 64-station capture over two replicas on
    # this one card (32 stations each), against phase 5's unsharded runs
    two = [dev, dev]

    def run_sharded(path, sw, needed):
        reset_counts()
        fs_, bs = sw.init_state()
        outs_s, seg_t = [], []
        for seg in wsegs:
            (fs_, bs, out), ms_ = timed(lambda: sw.step(
                fs_, bs, *u8_to_rails(torch.from_numpy(seg).to(dev))))
            outs_s.append(gather(out, "cpu"))
            seg_t.append(ms_)
        count_path(path, needed, ("tiled",))
        left, right = (torch.cat([getattr(o, rail) for o in outs_s], -1)
                       for rail in ("left", "right"))
        bits = torch.cat([o.rds_bits for o in outs_s], 1)
        nbits = torch.cat([o.rds_nbits for o in outs_s], 1)
        return left, right, bits, nbits, seg_t

    def check_sharded(path, ref, left, right, bits, nbits, seg_t):
        real_snr = min(snr_db(ref[rail][k], got[k])
                       for rail, got in (("left", left), ("right", right))
                       for k in WB_SLOTS)
        # an empty slot's demod is the discriminator of a zero signal,
        # which no rounding bound holds: the real stations are held equal
        real = list(WB_SLOTS)
        same = (torch.equal(bits[real], ref["bits"][real])
                and torch.equal(nbits[real], ref["nbits"][real]))
        n_same = sum(torch.equal(bits[k], ref["bits"][k])
                     for k in range(WB_STATIONS))
        names = {k: decode(RdsFramer, bits.numpy(), nbits.numpy(), k).ps_name
                 for k in WB_SLOTS}
        agree = ("identical" if real_snr > 1000.0
                 else f"worst {real_snr:.1f} dB")
        print(f"{path}: {WB_STATIONS} stations over {len(two)} replicas on "
              f"one card, segments {', '.join(f'{t:.2f}' for t in seg_t)} "
              f"ms (host clock, H2D and the gather to the host included); "
              f"real stations against the unsharded run: "
              f"{agree}, their RDS bits equal {same} (bits equal on "
              f"{n_same}/{WB_STATIONS} slots); PS {names}; on {card}")
        if not (real_snr > 70.0 and same and all(
                names[offs.index(st["offset_hz"])] == st["ps_name"]
                for st in stations)):
            fail(f"{path} disagrees with the unsharded wideband path")

    def sharded_steps(path, sw, needed):
        """Each shard's step graphed (one graph per shard, the first
        segment's calls capturing) against its eager form: phase 5's
        segments chained from a fresh state (a library fold product
        inside: held to its gates where a leaf differs), then the numbers
        of both forms."""
        def eager_sw(st, seg):
            i, q = u8_to_rails(seg)
            fs_, bs_, out_ = zip(*(
                sw._step_one(k, st[0][k], st[1][k], i, q)
                for k in range(len(sw.devices))))
            return (fs_, bs_), out_

        def jit_sw(st, seg):
            fs_, bs_, out_ = sw.step(st[0], st[1], *u8_to_rails(seg))
            return (fs_, bs_), out_
        dsegs = [torch.from_numpy(sg).to(dev) for sg in wsegs]
        s0 = sw.init_state()
        graph_check(path, eager_sw, jit_sw, [(d,) for d in dsegs], s0,
                    needed, ("tiled",), library=True)
        graph_times(path, lambda st: eager_sw(st, dsegs[0])[0],
                    lambda st: jit_sw(st, dsegs[0])[0], s0)

    sw2 = ShardedWideband(ch, rx, devices=two)
    needed = (chan_epilogue.name, frontend_fused.name, fir_bank.name,
              fir_decimate.name)
    sharded_steps("sharded_two_stage", sw2, needed)
    res = run_sharded("sharded_two_stage", sw2, needed)
    check_sharded("sharded_two_stage", wb_ref["two_stage"], *res)
    if by_path["sharded_two_stage"][chan_epilogue.name] != 2 * SEGMENTS:
        fail("chan_epilogue did not launch once per shard and segment")
    sf2 = ShardedFusedWideband(wf, rx, devices=two)
    sharded_steps("sharded_fused", sf2, (fir_bank.name, fir_decimate.name))
    res = run_sharded("sharded_fused", sf2,
                      (fir_bank.name, fir_decimate.name))
    check_sharded("sharded_fused", wb_ref["fused"], *res)
    n_graphs = len(rx.graphs)
    # retune station 63 (an empty slot of the second shard) onto slot 32's
    # transmitter: only the second shard's weights change, station 63 then
    # decodes slot 32's PS and the first shard's stations do not move
    w_before = [sh.w.clone() for sh in sf2.shards]
    sf2.retune(WB_STATIONS - 1, offs[32])
    moved = [not torch.equal(sh.w, w) for sh, w in zip(sf2.shards, w_before)]
    left_r, _, bits_r, nbits_r, _ = run_sharded(
        "sharded_fused_retuned", sf2, (fir_bank.name, fir_decimate.name))
    ps63 = decode(RdsFramer, bits_r.numpy(), nbits_r.numpy(),
                  WB_STATIONS - 1).ps_name
    first_same = (torch.equal(left_r[:32], res[0][:32])
                  and torch.equal(bits_r[:32], res[2][:32]))
    print(f"sharded_fused retune of station {WB_STATIONS - 1} -> "
          f"{offs[32]} Hz: shards rewritten {moved}, station "
          f"{WB_STATIONS - 1} PS {ps63!r}, the first shard's 32 stations "
          f"unchanged {first_same}; the retuned segments replayed the "
          f"shards' graphs (graphs before {n_graphs}, after "
          f"{len(rx.graphs)})")
    if not (moved == [False, True] and first_same
            and ps63 == stations[1]["ps_name"]
            and len(rx.graphs) == n_graphs):
        fail("the sharded retune did not reach its shard and no other")
    del wb_ref, res, sw2, sf2, ch, wf, wsegs, raw

    # -- 9. the diagnostic entry point at full width -------------------------
    t9 = time.perf_counter()
    # 9a. the alternative RDS receiver on the 32-block +200 ppm station:
    # the device half (the frontend and _device_chain, one graph) against
    # its eager form (graph_check captures it), then decodes replaying it:
    # the frontend, the baseband bank and the two loops launch once each
    alt_x = torch.from_numpy(alt_iq).to(dev)[None]
    none = torch.zeros((), device=dev)
    graph_check("alt_decode", lambda st, x: (st, alt_rx._device_half(x)),
                lambda st, x: (st, alt_rx.graphs(alt_rx._device_half,
                                                 ("decode",), x)),
                [(alt_x,)], none,
                (frontend_fused.name, fir_bank.name, mm_timing_kernel.name,
                 costas_kernel.name), ("general",))
    reset_counts()
    (alt_dec, alt_diag), alt_ms = timed(lambda: alt_rx.decode(alt_iq))
    count_path("alt_rds", (frontend_fused.name, fir_bank.name,
                           mm_timing_kernel.name, costas_kernel.name),
               ("general",))
    once = {k: by_path["alt_rds"][k] for k in (
        frontend_fused.name, fir_bank.name, mm_timing_kernel.name,
        costas_kernel.name)}
    if set(once.values()) != {1}:
        fail(f"the alternative receiver's kernels did not launch once each: "
             f"{once}")
    cpu_dec, cpu_diag = AltRdsReceiver(0, device="cpu").decode(alt_iq)
    alt_warm = [timed(lambda: alt_rx.decode(alt_iq))[1] for _ in range(5)]
    alt_radio = ALT_BLOCKS * cfg.block_size_iq / cfg.rf_fs
    f_track = float(np.median(alt_diag.freq_log[-200:]))
    f_true = 3 * 19_000.0 * ALT_PPM * 1e-6
    bits_same = np.array_equal(alt_diag.bits, cpu_diag.bits)
    print(f"alternative RDS receiver, {ALT_BLOCKS} blocks ({alt_radio:.3f} s "
          f"of radio), +{ALT_PPM:.0f} ppm pilot: PS {alt_dec.events.ps_name!r}"
          f", PI {alt_dec.events.pi and hex(alt_dec.events.pi)}, groups "
          f"{alt_dec.events.groups_decoded}, {len(alt_diag.symbols)} "
          f"symbols, Costas track {f_track:.2f} Hz (true {f_true:.2f}); bits "
          f"equal to the CPU run {bits_same} ({len(alt_diag.bits)} bits, "
          f"CPU PS {cpu_dec.events.ps_name!r}); one decode {alt_ms:.1f} "
          f"ms, warm {', '.join(f'{t:.1f}' for t in alt_warm)} ms (median "
          f"{statistics.median(alt_warm):.1f} ms, "
          f"{alt_radio / (statistics.median(alt_warm) / 1e3):.1f} s of radio "
          f"per wall second; host clock, the capture's upload and the final "
          f"fetch included); on {card}")
    if not (alt_dec.events.ps_name == ALT_PS and alt_dec.events.pi == ALT_PI
            and alt_dec.events.groups_decoded >= 5
            and abs(f_track - f_true) < 1.5 and bits_same):
        fail("the alternative RDS receiver did not decode the station as "
             "its CPU run does")
    alt_stats = dict(first_ms=alt_ms, warm_ms=alt_warm,
                     radio_s_per_wall_s=alt_radio / (
                         statistics.median(alt_warm) / 1e3),
                     host_split_ms={
                         form: alt_decode_split(torch, np, alt_rx, alt_iq,
                                                alt_diag.bits, form ==
                                                "graphed")
                         for form in ("eager", "graphed")})
    graph_times("alt_decode",
                lambda st: (alt_rx._decode(alt_iq, alt_rx._device_half),
                            st)[1],
                lambda st: (alt_rx.decode(alt_iq), st)[1], none)
    del alt_x, none
    with tempfile.TemporaryDirectory() as tmp_p:
        profile_segment(torch, card, args.profile or tmp_p, "alt_decode",
                        lambda: alt_rx.decode(alt_iq),
                        statistics.median(alt_warm), top=10)
    kernels[mm_timing_kernel.name]["alt_decode"] = alt_stats

    def viz_cmd(*args_):
        return [sys.executable, "-m", "real_time_sdr_tpu_torch.viz", *args_]

    with tempfile.TemporaryDirectory() as tmp9:
        sheet_dir, ber_dir = (os.path.join(tmp9, d) for d in ("sheet",
                                                              "ber"))
        # 9b/9c. the figure sheet (default 24 blocks, --alt --golden) and
        # the BER sweep, side by side
        t_sub = time.perf_counter()
        procs = {name: subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=root) for name, cmd in (
                ("sheet", viz_cmd("0", "--out", sheet_dir, "--alt",
                                  "--golden")),
                ("ber", viz_cmd("0", "--ber", "--blocks", "30", "--sigmas",
                                "0,0.08", "--out", ber_dir)))}
        # 9d. the live view beside a running CLI decode with --monitor
        cap9 = os.path.join(tmp9, "live.raw")
        iq_live, _ = synth.station_iq(cfg, 48, ps_name=PS, pi=PI, pty=PTY)
        iq_live.tofile(cap9)
        snap = os.path.join(tmp9, "snap.npz")
        live_dir = os.path.join(tmp9, "live")
        viewer = subprocess.Popen(
            viz_cmd("0", "--live", snap, "--frames", "2", "--refresh",
                    "0.05", "--live-timeout", "30", "--out", live_dir),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=root)
        err_cli, _ = run_cli(["0", "r", "--monitor", snap,
                              "--monitor-every", "4"], cap9,
                             os.path.join(tmp9, "live.pcm"),
                             "0 r --monitor (48 blocks)")
        outs9 = {}
        for name, proc in list(procs.items()) + [("live", viewer)]:
            try:
                outs9[name] = proc.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                for p_ in list(procs.values()) + [viewer]:
                    p_.kill()
                    p_.wait()
                fail(f"viz {name} did not finish in 300 s")
            if proc.returncode != 0:
                fail(f"viz {name} exited {proc.returncode}:\n"
                     f"{outs9[name][1][-3000:]}")
        sub_s = time.perf_counter() - t_sub
        out_s, err_s = outs9["sheet"]
        for name in ("psd_stages.png", "waterfall.png", "rds_eye.png",
                     "rds_constellation.png", "rds_eye.gnuplot",
                     "rds_clean.dat", "psd_golden_overlay.png",
                     "alt_rds.png"):
            path = os.path.join(sheet_dir, name)
            if not (os.path.exists(path) and os.path.getsize(path) > 100):
                fail(f"the figure sheet did not write {name}")
        golden = {ln.split(":")[0][len("golden SNR "):]:
                  float(ln.split()[-2]) for ln in err_s.splitlines()
                  if ln.startswith("golden SNR ")}
        alt_line = [ln for ln in err_s.splitlines()
                    if ln.startswith("alt path:")]
        print(f"viz figure sheet (24 blocks, --alt --golden): "
              f"{len(out_s.splitlines())} files listed; {alt_line}; golden "
              f"SNR {golden} dB; the port's CPU run {GOLDEN_SNR_CPU}, the "
              f"JAX receiver {GOLDEN_SNR_JAX}")
        if not (alt_line and alt_line[0].startswith(
                "alt path: PS='VIZ-DEMO'")):
            fail("the figure sheet's alternative path did not decode PS")
        if sorted(golden) != sorted(GOLDEN_SNR_JAX) or any(
                golden[k] < GOLDEN_SNR_JAX[k] - 1.0 for k in golden):
            fail("a golden SNR line of the figure sheet is more than 1 dB "
                 "below the JAX receiver's")
        with open(os.path.join(ber_dir, "ber_curve.csv")) as f:
            rows9 = [ln.rstrip("\n").split(",") for ln in f]
        head9 = rows9[0]
        cells = [dict(zip(head9, r)) for r in rows9[1:]]
        for c in cells:
            print(f"  ber: sigma {c['sigma']} {c['timing']}: BER {c['ber']}, "
                  f"{c['bits']} bits, PS at span 2: matrix "
                  f"{c['matrix_c2_ps']}, sync-by-offset "
                  f"{c['syncbyoff_c2_ps']}")
        clean = [c for c in cells if float(c["sigma"]) == 0.0]
        if not (len(cells) == 4 and len(clean) == 2 and all(
                float(c["ber"]) == 0.0 and c["matrix_c2_ps"] == "1"
                and c["syncbyoff_c2_ps"] == "1" for c in clean)):
            fail("the BER sweep did not give 4 rows with BER 0 and PS at "
                 "sigma 0")
        frames = [ln for ln in outs9["live"][1].splitlines()
                  if ln.startswith("frame ")]
        live_png = os.path.join(live_dir, "live.png")
        print(f"viz --live beside `cli 0 r --monitor`: {len(frames)} "
              f"frame(s) ({frames[-1] if frames else None}); CLI PS line "
              f"{'Program Service: ' + PS in err_cli}")
        if not (frames and os.path.exists(live_png)
                and os.path.getsize(live_png) > 1000):
            fail("the live view rendered no frame")
        print(f"phase 9 subprocesses: {sub_s:.1f} s wall; phase 9 "
              f"{time.perf_counter() - t9:.1f} s")

    # -- 10. the walkthroughs (real_time_sdr_tpu_torch/examples/) ----------
    t10 = time.perf_counter()
    ff, fb, fd = frontend_fused.name, fir_bank.name, fir_decimate.name
    both = ("tiled", "general")
    with tempfile.TemporaryDirectory() as tmp10:
        fixtures = dict(
            mono_to_wav=mono_to_wav.fixture(),
            stereo_rds_events=stereo_rds_events.fixture(),
            wideband_multistation=wideband_multistation.fixture(),
            retune_station=retune_station.fixture(),
            time_sharded_offline=time_sharded_offline.fixture(),
            checkpoint_resume=checkpoint_resume.fixture())
        print(f"walkthrough fixtures synthesized in "
              f"{time.perf_counter() - t10:.1f} s")
        wav = {d: os.path.join(tmp10, f"mono_{d}.wav")
               for d in ("cuda", "cpu")}
        walks = {
            "mono_to_wav": (lambda d, x: mono_to_wav.run(
                x, wav[d.type], device=d), (ff, fd), ()),
            "stereo_rds_events": (lambda d, x: stereo_rds_events.run(
                x[0], sent=x[1], device=d), (ff, fb, fd), both),
            "wideband_multistation": (lambda d, x: wideband_multistation.run(
                x, device=d), (fb, fd), both),
            "retune_station": (lambda d, x: retune_station.run(
                x, device=d), (fb, fd), both),
            "time_sharded_offline": (lambda d, x: time_sharded_offline.run(
                x, device=d), (ff, fb, fd), both),
            "checkpoint_resume": (lambda d, x: checkpoint_resume.run(
                x, os.path.join(tmp10, "receiver.npz"), device=d),
                (ff, fb, fd), both)}

        def walk(name, device):
            """One walkthrough's run() on ``device``: its result and wall
            seconds; a failed gate fails the run."""
            call, _, _ = walks[name]
            t_ = time.perf_counter()
            try:
                res = call(torch.device(device), fixtures[name])
            except GateError as e:
                fail(f"walkthrough {name} on {device}: {e}")
            return res, time.perf_counter() - t_

        def shown(name, r):
            if name == "mono_to_wav":
                return (f"{r.audio.size} samples at {r.fs} Hz in the WAV, "
                        f"peak {np.abs(r.audio).max():.3f}")
            if name == "stereo_rds_events":
                ev = r.events
                return (f"PS {ev.ps_name!r}, PI {ev.pi and hex(ev.pi)}, PTY "
                        f"{ev.pty!r}, RT {ev.radiotext.rstrip()!r}, CT "
                        f"{ev.clock_utc}, AF {ev.alt_freqs_mhz}, TP "
                        f"{ev.traffic_program}: as sent; {len(r.log)} "
                        "events")
            if name == "wideband_multistation":
                return (f"{r.decoded}/{len(r.events)} stations' PS as sent "
                        f"({r.frontend})")
            if name == "retune_station":
                return (f"PS before {r.before}, after {r.after}; graphs "
                        f"{r.graphs_before} before the retune, "
                        f"{r.graphs_after} after; station 0 equal to the "
                        f"run with no retune {r.station0_equal}")
            if name == "time_sharded_offline":
                return (f"sharded vs sequential: audio {r.snr_db:.1f} dB, "
                        f"worst block {r.worst_block_db:.1f} dB (bound "
                        f"{time_sharded_offline.MIN_BLOCK_SNR_DB:.0f}), RDS "
                        f"bits identical {r.bits_equal}")
            return (f"split run == uninterrupted run: audio "
                    f"{r.audio_equal}, RDS bits {r.bits_equal} "
                    f"({r.nbytes}-byte checkpoint)")

        card_walks, walk_s = {}, {}
        for name, (_, needed, bodies) in walks.items():
            reset_counts()
            card_walks[name], walk_s[name] = walk(name, "cuda")
            count_path(f"example_{name}", needed, bodies)
            ran = {k: v for k, v in by_path[f"example_{name}"].items() if v}
            print(f"walkthrough {name} on the card: {walk_s[name]:.2f} s "
                  f"wall (fixture ready, first call included); "
                  f"{shown(name, card_walks[name])}; kernels launched {ran}")
        if not card_walks["retune_station"].graphs_before:
            fail("the retune walkthrough captured no graph on the card")
        # the card against the CPU on the same bytes
        mono_cpu, _ = walk("mono_to_wav", "cpu")
        st_cpu, _ = walk("stereo_rds_events", "cpu")
        mono_card, st_card = (card_walks["mono_to_wav"],
                              card_walks["stereo_rds_events"])
        s_mono = ex_snr_db(mono_cpu.audio, mono_card.audio)
        s_st = min(ex_snr_db(st_cpu.left, st_card.left),
                   ex_snr_db(st_cpu.right, st_card.right))
        same_events = st_cpu.log == st_card.log and st_cpu.events == \
            st_card.events
        print(f"walkthroughs, card against CPU on the same bytes: "
              f"mono_to_wav audio {s_mono:.1f} dB; stereo_rds_events audio "
              f"{s_st:.1f} dB (the worse rail), events identical "
              f"{same_events} ({len(st_card.log)} events)")
        if not (s_mono > 60.0 and s_st > 60.0 and same_events):
            fail("a walkthrough on the card disagrees with its CPU run")
        # the module entry, as a user starts it, in a directory of its own
        t_ = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m",
             "real_time_sdr_tpu_torch.examples.stereo_rds_events"],
            cwd=tmp10, env=env, capture_output=True, text=True, timeout=600)
        want = stereo_rds_events.summary(st_card)[0].strip()
        lines = proc.stdout.splitlines()
        print(f"python -m real_time_sdr_tpu_torch.examples.stereo_rds_events"
              f": exit {proc.returncode} in {time.perf_counter() - t_:.1f} s"
              f", {len(lines)} lines; summary line {want in lines}")
        if proc.returncode != 0 or want not in lines:
            fail(f"the stereo_rds_events module entry failed (exit "
                 f"{proc.returncode}):\n{proc.stderr[-3000:]}")
    print(f"phase 10 (walkthroughs) {time.perf_counter() - t10:.1f} s; "
          f"walls {json.dumps({k: round(v, 3) for k, v in walk_s.items()})}"
          f"; on {card}")

    # -- 11. the experiments (real_time_sdr_tpu_torch/experiments/) ---------
    phase_11(kernels)

    if "jax" in sys.modules:
        fail("jax was imported")
    print("graphs: " + json.dumps(graph_stats))
    kernels[fir_bank.name]["body_launches_by_path"] = bodies_by_path
    kernels[fir_decimate.name]["body_launches_by_path"] = fd_bodies_by_path
    rows = []
    for k in KERNELS:
        rows.append(dict(name=k.name, route="cuda", source=k.source,
                         replaces=k.replaces, launches=launches[k.name],
                         launches_by_path={p: v[k.name]
                                           for p, v in by_path.items()},
                         **kernels[k.name]))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
