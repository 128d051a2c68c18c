#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ka9q_sdr_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``ka9q_sdr_tpu_torch/csrc``
(one ``nvcc`` per source, all at once, with the IF-node helper
``cond.cu``) and holds each against its plain PyTorch version: the FM
forward fill (float, complex and conjugate-view values) and the hang AGC
bit for bit, the column Stockham FFT within 2e-6
for every Q from 1 to 16384 (and against numpy).  It times each at the
main path's shapes beside its bound (bytes over 3.35 TB/s), the AGC also
beside its chain floor (its step's three dependent instructions at 4
cycles each, at the SM clock nvidia-smi reports) and its walk's measured
cycles per sample, and the column FFT beside cuFFT.  Then it
drives the channel bank through its user entry points:

- the FM+PL bank (the path ``bench.py`` measures and ``apps/bankd.py``
  serves) at the 4096-channel 20 ms serving geometry and at the
  8192-channel long-block geometry: squelch, 1 kHz audio, 100 Hz PL tone,
  active-channel compaction, a card-against-CPU comparison;
- the CAM (PLL) bank at 4096 channels x 393.216 Msps, 20 ms blocks (bench's
  heaviest-mode row) through acquisition and the 1 s lock hysteresis:
  carrier offsets, lock on signal channels only, 1 kHz audio, compaction,
  and a 64-channel card-against-CPU comparison;
- AM, USB and ISB banks at 256 channels with the serving geometry per
  channel, and live control on a CAM bank: a retune that re-acquires, a
  Doppler sweep that stays locked across k hops, a narrower filter;
- the mixed-mode MultiBank at bench's two mixed rows (FM + USB + CAM
  groups off one master FFT): squelch, 1 kHz audio, CAM acquisition to the
  exact bin, and a small MultiBank card against CPU;
- the single receiver at the reference ``radio`` defaults (192 kHz) in FM,
  AM, USB, LSB and CAM, fed numpy FM or the port's test modulator on the
  card, card against CPU, with mid-stream retune, filter and mode edits;
  the receiver behind a 24.576 Msps front end; and a 10 s offline replay;
- the serving daemons through their ``main()``: ``bankd --iq-file`` at the
  4096-channel FM serving geometry and ``bankd --channel-file`` at the
  first mixed row with a live RADIO_MODE migration, each bit-equal to the
  bank driven directly; ``bankd -I`` at 512 channels fed over 127.0.0.1 by
  the native sender at the wire rate; and ``radio`` at its defaults in FM,
  AM and USB, bit-equal to the receiver, with its status packet.  The
  daemons' per-block wall time and its split (KA9Q_BANKD_TIMING) print
  beside the card's name and power limit;
- the APRS chain, every daemon through its ``main()``: an AFSK-1200
  position frame on an NBFM carrier beside FM tone channels, sent by
  ``iqplay --native`` over 127.0.0.1 into ``bankd -I`` at 512 FM channels,
  decoded by ``packetd`` and printed by ``aprs`` (the frame byte-equal, the
  decode latency and packetd's CPU time per second of PCM printed); and at
  radio's defaults, ``frontend --iq-file`` into ``radio -I`` into
  ``packetd``, the front end retuned by radio's command over a multicast
  group (a loopback probe checks the group first), ``iqrecord -d 1`` into
  ``radio --iq-file``, and ``modulate -m usb`` on the card within 1 LSB of
  the CPU;
- the deployment chain (deploy/bankd -> opus-vhf -> monitor-vhf) over
  multicast groups: ``bankd -I`` at 512 FM channels with 62 tone carriers,
  an unmodulated one and one between channels, ``opusd -o 32000 -x`` and
  ``monitor`` as subprocesses, ``pcmcat -s`` byte-equal to the captured
  PCM, and ``control`` retuning one channel onto the carrier between
  channels mid-run and reading it back (``--once``); each tone checked as
  its channel's spectral peak on the PCM group, on the Opus group, and the
  new tone in monitor's mix.  Where libopus is not installed the phase
  says so and runs the legs that do not need it;
- the sharded bank (``parallel.mesh``) on a mesh of 4 shards of the card,
  the one-card machine's stand-in for 4 cards: FM+PL, FM+PL with the
  distributed master FFT (``shard_fft``) and CAM at 4096 channels x
  393.216 Msps, each against the unsharded bank on the card, the fill and
  AGC launches counted per block; ``bankd --mesh 4`` through ``main()``
  (``--iq-file`` at 1022 channels, padded to 1024, equal to bankd without
  the mesh; ``-I --max-active 64`` at 510 channels, where no padding row
  may take a slot); ``dryrun_multichip(4)``; the stage profile
  (``tools/stage_profile``) at 8192 channels on long blocks and 4096 at 20
  ms with the receiver's front end; and a 30 s serving soak
  (``tools/serve_soak``) at 5120 channels;
- the captured CUDA graphs (``utils/graphs.py``), which every phase above
  runs through: each path (the FM+PL bank at 4096 and 8192 channels, its
  ``process_active``, CAM, AM and USB at 4096, ISB at 256, both mixed
  MultiBank rows, the receiver in five modes, the 4-shard mesh in FM+PL
  and CAM) held bit-equal, state included, to an eager twin
  (``capture=False``) over 20 blocks with a retune, a Doppler step and a
  filter swap, one replay a block on each device; an 8-block scan
  (``process_scan_i16``, ``process_offline``) equal to 8 single eager
  steps with one replay a call; and eager against captured ms/block,
  device busy, capture time and the memory each holds, in one call;
- the complex notch (``ops/iir``) at a 192 kHz receiver's block and a
  24.576 Msps block, the state carried, against the CPU port and a float64
  transliteration of filter.c, and ``parallel.dryrun.entry()`` (the
  flagship step's compile check, the 16-channel FM bank): 20 blocks, each
  one replay bit-equal to the eager ``bank_step``, two fills a block;
- the benchmark runner (``python -m ka9q_sdr_tpu_torch.bench``, the twin
  of ``bench.py``) at its defaults in a subprocess: its rows printed, one
  result line naming this card, every default row with the fill or AGC
  kernel launched as its path needs, and its FM+PL 4096 serving row
  within 15% of the captured scan timed above;
- the two gates of the JAX package's ``lax.cond``, IF nodes of the
  captured graphs (``utils/graphs.py`` ``cond``, ``csrc/cond.cu``): the
  versions they need printed; a 36-block FM+PL 4096 scan (two firings of
  the PL measurement) bit-equal to the blocks replayed one at a time and
  to the eager twin; ``torch.profiler`` kernel counts showing the 16384-
  point rFFT on the due replay only and no acquisition FFT in 40 blocks
  of a 256-channel CAM bank whose every channel has locked; and each
  gate's cost, a due block against a not-due one;
- the runner's rows at full width against outputs the JAX package made
  (``ka9q_sdr_tpu_torch/data/reference``, ``tools/reference.py``): R1
  (the FM+PL 8192-channel long block), R2 (FM+PL 4096, one block a call
  and 8-block scans), R3 (the FM:5120 + USB:512 + CAM:512 MultiBank), R4
  (CAM 4096 wide) and R5 (CAM 2048 at 24.576 Msps, scans): each input's
  SHA-256, then the captured calls held to the module's bounds (integer
  state bit-equal, flags, kept PCM within PARITY.md #9, audio RMS within
  0.1 dB), the fill and AGC launches and the replays counted, and the
  device ms a block.

Times come from CUDA events.  Phases print their
findings line by line.
The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Any failed check makes the exit code 1
and suppresses both JSON lines; no CUDA device means exit code 2, and a
directory without the port beside the script exit code 3.
"""

import argparse
import ast
import contextlib
import io
import json
import os
import pickle
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

FAILURES = []

# Geometries (bench.py:227-233): 393.216 Msps, decimate 8192, 48 kHz out.
FS = 393.216e6
SERVE = dict(n_channels=4096, L=7864320, M=8912897)      # N = 2^24, 20 ms
LONG = dict(n_channels=8192, L=58195968, M=8912897)      # N = 2^26, 148 ms
SERVE_BLOCKS, ACTIVE_BLOCKS, LONG_BLOCKS = 20, 2, 4
#: FM carriers in the serving bank; all but one carry a 100 Hz PL tone.
SIGNAL = (5, 700, 1500, 2048, 2900, 4090)
NO_PL = (2900,)
LONG_SIGNAL = (11, 4096, 8000)
SEED = 20241016
DEV = "cuda"
#: H100 SXM peaks (NVIDIA's data sheet, at 700 W): device memory rate and
#: float32 rate outside the tensor cores; and its boost clock, used only to
#: size torch.cuda._sleep spins (phase 3 reads the clock it reports)
HBM_BPS, FP32_FLOPS = 3.35e12, 67e12
CLOCK_HZ = 1.98e9
#: CAM (PLL) bank at the serving geometry: lock comes 90-150 blocks in (35
#: to the first acquisition, the 1 Hz loop's pull-in, then the 1 s
#: hysteresis climbing from below zero).
CAM_BLOCKS, CAM_ACTIVE, CAM_CPU_BLOCKS = 190, 2, 190
PLL_BIN = 48000.0 / 65536          # the acquisition FFT's bin, Hz
#: CAM signal channels and their carrier offsets in PLL bins (+-300 Hz)
CAM_SIGNAL = {7: 37, 1000: -56, 2047: 17, 3333: 90}
#: Other modes: 256 channels at 24.576 Msps, N = 2^20, decimate 512
OTHER = dict(n_channels=256, samprate=24.576e6, L=491520, M=557057)
#: bench.py's mixed MultiBank rows (bench.py:358-360), serving geometry;
#: 60 blocks pass the CAM group's first acquisition (block 35)
MIXED_ROWS = ((("FM", 3072), ("USB", 512), ("CAM", 512)),
              (("FM", 5120), ("USB", 512), ("CAM", 512)))
MIXED_BLOCKS = 60
#: signal channels per group of the first mixed row: FM carriers (no PL),
#: USB tones 1 kHz up, CAM carriers (PLL bins off) with 1 kHz AM
MIXED_FM_SIG, MIXED_USB_SIG = (5, 700, 1500, 3000), (10, 300)
MIXED_CAM_SIG = {7: 37, 400: -56}
#: receiver blocks per mode at 192 kHz (20 ms each); CAM passes its first
#: acquisition at block 35
RX_BLOCKS = {"FM": 25, "AM": 25, "USB": 25, "LSB": 25, "CAM": 80}
#: the daemons (phases 18-21): blocks of each --iq-file run, the block
#: before which the mixed-mode daemon gets its RADIO_MODE command, and the
#: FM channel (SSRC = index + 1) that it moves into the USB group
DAEMON_BLOCKS, MIGRATE_AT, MIGRATE_CH = 8, 4, 700
#: the live path at README's deployment line: 512 FM channels at 24.576
#: Msps, the 64 loudest served, blocks to run; FM carriers on LIVE_SIG
LIVE = dict(samprate=24576000, channels=512, max_active=64, blocks=150)
LIVE_SIG = (3, 100, 257, 400, 511)
#: how long phase 20 waits for the live daemon to serve its blocks
DAEMON_WAIT_S = 30.0
RADIO_BLOCKS = 25
#: the APRS chain (phases 22-23): the live bank's channel that carries the
#: AFSK-1200 frame and the LIVE_SIG tone channels beside it; the frame's
#: start in each period of signal, its FM deviation, and the seconds of
#: I/Q iqplay sends to bankd (the frame airs once a second)
APRS_CH, APRS_TONES = 200, (3, 257, 511)
APRS_START_S, APRS_DEV_HZ, APRS_SECONDS = 0.2, 3000.0, 2
#: phase 23: the front end's centre; the frame's IF in its recording, 30
#: kHz up, where radio finds it only after its LO1 command has retuned the
#: front end (whose replay then shifts by the retune); the period of the
#: looped recording, how long the front end streams, and the blocks radio
#: serves: any 2.5 s of stream hold a whole airing (period 1.5 s, frame
#: 0.35 s) after the retune, and radio has 3.5 s to bind
FE_CENTER, FE_IF = 146.0e6, 30e3
FE_PERIOD_S, FE_SECONDS, FE_RADIO_BLOCKS = 1.5, 6.0, 125
#: the SSRC of the datagrams that run packetd up to its --packets count
FILLER_SSRC = 0xF111
#: phase 24, the deployment chain (deploy/bankd.service -> opus-vhf ->
#: monitor-vhf) at the live bank's line, over multicast groups: bankd's
#: blocks; FM carriers on every (channels / max_active)-th channel from
#: `first`, max_active - 1 of them: tones from `tone0` Hz `tone_step` apart
#: at `dev` Hz deviation, the last one unmodulated; one more carrier midway
#: between channels 5 and 6 with `new_tone` Hz (off the tones' grid), onto
#: which control retunes the `retune`-th carrier's channel `retune_s` into
#: the stream; the seconds monitor mixes; opusd's flags (deploy/opus-vhf)
CHAIN = dict(blocks=250, first=3, tone0=400.0, tone_step=50.0, dev=1000.0,
             new_tone=1025.0, retune=40, retune_s=1.8, monitor_s=10.0)
OPUSD_FLAGS = ("-o", "32000", "-x")
#: head datagrams (20 ms each) pcmcat may miss while its group join settles
PCMCAT_JOIN_SLACK = 3
#: a subprocess that keeps every datagram of the groups it is given, with
#: its arrival on the host's monotonic clock, until SIGINT; then pickles them
CAPTURE = r"""
import pickle, select, sys, time
from ka9q_sdr_tpu_torch.net.multicast import setup_mcast
socks = [setup_mcast(g, output=False) for g in sys.argv[2:]]
for s in socks:
    s.setblocking(False)
got = []
print("ready", flush=True)
try:
    while True:
        for s in select.select(socks, [], [], 0.2)[0]:
            i = socks.index(s)
            while True:
                try:
                    got.append((time.monotonic(), i, s.recv(9000)))
                except BlockingIOError:
                    break
except KeyboardInterrupt:
    pass
with open(sys.argv[1], "wb") as f:
    pickle.dump(got, f)
"""


def check(cond, what):
    print(("  ok   " if cond else "  FAIL ") + what, flush=True)
    if not cond:
        FAILURES.append(what)
    return cond


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    """Mean device time of fn() in ms over `iters` calls, after a warm-up
    (the port's ``utils.timing.cuda_ms``)."""
    from ka9q_sdr_tpu_torch.utils import timing
    return timing.cuda_ms(fn, iters)


def device_ms(fn, iters, cold=False):
    """Device time per call of fn(), spin-padded CUDA events; cold, each
    call after a flush of the L2 (the port's ``utils.timing.device_ms``)."""
    from ka9q_sdr_tpu_torch.utils import timing
    return timing.device_ms(fn, iters, cold=cold)


def bank_freqs(n):
    usable = 0.9 * FS
    return list(np.linspace(-usable / 2, usable / 2, n, endpoint=False))


def make_iq(b, L, fs, seed, fm=(), carriers=(), dev=None):
    """Block b of a wideband int16 I/Q stream, made on the device from the
    seed: complex noise plus FM carriers `fm`, (freq Hz, with_pl), with
    1 kHz audio at 3 kHz deviation and, when with_pl, a 100 Hz PL tone at
    500 Hz deviation; and carriers `carriers`, (freq Hz, am, sweep), with
    am = 1 kHz AM at depth 0.5 and sweep = None or (start sample, Hz/s): a
    linear chirp from that sample on."""
    dev = DEV if dev is None else dev
    g = torch.Generator(device=dev).manual_seed(seed + b)
    n = b * L + torch.arange(L, device=dev, dtype=torch.float64)
    x = 0.03 * torch.randn((L, 2), generator=g, device=dev,
                           dtype=torch.float32).to(torch.float64)
    if fm:
        audio = 3.0 * torch.sin(2 * np.pi * torch.frac(n * (1000.0 / fs)))
        pl = 5.0 * torch.sin(2 * np.pi * torch.frac(n * (100.0 / fs)))
        for f, with_pl in fm:
            cyc = torch.frac(n * (f / fs))
            ph = 2 * np.pi * cyc + audio + (pl if with_pl else 0.0)
            x[:, 0] += 0.05 * torch.cos(ph)
            x[:, 1] += 0.05 * torch.sin(ph)
    if carriers:
        env = 1.0 + 0.5 * torch.sin(2 * np.pi * torch.frac(n * (1000.0 / fs)))
        for f, am, sweep in carriers:
            cyc = torch.frac(n * (f / fs))
            if sweep is not None:
                dt = torch.clamp_min(n - sweep[0], 0.0) / fs
                cyc = cyc + torch.frac(0.5 * sweep[1] * dt * dt)
            ph = 2 * np.pi * cyc
            a = 0.05 * env if am else 0.05
            x[:, 0] += a * torch.cos(ph)
            x[:, 1] += a * torch.sin(ph)
    return torch.clamp(x * 32767.0, -32768, 32767).to(torch.int16)


def make_block(b, L, freqs, signal, no_pl, dev):
    """Block b of the FM bank's input: FM carriers at the `signal`
    channels, with a PL tone except on `no_pl`."""
    return make_iq(b, L, FS, SEED, fm=[(freqs[ch], ch not in no_pl)
                                       for ch in signal], dev=dev)


def make_am_block(b, L, fs, carriers, dev):
    """Block b of an AM/linear bank's input: `carriers` (see make_iq)."""
    return make_iq(b, L, fs, SEED + 7, carriers=carriers, dev=dev)


def tone_hz(pcm_rows, rate=48000.0):
    spec = np.abs(np.fft.rfft(pcm_rows.astype(np.float64)))
    spec[0] = 0.0
    return np.argmax(spec) * rate / len(pcm_rows)


def bound_ms(nbytes, flops=0.0):
    """Least device time for the work: bytes over the H100's 3.35 TB/s or
    float32 operations over its 67 TFLOP/s, whichever is larger; and which
    one sets it."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fill_bytes(B, T, dtype):
    """Bytes a fill must move: mask, values and inits read, outputs
    written, each once."""
    w = 8 if dtype == torch.complex64 else 4
    return B * T * (1 + 2 * w) + B * w


def phase_kernel(ffill):
    """Kernel against plain version: bit-equal, and timed at the main
    path's shapes beside each shape's bound."""
    print("phase 2: ffill kernel against its plain version", flush=True)
    g = torch.Generator(device=DEV).manual_seed(SEED)
    max_err = 0.0
    cases = [(4096, 960), (8192, 7104), (7, 100), (130, 391), (1, 960),
             (3072, 960), (5, 9)]
    for B, T in cases:
        for kind in ("complex64", "conj view", "float32"):
            dtype = torch.float32 if kind == "float32" else torch.complex64
            v = torch.randn((B, T), generator=g, device=DEV, dtype=dtype)
            if kind == "conj view":
                v = torch.conj(v)
            init = torch.randn((B,), generator=g, device=DEV, dtype=dtype)
            m = torch.rand((B, T), generator=g, device=DEV) < 0.6
            m[::5] = False                      # rows that take init
            m[1::5] = True                      # rows all strong
            for mask in (m, torch.zeros_like(m)):
                (got,) = ffill.forward_fill_multi((v,), mask, (init,))
                (want,) = ffill.fill_plain((v,), mask, (init,))
                torch.cuda.synchronize()
                max_err = max(max_err, float((got - want).abs().max()))
                check(torch.equal(got, want),
                      f"kernel == plain at ({B}, {T}) {kind}"
                      f"{' all rows weak' if not mask.any() else ''}")
    times = {}
    for B, T in ((4096, 960), (8192, 7104), (1, 960), (3072, 960)):
        for kind in ("conj view", "float32"):
            dtype = torch.float32 if kind == "float32" else torch.complex64
            v = torch.randn((B, T), generator=g, device=DEV, dtype=dtype)
            if kind == "conj view":            # as fm_demod passes it
                v = torch.conj(v)
            init = torch.zeros((B,), device=DEV, dtype=dtype)
            m = torch.rand((B, T), generator=g, device=DEV) < 0.9

            def kern_fn():
                return ffill.forward_fill_multi((v,), m, (init,))

            def plain_fn():
                return ffill.fill_plain((v,), m, (init,))

            plain = cuda_ms(plain_fn, 20)
            kern = cuda_ms(kern_fn, 20)
            kern2 = cuda_ms(kern_fn, 20)
            plain2 = cuda_ms(plain_fn, 20)
            warm = device_ms(kern_fn, 20)
            dev_k = device_ms(kern_fn, 20, cold=True)
            dev_p = device_ms(plain_fn, 20, cold=True)
            nbytes = fill_bytes(B, T, dtype)
            bound, _ = bound_ms(nbytes)
            times[(B, T, dtype)] = (dev_k, dev_p, bound)
            print(f"  time ({B}, {T}) {kind}: kernel {kern:.4f}/{kern2:.4f} "
                  f"ms, plain {plain:.4f}/{plain2:.4f} ms (CUDA events); "
                  f"device only: kernel {warm:.4f} ms warm, {dev_k:.4f} ms "
                  f"cold L2, plain {dev_p:.4f} ms cold; bound {bound:.3g} ms "
                  f"({nbytes / 1e6:.3g} MB at 3.35 TB/s), kernel (cold) at "
                  f"{bound / dev_k:.0%} of it, "
                  f"{nbytes / (dev_k / 1e3) / 1e9:.0f} GB/s", flush=True)
    return max_err, times


def phase_serving(bank_mod, ffill, freqs):
    """The 4096-channel FM+PL bank at the 20 ms serving geometry."""
    from ka9q_sdr_tpu_torch.models.demod_fm import PL_FFT_INTERVAL

    print("phase 5: 4096-ch FM+PL bank, 20 ms blocks (N = 2^24)", flush=True)
    cfg = bank_mod.make_bank_config(SERVE["n_channels"], "FM", samprate=FS,
                                    L=SERVE["L"], M=SERVE["M"],
                                    enable_pl=True)
    check((cfg.N, cfg.decimate, cfg.N_dec, cfg.L_dec) == (1 << 24, 8192, 2048,
                                                          960),
          f"geometry N={cfg.N} decimate={cfg.decimate} N_dec={cfg.N_dec} "
          f"L_dec={cfg.L_dec}")
    t0 = time.perf_counter()
    bank = bank_mod.ChannelBank(cfg, freqs, device=DEV)
    print(f"  bank_init {time.perf_counter() - t0:.2f} s", flush=True)
    n_blocks = SERVE_BLOCKS + ACTIVE_BLOCKS
    blocks = [make_block(b, SERVE["L"], freqs, SIGNAL, NO_PL, DEV)
              for b in range(n_blocks)]
    torch.cuda.synchronize()

    ffill.launches = 0
    pcm, diags = [], []
    for x in blocks[:SERVE_BLOCKS]:
        p, d = bank.process_i16_pcm(x)
        pcm.append(p.cpu().numpy())
        diags.append({k: v.cpu().numpy() for k, v in d.items()})
    actives = []
    for x in blocks[SERVE_BLOCKS:]:
        p, idx, d = bank.process_active(x, max_active=64)
        actives.append((p.cpu().numpy(), idx.cpu().numpy()))
        diags.append({k: v.cpu().numpy() for k, v in d.items()})
    torch.cuda.synchronize()
    launches = ffill.launches

    check(launches == 2 * n_blocks,
          f"ffill launches {launches} == 2 per block x {n_blocks}")
    noise = [c for c in range(cfg.n_channels) if c not in SIGNAL]
    last = diags[-1]
    check(bool(last["squelch_open"][list(SIGNAL)].all()),
          "squelch open on every signal channel")
    check(not last["squelch_open"][noise].any(),
          f"squelch closed on all {len(noise)} noise-only channels")
    for ch in SIGNAL:
        f = tone_hz(np.concatenate([p[ch] for p in pcm[8:]]))
        check(abs(f - 1000.0) < 5.0, f"ch {ch}: audio peak at {f:.1f} Hz")
    first_fft = -(-PL_FFT_INTERVAL // (cfg.L_dec // 32)) - 1   # block 17
    for ch in SIGNAL:
        if ch in NO_PL:
            continue
        before = [d["plfreq"][ch] for d in diags[:first_fft]]
        after = [d["plfreq"][ch] for d in diags[first_fft:]]
        check(np.isnan(before).all() and np.all(np.abs(np.array(after)
                                                       - 100.0) < 2.0),
              f"ch {ch}: plfreq NaN before block {first_fft}, then "
              f"{', '.join(f'{a:.2f}' for a in after)} Hz")
    for p, idx in actives:
        got = sorted(int(i) for i in idx if i >= 0)
        check(got == sorted(SIGNAL), f"process_active channels {got}")
        check(p.shape == (64, cfg.L_dec) and p.dtype == np.int16,
              f"process_active PCM {p.shape} {p.dtype}")
    check(all(not p[noise].any() for p in pcm[4:]),
          "noise-only channels silent from block 4")
    st = bank.state
    finite = [torch.isfinite(t).all().item() for t in
              (st.overlap, st.demod.pl_ring, st.demod.audio_overlap,
               st.demod.disc_state, st.demod.lastaudio, st.nco.freq_resid,
               st.nco.phase_resid)]
    check(all(finite), "state finite (so no NaN reached audio or PCM)")
    return launches, blocks


def phase_card_vs_cpu(bank_mod, interop, freqs, blocks):
    """A 64-channel bank at the same per-channel geometry, same input, on
    the card and on the CPU (plain path)."""
    print("phase 6: 64-ch FM bank on cuda against cpu, same input", flush=True)
    keep = sorted(set(SIGNAL) | set(range(0, SERVE["n_channels"], 71)))[:64]
    sub = [freqs[c] for c in keep]
    sig_rows = [keep.index(c) for c in SIGNAL]
    noise_rows = [i for i in range(len(keep)) if i not in sig_rows]
    cfg = bank_mod.make_bank_config(len(keep), "FM", samprate=FS,
                                    L=SERVE["L"], M=SERVE["M"],
                                    enable_pl=True)
    gpu = bank_mod.ChannelBank(cfg, sub, device=DEV)
    cpu = bank_mod.ChannelBank(cfg, sub, device="cpu")
    worst = 0
    t0 = time.perf_counter()
    for b, x in enumerate(blocks):
        pg, dg = gpu.process_i16_pcm(x)
        pc, dc = cpu.process_i16_pcm(x.cpu())
        pg, pc = pg.cpu().numpy().astype(np.int32), pc.numpy().astype(np.int32)
        worst = max(worst, int(np.abs(pg[sig_rows] - pc[sig_rows]).max()))
        if b in (4, len(blocks) - 1):
            check(not pg[noise_rows].any() and not pc[noise_rows].any(),
                  f"block {b}: noise-only rows silent on both")
        if not np.array_equal(dg["squelch_open"].cpu().numpy(),
                              dc["squelch_open"].numpy()):
            check(False, f"block {b}: squelch flags differ")
    print(f"  cpu side {time.perf_counter() - t0:.1f} s for {len(blocks)} "
          "blocks (both sides)", flush=True)
    check(worst <= 1, f"signal-channel PCM within 1 LSB (worst {worst})")
    g = interop.state_to_numpy(gpu.state)
    c = interop.state_to_numpy(cpu.state)
    for name in ("k", "r", "dr"):
        check(np.array_equal(getattr(g, name), getattr(c, name)),
              f"state.{name} equal")
    for name, a, b in zip(g.nco._fields, g.nco, c.nco):
        check(np.array_equal(a, b), f"state.nco.{name} equal")
    for name in ("snr_below", "pl_counter"):
        check(np.array_equal(getattr(g.demod, name), getattr(c.demod, name)),
              f"state.demod.{name} equal")
    pf_g, pf_c = g.demod.plfreq[sig_rows], c.demod.plfreq[sig_rows]
    check(np.array_equal(pf_g, pf_c, equal_nan=True),
          f"plfreq equal on signal channels ({pf_g})")
    ring = c.demod.pl_ring[sig_rows]
    err = float(np.abs(g.demod.pl_ring[sig_rows] - ring).max())
    check(err <= 1e-4 * float(np.abs(ring).max()),
          f"PL ring within 1e-4 of scale (err {err:.3g})")


def phase_long(bank_mod, ffill):
    """The 8192-channel long-block geometry: the 2^26 master FFT and the
    (8192, 7104) fills."""
    print("phase 7: 8192-ch FM+PL bank, long blocks (N = 2^26)", flush=True)
    cfg = bank_mod.make_bank_config(LONG["n_channels"], "FM", samprate=FS,
                                    L=LONG["L"], M=LONG["M"], enable_pl=True)
    check((cfg.N, cfg.L_dec) == (1 << 26, 7104),
          f"geometry N={cfg.N} L_dec={cfg.L_dec}")
    freqs = bank_freqs(cfg.n_channels)
    signal = LONG_SIGNAL
    bank = bank_mod.ChannelBank(cfg, freqs, device=DEV)
    ffill.launches = 0
    pcm = []
    for b in range(LONG_BLOCKS):
        x = make_block(b, LONG["L"], freqs, signal, (), DEV)
        p, d = bank.process_i16_pcm(x)
        pcm.append(p.cpu().numpy())
    check(ffill.launches == 2 * LONG_BLOCKS,
          f"ffill launches {ffill.launches} == 2 per block")
    check(pcm[-1].shape == (8192, 7104) and pcm[-1].dtype == np.int16,
          f"PCM {pcm[-1].shape} {pcm[-1].dtype}")
    sq = d["squelch_open"].cpu().numpy()
    noise = [c for c in range(cfg.n_channels) if c not in signal]
    check(bool(sq[list(signal)].all()) and not sq[noise].any(),
          "squelch open on the 3 signal channels only")
    check(not pcm[-1][noise].any(), "noise-only channels silent")
    for ch in signal:
        f = tone_hz(np.concatenate([p[ch] for p in pcm[1:]]))
        check(abs(f - 1000.0) < 5.0, f"ch {ch}: audio peak at {f:.1f} Hz")
    return bank, cfg


def _agc_case(B, T, g):
    """Levels over 60 dB with zero runs; NaN initial gains (some on a zero
    level, where the gain goes inf), hang counts above zero at entry."""
    lev = 10.0 ** (3.0 * torch.rand((B, T), generator=g, device=DEV) - 4.0)
    lev[:, T // 3: T // 3 + 5] = 0.0
    lev[::11, :3] = 0.0
    gain = 10.0 ** (5.0 * torch.rand((B,), generator=g, device=DEV))
    gain[::7] = float("nan")
    hang = torch.randint(0, 40, (B,), generator=g, device=DEV,
                         dtype=torch.int32)
    return lev.contiguous(), gain, hang


def sm_clock_hz():
    """The SM clock under load: nvidia-smi's clocks.sm, read while a spin
    kernel holds the card (an idle card reports its idle clock)."""
    torch.cuda._sleep(int(1.5 * CLOCK_HZ))
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True)
    torch.cuda.synchronize()
    return float(out.stdout.strip().splitlines()[0]) * 1e6


#: phase 3's timed AGC shapes and calls per timing: the CAM bank, the long
#: block, a MultiBank group and the receiver's one row
AGC_TIMED = ((4096, 960, 20), (8192, 7104, 5), (512, 960, 20), (1, 960, 20))


#: the AGC step's dependent path (csrc/agc.cu `step`): mul.rn -> setp.gt.or
#: -> selp, three instructions at the ALU's dependent-issue latency of 4
#: cycles (Jia et al.'s microbenchmarks, Volta on; not measured here).  A
#: floor of the function, not of the kernel: its walk takes more (below).
AGC_CHAIN_CYCLES = 3 * 4


def agc_walk_cycles(agc, p, clock_hz, g):
    """Cycles per sample of the kernel's walk, the slope of one block's
    warm device time (32 channels, alone on the card) from T = 1024 to
    8192: the dependent path per step as the kernel runs it, with the
    per-tile waits, and without the launch and the ring's fill.  A
    diagnostic beside AGC_CHAIN_CYCLES, never a bound."""
    t = {}
    for T in (1024, 8192):
        lev, gain, hang = _agc_case(32, T, g)
        st = agc.AGCState(gain, hang)
        t[T] = device_ms(lambda: agc.agc_block(st, lev, p), 20)
    return (t[8192] - t[1024]) * 1e-3 * clock_hz / (8192 - 1024)


def phase_agc(agc):
    """AGC kernel against its plain loop: bit-equal, timed at the main
    paths' shapes beside the bytes bound and the step's chain floor."""
    print("phase 3: AGC kernel against its plain version", flush=True)
    g = torch.Generator(device=DEV).manual_seed(SEED + 1)
    params = {
        "AM (hangmax 0)": agc.AGCParams.from_mode(-15.0, 50.0, 0.0, 1 / 48e3),
        "linear (hangmax 52800)": agc.AGCParams.from_mode(-15.0, 6.0, 1.1,
                                                          1 / 48e3),
        "CW (hangmax 9600)": agc.AGCParams.from_mode(-15.0, 20.0, 0.2,
                                                     1 / 48e3),
    }
    max_err = 0.0
    for B, T in ((4096, 960), (8192, 7104), (7, 100), (130, 391), (512, 960),
                 (1, 960), (45, 961)):
        lev, gain, hang = _agc_case(B + (B == 45), T, g)
        if B == 45:           # rows 1.. at odd T: a view off 16-byte rows
            lev, gain, hang = lev[1:], gain[1:], hang[1:]
        for label, p in params.items():
            if B == 8192 and label.startswith("CW"):
                continue                  # the plain loop is slow here
            st, got = agc.agc_block(agc.AGCState(gain, hang), lev, p)
            want, g_want, h_want = agc.agc_plain(gain, hang, lev, p)
            torch.cuda.synchronize()
            same = (torch.equal(got.nan_to_num(), want.nan_to_num())
                    and torch.equal(got.isnan(), want.isnan())
                    and torch.equal(st.gain.nan_to_num(),
                                    g_want.nan_to_num())
                    and torch.equal(st.hangcount, h_want))
            fin = torch.isfinite(got) & torch.isfinite(want)
            if fin.any():
                max_err = max(max_err, float((got - want)[fin].abs().max()))
            check(same, f"AGC kernel == plain at ({B}, {T}), {label} "
                  f"({int(torch.isinf(got).sum())} inf, "
                  f"{int((st.hangcount > 0).sum())} rows hanging)"
                  f"{' (offset view)' if B == 45 else ''}")
    times = {}
    p = params["linear (hangmax 52800)"]
    clock = sm_clock_hz()
    walk = agc_walk_cycles(agc, p, clock, g)
    print(f"  SM clock under load {clock / 1e6:.0f} MHz (nvidia-smi); the "
          f"step's dependent path {AGC_CHAIN_CYCLES} cycles (3 instructions "
          f"x 4), the walk as built {walk:.2f} cycles per sample (one block, "
          f"slope from T = 1024 to 8192)", flush=True)
    for B, T, iters in AGC_TIMED:
        lev, gain, hang = _agc_case(B, T, g)
        st = agc.AGCState(gain, hang)
        kern = cuda_ms(lambda: agc.agc_block(st, lev, p), iters)
        # the plain loop queues ~12 launches per step, far more than the
        # launch queue holds, so device_ms cannot time it: CUDA events
        plain = cuda_ms(lambda: agc.agc_plain(gain, hang, lev, p), 1)
        kern2 = cuda_ms(lambda: agc.agc_block(st, lev, p), iters)
        warm = device_ms(lambda: agc.agc_block(st, lev, p), iters)
        dev_k = device_ms(lambda: agc.agc_block(st, lev, p), iters,
                          cold=True)
        # levels in, gains out, gain and hang count in and out
        bound, _ = bound_ms(B * T * 8 + B * 16)
        chain = T * AGC_CHAIN_CYCLES / clock * 1e3
        # the JSON line keeps the bytes bound (bytes or operations, and
        # at (4096, 960) and 1980 MHz the chain floor is below it); the
        # floor is printed beside it
        times[(B, T)] = (dev_k, plain, bound)
        print(f"  time ({B}, {T}): kernel {kern:.4f}/{kern2:.4f} ms, plain "
              f"loop {plain:.2f} ms ({T} steps) (CUDA events); device only:"
              f" kernel {warm:.4f} ms warm, {dev_k:.4f} ms cold L2 "
              f"({dev_k * 1e-3 * clock / T:.1f} cycles per sample); bytes "
              f"bound {bound:.4f} ms, chain floor {chain:.4f} ms "
              f"({'below' if chain < bound else 'above'} it); kernel (cold) "
              f"at {bound / dev_k:.0%} of the bytes bound, "
              f"{chain / dev_k:.0%} of the chain floor", flush=True)
    return max_err, times


def phase_pstock(pstock):
    """Column FFT kernel against its plain version, numpy and cuFFT: every
    Q it takes, then timed at (4096, 4096) beside its bound and cuFFT."""
    print("phase 4: column Stockham FFT kernel", flush=True)
    g = torch.Generator(device=DEV).manual_seed(SEED + 2)
    shapes = ((256, 512, 128), (4096, 4096, 256), (1024, 3072, 256))
    planes = {(Q, P): (torch.randn((Q, P), generator=g, device=DEV),
                       torch.randn((Q, P), generator=g, device=DEV))
              for Q, P, _ in shapes}
    fns = {(Q, P): pstock.make_fft_cols(Q, P, CW) for Q, P, CW in shapes}
    pstock.launches = 0
    outs = {key: fns[key](*planes[key]) for key in fns}     # the path
    torch.cuda.synchronize()
    launches = pstock.launches
    check(launches == len(shapes), f"pstock launches {launches} == "
          f"{len(shapes)}")
    # every Q from 1 to MAX_Q, at a P that is no multiple of any tile (8,
    # 16 or 128 columns): 3 tiles of 128 and 5 columns, 24 of 16 and 5
    for q in range(15):
        Q, P = 1 << q, 389
        xr = torch.randn((Q, P), generator=g, device=DEV)
        xi = torch.randn((Q, P), generator=g, device=DEV)
        planes[(Q, P)] = (xr, xi)
        outs[(Q, P)] = pstock.make_fft_cols(Q, P, P)(xr, xi)
    max_err, worst = 0.0, 0.0
    for (Q, P), (yr, yi) in outs.items():
        xr, xi = planes[(Q, P)]
        pr, pi = pstock.fft_cols_plain(xr, xi)
        got = torch.complex(yr, yi)
        plain = torch.complex(pr, pi)
        x = (xr.double().cpu().numpy() + 1j * xi.double().cpu().numpy())
        want = np.fft.fft(x, axis=0)
        scale = np.abs(want).max()
        e_np = np.abs(got.cpu().numpy() - want).max() / scale
        e_plain = float((got - plain).abs().max()) / scale
        max_err = max(max_err, float((got - plain).abs().max()))
        worst = max(worst, e_np, e_plain)
        check(e_np < 2e-6 and e_plain < 2e-6,
              f"column FFT ({Q}, {P}), plan {pstock.radix_plan(Q)}: rel "
              f"err {e_np:.2e} vs np.fft, {e_plain:.2e} vs plain")
    print(f"  worst rel err over {len(outs)} shapes {worst:.2e}", flush=True)
    xr, xi = planes[(4096, 4096)]
    f = fns[(4096, 4096)]
    xc = torch.complex(xr, xi)
    kern = cuda_ms(lambda: f(xr, xi), 20)
    plain = cuda_ms(lambda: pstock.fft_cols_plain(xr, xi), 5)
    cufft = cuda_ms(lambda: torch.fft.fft(xc, dim=0), 20)
    kern2 = cuda_ms(lambda: f(xr, xi), 20)
    dev_k = device_ms(lambda: f(xr, xi), 20, cold=True)
    dev_p = device_ms(lambda: pstock.fft_cols_plain(xr, xi), 5, cold=True)
    dev_c = device_ms(lambda: torch.fft.fft(xc, dim=0), 20, cold=True)
    nbytes = 4096 * 4096 * 16
    bound, by = bound_ms(nbytes, 5.0 * 4096 * 12 * 4096)
    print(f"  time (4096, 4096): kernel {kern:.4f}/{kern2:.4f} ms, plain "
          f"{plain:.3f} ms, torch.fft (cuFFT, complex64) {cufft:.4f} ms "
          f"(CUDA events); device only, cold L2: kernel {dev_k:.4f} ms "
          f"({nbytes / 1e6 / dev_k:.0f} GB/s of reads+writes), plain "
          f"{dev_p:.3f} ms, cuFFT {dev_c:.4f} ms; bound {bound:.4f} ms (set "
          f"by {by}: {nbytes / 1e6:.0f} MB at 3.35 TB/s), kernel at "
          f"{bound / dev_k:.0%} of it, cuFFT at {bound / dev_c:.0%}",
          flush=True)
    return launches, max_err, (dev_k, dev_p, dev_c, bound)


def _bank_state_finite(st):
    d = st.demod
    leaves = [st.overlap, st.nco.freq_resid, st.nco.phase_resid, d.agc.gain]
    if hasattr(d, "integrator"):
        leaves += [d.integrator, d.shift.phase_resid]
        leaves += [t for t in (d.fft_ring,) if t is not None]
    else:
        leaves += [d.dc]
    return all(torch.isfinite(t).all().item() for t in leaves)


def phase_cam(bank_mod, agc, freqs):
    """The 4096-channel CAM (PLL) bank at the 20 ms serving geometry."""
    print("phase 8: 4096-ch CAM (PLL) bank, 20 ms blocks (N = 2^24)",
          flush=True)
    cfg = bank_mod.make_bank_config(SERVE["n_channels"], "CAM", samprate=FS,
                                    L=SERVE["L"], M=SERVE["M"])
    dc = cfg.demod_cfg
    check((cfg.N_dec, cfg.L_dec, dc.acq_decim, dc.ring_size, dc.lock_limit)
          == (2048, 960, 32, 2048, 48000),
          f"geometry N_dec={cfg.N_dec} L_dec={cfg.L_dec} acq_decim="
          f"{dc.acq_decim} ring={dc.ring_size} lock_limit={dc.lock_limit}")
    carriers = [(freqs[c] + o * PLL_BIN, True, None)
                for c, o in CAM_SIGNAL.items()]
    bank = bank_mod.ChannelBank(cfg, freqs, device=DEV)
    sig = list(CAM_SIGNAL)
    noise = [c for c in range(cfg.n_channels) if c not in CAM_SIGNAL]
    first_lock = {c: None for c in sig}
    noise_locked = 0
    pcm = []
    t0 = time.perf_counter()
    agc.launches = 0
    for b in range(CAM_BLOCKS):
        x = make_am_block(b, SERVE["L"], FS, carriers, DEV)
        p, d = bank.process_i16_pcm(x)
        pcm.append(p[sig].cpu().numpy())
        lock = d["pll_lock"].cpu().numpy()
        noise_locked += int(lock[noise].sum())
        for c in sig:
            if lock[c] and first_lock[c] is None:
                first_lock[c] = b
    actives = []
    for b in range(CAM_BLOCKS, CAM_BLOCKS + CAM_ACTIVE):
        x = make_am_block(b, SERVE["L"], FS, carriers, DEV)
        p, idx, d = bank.process_active(x, max_active=64)
        actives.append((p.cpu().numpy(), idx.cpu().numpy()))
    torch.cuda.synchronize()
    launches = agc.launches
    print(f"  {CAM_BLOCKS + CAM_ACTIVE} blocks in "
          f"{time.perf_counter() - t0:.1f} s (signal generation included)",
          flush=True)
    check(launches == CAM_BLOCKS + CAM_ACTIVE,
          f"agc launches {launches} == 1 per block x "
          f"{CAM_BLOCKS + CAM_ACTIVE}")
    st = bank.state.demod
    df = st.delta_f.cpu().numpy()
    for c, o in CAM_SIGNAL.items():
        check(abs(df[c] - o * PLL_BIN) <= PLL_BIN,
              f"ch {c}: delta_f {df[c]:.3f} Hz, carrier at "
              f"{o * PLL_BIN:.3f} Hz")
    lock = st.pll_lock.cpu().numpy()
    check(bool(lock[sig].all()), f"pll_lock on every signal channel (first "
          f"locked at blocks {list(first_lock.values())})")
    check(noise_locked == 0 and not lock[noise].any(),
          f"no lock on any of the {len(noise)} noise-only channels, in any "
          "block")
    for i, c in enumerate(sig):
        f = tone_hz(np.concatenate([p[i] for p in pcm[-20:]]))
        check(abs(f - 1000.0) < 5.0, f"ch {c}: audio peak at {f:.1f} Hz")
    # the AGC lifts every linear channel's noise to headroom, so all
    # channels are active and the top 64 by peak are any 64 of them
    for p, idx in actives:
        got = set(int(i) for i in idx if i >= 0)
        check(len(got) == 64 and p.shape == (64, cfg.L_dec)
              and p.dtype == np.int16 and all(row.any() for row in p),
              f"process_active: 64 distinct active channels, PCM {p.shape} "
              f"{p.dtype}")
    check(_bank_state_finite(bank.state), "state finite")
    return launches, bank, carriers


def phase_cam_card_vs_cpu(bank_mod, interop, freqs, carriers):
    """A 64-channel CAM bank at the same geometry, same input, on the card
    and on the CPU (plain versions of every kernel)."""
    print("phase 9: 64-ch CAM bank on cuda against cpu, same input",
          flush=True)
    keep = sorted(set(CAM_SIGNAL) | set(range(0, SERVE["n_channels"],
                                              67)))[:64]
    sub = [freqs[c] for c in keep]
    sig_rows = [keep.index(c) for c in CAM_SIGNAL]
    cfg = bank_mod.make_bank_config(len(keep), "CAM", samprate=FS,
                                    L=SERVE["L"], M=SERVE["M"])
    gpu = bank_mod.ChannelBank(cfg, sub, device=DEV)
    cpu = bank_mod.ChannelBank(cfg, sub, device="cpu")
    worst, worst0, sq, count, lock_diff = 0, 0, 0.0, 0, 0
    t0 = time.perf_counter()
    for b in range(CAM_CPU_BLOCKS):
        x = make_am_block(b, SERVE["L"], FS, carriers, DEV)
        pg, dg = gpu.process_i16_pcm(x)
        pc, dc = cpu.process_i16_pcm(x.cpu())
        d = (pg.cpu().numpy().astype(np.int64)[sig_rows]
             - pc.numpy().astype(np.int64)[sig_rows])
        if b == 0:
            worst0 = int(np.abs(d).max())   # cold-start transient, reported
        else:
            worst = max(worst, int(np.abs(d).max()))
            sq += float((d.astype(np.float64) ** 2).sum())
            count += d.size
        lock_diff += int((dg["pll_lock"].cpu() != dc["pll_lock"]).sum())
    rms_db = 10 * np.log10(max(sq / max(count, 1), 1e-30) / 32768.0 ** 2)
    print(f"  {CAM_CPU_BLOCKS} blocks in {time.perf_counter() - t0:.1f} s "
          f"(both sides); block 0 (cold start) worst {worst0} LSB",
          flush=True)
    check(worst <= 8 and rms_db <= -85.0,
          f"signal-channel PCM from block 1: worst {worst} LSB (<= 8), "
          f"difference RMS {rms_db:.1f} dBFS (<= -85)")
    check(lock_diff == 0, "pll_lock equal in every block")
    g = interop.state_to_numpy(gpu.state)
    c = interop.state_to_numpy(cpu.state)
    for name in ("k", "r", "dr"):
        check(np.array_equal(getattr(g, name), getattr(c, name)),
              f"state.{name} equal")
    for name, a, b in zip(g.nco._fields, g.nco, c.nco):
        check(np.array_equal(a, b), f"state.nco.{name} equal")
    for name in ("pll_lock", "lock_count", "fft_samples"):
        check(np.array_equal(getattr(g.demod, name), getattr(c.demod, name)),
              f"state.demod.{name} equal")
    print(f"  delta_f equal: {np.array_equal(g.demod.delta_f, c.demod.delta_f)}"
          f"; signal rows locked: {g.demod.pll_lock[sig_rows].tolist()}",
          flush=True)


def _other_freqs():
    fs = OTHER["samprate"]
    return list(np.linspace(-0.45 * fs, 0.45 * fs, OTHER["n_channels"],
                            endpoint=False))


def _other_bank(bank_mod, mode, freqs):
    cfg = bank_mod.make_bank_config(OTHER["n_channels"], mode,
                                    samprate=OTHER["samprate"], L=OTHER["L"],
                                    M=OTHER["M"])
    return bank_mod.ChannelBank(cfg, freqs, device=DEV)


def phase_other_modes(bank_mod, agc):
    """AM, USB and ISB banks at 256 channels, serving geometry per channel
    (N_dec 2048, L_dec 960) from a 24.576 Msps master."""
    print("phase 10: AM, USB, ISB banks, 256 ch at 24.576 Msps (N = 2^20)",
          flush=True)
    fs, L = OTHER["samprate"], OTHER["L"]
    freqs = _other_freqs()
    cases = [
        ("AM", {3: [(0.0, True)], 100: [(0.0, True)], 200: [(0.0, True)]},
         20),
        ("USB", {5: [(1000.0, False)], 77: [(1000.0, False)],
                 250: [(1000.0, False)]}, 8),
        ("ISB", {9: [(1000.0, False), (-1500.0, False)],
                 130: [(1000.0, False), (-1500.0, False)]}, 8),
    ]
    for mode, sig, n_blocks in cases:
        bank = _other_bank(bank_mod, mode, freqs)
        carriers = [(freqs[c] + off, am, None) for c, lst in sig.items()
                    for off, am in lst]
        pcm = []
        agc.launches = 0
        for b in range(n_blocks):
            p, _ = bank.process_i16_pcm(make_am_block(b, L, fs, carriers,
                                                      DEV))
            pcm.append(p[list(sig)].cpu().numpy())
        torch.cuda.synchronize()
        check(agc.launches == n_blocks,
              f"{mode}: agc launches {agc.launches} == {n_blocks}")
        half = pcm[n_blocks // 2:]
        for i, c in enumerate(sig):
            if mode == "ISB":
                left = tone_hz(np.concatenate([p[i, :, 0] for p in half]))
                right = tone_hz(np.concatenate([p[i, :, 1] for p in half]))
                check(abs(left - 1500.0) < 5.0 and abs(right - 1000.0) < 5.0,
                      f"ISB ch {c}: LSB tone on I at {left:.1f} Hz, USB tone "
                      f"on Q at {right:.1f} Hz")
            else:
                f = tone_hz(np.concatenate([p[i] for p in half]))
                check(abs(f - 1000.0) < 5.0,
                      f"{mode} ch {c}: audio peak at {f:.1f} Hz")
        if mode == "ISB":
            p, idx, _ = bank.process_active(
                make_am_block(n_blocks, L, fs, carriers, DEV), max_active=64)
            got = set(int(i) for i in idx.cpu() if i >= 0)
            check(len(got) == 64 and tuple(p.shape) == (64, 2 * 960),
                  f"ISB process_active: 64 distinct channels, stereo PCM "
                  f"{tuple(p.shape)}")
        check(_bank_state_finite(bank.state), f"{mode}: state finite")


def phase_live_control(bank_mod):
    """Live control on a 256-channel CAM bank: a retune to another carrier
    (with the demod row reset) re-acquires and re-locks; a Doppler sweep
    steered on a locked channel stays locked across k hops; a narrower
    filter leaves every state finite."""
    from ka9q_sdr_tpu_torch.models.demod_linear import linear_init

    print("phase 11: live control on a 256-ch CAM bank", flush=True)
    fs, L = OTHER["samprate"], OTHER["L"]
    freqs = _other_freqs()
    A, S, C = 20, 60, 180
    off = {A: 37 * PLL_BIN, S: -56 * PLL_BIN, C: 17 * PLL_BIN}
    x_center, x_off = freqs[A] + 43200.0, 25 * PLL_BIN
    P1, P2, P3, rate = 170, 170, 10, 500.0
    bank = _other_bank(bank_mod, "CAM", freqs)
    B = bank.cfg.n_channels

    def carriers(sweep):
        return [(freqs[A] + off[A], True, None),
                (freqs[S] + off[S], True, sweep),
                (freqs[C] + off[C], True, None),
                (x_center + x_off, True, None)]

    def run(b0, n, sweep):
        locks, pcm = [], []
        for b in range(b0, b0 + n):
            p, d = bank.process_i16_pcm(make_am_block(b, L, fs,
                                                      carriers(sweep), DEV))
            locks.append(d["pll_lock"][[A, S, C]].cpu().numpy())
            pcm.append(p[[A, S, C]].cpu().numpy())
        return np.array(locks), pcm

    locks, _ = run(0, P1, None)
    check(locks[-1].all(), f"channels {A}, {S}, {C} locked after {P1} "
          f"blocks (first at {[int(np.argmax(locks[:, i])) for i in range(3)]})")
    k_s = int(bank.state.k[S])
    bank.tune(A, x_center)
    bank.state = bank_mod.bank_reset_demod_row(
        bank.state, linear_init(bank.cfg.demod_cfg, (B,), device=DEV), A, B)
    sweep = (P1 * L, rate)
    bank.set_doppler(S, 0.0, rate)
    locks, _ = run(P1, P2, sweep)
    hops = int(bank.state.k[S]) - k_s
    check(locks[:, 1].all() and abs(hops) >= 20,
          f"ch {S}: locked in all {P2} blocks of a {rate:.0f} Hz/s sweep "
          f"({hops} k hops)")
    df = float(bank.state.demod.delta_f[A])
    check(abs(df - x_off) <= PLL_BIN and locks[-1, 0],
          f"ch {A} retuned: re-acquired at {df:.3f} Hz (carrier "
          f"{x_off:.3f} Hz), locked again at block "
          f"{P1 + int(np.argmax(locks[:, 0]))}")
    bank.set_filter(-3000.0, 3000.0)
    locks, pcm = run(P1 + P2, P3, sweep)
    f = tone_hz(np.concatenate([p[2] for p in pcm]))
    check(_bank_state_finite(bank.state) and locks.all()
          and abs(f - 1000.0) < 10.0,
          f"after set_filter(-3000, 3000): state finite, all locked, ch {C} "
          f"audio at {f:.1f} Hz")


def time_step(step, n_ch, L, fs, label, iters, smi, kernel_ms=None):
    """Per-block device time of step() on a device-resident input, after
    a warm-up: CUDA events for the block, device_ms (one block at a time,
    the mean of three) for the device's busy time and idle share.  kernel_ms: the device
    time per block of one kernel's launches, printed as a share of it."""
    step()
    torch.cuda.reset_peak_memory_stats()
    t_host = time.perf_counter()
    ms = cuda_ms(step, iters)
    t_host = (time.perf_counter() - t_host) / (iters + 1) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    busy = sum(device_ms(step, 1) for _ in range(3)) / 3
    idle = max(0.0, 1 - busy / ms) if busy == busy else busy    # nan stays
    rate = n_ch * L / (ms / 1e3) / 1e6
    realtime = (L / fs) / (ms / 1e3)
    print(f"  {label}: {ms:.3f} ms/block on the device ({t_host:.3f} ms host "
          f"wall incl. sync), {rate:,.{0 if rate >= 100 else 3}f} ch x Msps, "
          f"{realtime:.2f}x "
          f"realtime, peak {peak:.1f} GiB; device busy {busy:.3f} ms/block, "
          f"device idle {idle:.0%} [{smi}]",
          flush=True)
    if kernel_ms is not None:
        print(f"  {label}: its kernel launches {kernel_ms:.4f} ms/block, "
              f"{kernel_ms / busy:.1%} of the device time", flush=True)
    return ms, rate, busy


def time_bank(bank, L, signal, label, iters, smi, kernel_ms=None):
    """time_step of a ChannelBank's int16-in, PCM-out block."""
    x = make_block(0, L, bank.freqs, signal, (), DEV)
    ms, rate, _ = time_step(lambda: bank.process_i16_pcm(x),
                            bank.cfg.n_channels, L, FS, label, iters, smi,
                            kernel_ms)
    return ms, rate


def _mixed_groups(spec):
    """bench.py's mixed-row layout: every channel of every group on one
    grid over the usable 90% of the band, the groups in order."""
    total = sum(n for _, n in spec)
    grid = bank_freqs(total)
    groups, i = [], 0
    for mode, n in spec:
        groups.append((mode, grid[i:i + n]))
        i += n
    return groups


def phase_multibank(bank_mod, ffill, agc, smi):
    """bench's mixed rows: FM + USB + CAM groups off ONE master FFT at
    393.216 Msps, 20 ms blocks."""
    print("phase 13: MultiBank " + " + ".join(f"{m}:{n}" for m, n in
                                              MIXED_ROWS[0])
          + f", {SERVE['L'] / FS * 1e3:.0f} ms blocks", flush=True)
    groups = _mixed_groups(MIXED_ROWS[0])
    fm_f, usb_f, cam_f = (f for _, f in groups)
    fm_sig, usb_sig, cam_sig = MIXED_FM_SIG, MIXED_USB_SIG, MIXED_CAM_SIG
    fm = [(fm_f[c], False) for c in fm_sig]
    carriers = ([(usb_f[c] + 1000.0, False, None) for c in usb_sig]
                + [(cam_f[c] + o * PLL_BIN, True, None)
                   for c, o in cam_sig.items()])
    mb = bank_mod.MultiBank(groups, samprate=FS, L=SERVE["L"], M=SERVE["M"],
                            device=DEV)
    check([c.N_dec for c in mb.cfgs] == [2048] * 3
          and all(s.overlap is mb.states[0].overlap for s in mb.states),
          "three groups, N_dec 2048 each, one overlap tensor shared")
    n_blocks = MIXED_BLOCKS
    pcm = {0: [], 1: [], 2: []}
    sq = None
    ffill.launches = agc.launches = 0
    t0 = time.perf_counter()
    for b in range(n_blocks):
        x = make_iq(b, SERVE["L"], FS, SEED + 11, fm=fm, carriers=carriers)
        outs = mb.process_i16_pcm(x)
        pcm[0].append(outs[0][0][list(fm_sig)].cpu().numpy())
        pcm[1].append(outs[1][0][list(usb_sig)].cpu().numpy())
        pcm[2].append(outs[2][0][list(cam_sig)].cpu().numpy())
        sq = outs[0][1]["squelch_open"]
    torch.cuda.synchronize()
    launches = (ffill.launches, agc.launches)
    print(f"  {n_blocks} blocks in {time.perf_counter() - t0:.1f} s (signal "
          "generation included)", flush=True)
    check(launches == (2 * n_blocks, 2 * n_blocks),
          f"ffill launches {launches[0]} == 2 per block (FM group), agc "
          f"launches {launches[1]} == 2 per block (USB and CAM groups)")
    sq = sq.cpu().numpy()
    noise = [c for c in range(len(fm_f)) if c not in fm_sig]
    check(bool(sq[list(fm_sig)].all()) and not sq[noise].any(),
          f"FM group: squelch open on the {len(fm_sig)} signal channels, "
          f"closed on all {len(noise)} others")
    for g, sig, want in ((0, fm_sig, 1000.0), (1, usb_sig, 1000.0),
                         (2, list(cam_sig), 1000.0)):
        for i, c in enumerate(sig):
            f = tone_hz(np.concatenate([p[i] for p in pcm[g][-15:]]))
            check(abs(f - want) < 5.0, f"group {g} ({groups[g][0]}) ch {c}: "
                  f"audio peak at {f:.1f} Hz")
    df = mb.states[2].demod.delta_f.cpu().numpy()
    for c, o in cam_sig.items():
        check(round(float(df[c]) / PLL_BIN) == o,
              f"CAM ch {c}: acquired at {df[c]:.3f} Hz = bin "
              f"{df[c] / PLL_BIN:.2f}, carrier in bin {o}")
    check(all(_bank_state_finite(s) for s in mb.states[1:]),
          "USB and CAM group states finite")
    del mb
    for spec in MIXED_ROWS:
        groups = _mixed_groups(spec)
        mb = bank_mod.MultiBank(groups, samprate=FS, L=SERVE["L"],
                                M=SERVE["M"], device=DEV)
        x = make_iq(0, SERVE["L"], FS, SEED + 11,
                    fm=[(groups[0][1][c], False) for c in fm_sig])
        n_ch = sum(n for _, n in spec)
        label = "MultiBank " + " + ".join(f"{m}:{n}" for m, n in spec)
        time_step(lambda: mb.process_i16_pcm(x), n_ch, SERVE["L"], FS, label,
                  20, smi)
        del mb


def phase_multibank_card_vs_cpu(bank_mod, interop):
    """A small MultiBank (FM, USB and CAM, two channels each) at
    1.536 Msps, same input, on the card and on the CPU."""
    print("phase 14: MultiBank at 1.536 Msps on cuda against cpu",
          flush=True)
    fs, L, M = 1.536e6, 30720, 34817
    grid = list(np.linspace(-0.45 * fs, 0.45 * fs, 6, endpoint=False))
    groups = [("FM", grid[0:2]), ("USB", grid[2:4]), ("CAM", grid[4:6])]
    fm = [(grid[1], False)]
    carriers = [(grid[2] + 1000.0, False, None),
                (grid[5] + 17 * PLL_BIN, True, None)]
    gpu = bank_mod.MultiBank(groups, samprate=fs, L=L, M=M, device=DEV)
    cpu = bank_mod.MultiBank(groups, samprate=fs, L=L, M=M, device="cpu")
    worst = [0, 0, 0]
    sq, count = [0.0] * 3, [0] * 3
    for b in range(40):
        x = make_iq(b, L, fs, SEED + 13, fm=fm, carriers=carriers)
        og = gpu.process_i16_pcm(x)
        oc = cpu.process_i16_pcm(x.cpu())
        for g in range(3):
            d = (og[g][0].cpu().numpy().astype(np.int64)
                 - oc[g][0].numpy().astype(np.int64))
            if b >= 1:
                worst[g] = max(worst[g], int(np.abs(d).max()))
                sq[g] += float((d.astype(np.float64) ** 2).sum())
                count[g] += d.size
    rms = [10 * np.log10(max(s / max(c, 1), 1e-30) / 32768.0 ** 2)
           for s, c in zip(sq, count)]
    check(worst[0] <= 1, f"FM group PCM within 1 LSB (worst {worst[0]})")
    for g in (1, 2):
        check(worst[g] <= 8 and rms[g] <= -85.0,
              f"{groups[g][0]} group PCM from block 1: worst {worst[g]} LSB "
              f"(<= 8), difference RMS {rms[g]:.1f} dBFS (<= -85)")
    for g in range(3):
        sg = interop.state_to_numpy(gpu.states[g])
        sc = interop.state_to_numpy(cpu.states[g])
        same = all(np.array_equal(getattr(sg, n), getattr(sc, n))
                   for n in ("k", "r", "dr"))
        same = same and all(np.array_equal(a, b)
                            for a, b in zip(sg.nco, sc.nco))
        if groups[g][0] == "CAM":
            same = same and all(
                np.array_equal(getattr(sg.demod, n), getattr(sc.demod, n))
                for n in ("pll_lock", "lock_count", "fft_samples", "delta_f"))
        check(same, f"{groups[g][0]} group: k/r/dr, NCO words"
              f"{' and PLL state' if groups[g][0] == 'CAM' else ''} equal")


def _pcm16(audio):
    return np.clip(np.asarray(audio, np.float64) * 32767.0, -32768,
                   32767).astype(np.int64)


def _rx_source(mode, modulate, rx_if, fs, L):
    """Block source for the receiver phase: numpy FM (1 kHz at 3 kHz
    deviation) for FM, else the port's Modulator on the card with 1 kHz
    audio (CAM: its AM preset, 37 PLL bins off the tuning)."""
    if mode == "FM":
        rng = np.random.default_rng(SEED)

        def fm_block(b):
            t = (b * L + np.arange(L)) / fs
            x = 0.3 * np.exp(1j * (2 * np.pi * rx_if * t
                                   + 3.0 * np.sin(2 * np.pi * 1000 * t)))
            x = x + 0.003 * (rng.standard_normal(L)
                             + 1j * rng.standard_normal(L))
            return torch.as_tensor(x.astype(np.complex64), device=DEV)
        return fm_block
    preset = {"AM": "am", "USB": "usb", "LSB": "lsb", "CAM": "am"}[mode]
    off = 37 * PLL_BIN if mode == "CAM" else 0.0
    mod = modulate.Modulator(preset, frequency=rx_if + off, amplitude_db=-20.0,
                             samprate=fs, device=DEV)
    n = mod.L // 4

    def mod_block(b):
        k0 = b * (L // mod.L)
        outs = []
        for k in range(k0, k0 + L // mod.L):
            t = (k * n + torch.arange(n, device=DEV, dtype=torch.float64)) \
                / (fs / 4)
            outs.append(mod.process(
                (0.5 * torch.sin(2 * np.pi * 1000.0 * t)).to(torch.float32)))
        return torch.cat(outs)
    return mod_block


def phase_receiver(receiver, modulate, ffill, agc, smi):
    """The single receiver at the reference radio defaults, per mode, card
    against CPU on the same input, then mid-stream control edits and the
    card's time per block."""
    print("phase 15: receiver at 192 kHz (L 3840, M 4353), per mode",
          flush=True)
    fs, rx_if = 192000, 48000.0
    edits = {"FM": ((-7000.0, 7000.0), "AM"), "AM": ((-4000.0, 4000.0), "USB"),
             "USB": ((200.0, 2800.0), "CWU"), "LSB": ((-2800.0, -200.0), "USB"),
             "CAM": ((-4000.0, 4000.0), "USB")}
    for mode, n_blocks in RX_BLOCKS.items():
        gpu = receiver.make_receiver(mode, device=DEV)
        cpu = receiver.make_receiver(mode, device="cpu")
        cfg = gpu.cfg
        check(all(rx.set_freq(rx_if) is None and rx.second_lo == -rx_if
                  for rx in (gpu, cpu)), f"{mode}: LO2 absorbs the tuning")
        source = _rx_source(mode, modulate, rx_if, fs, cfg.L)
        blocks = [source(b) for b in range(n_blocks)]
        torch.cuda.synchronize()
        ffill.launches = agc.launches = 0
        audio_g = [gpu.process(x)[0] for x in blocks]
        torch.cuda.synchronize()
        launches = ffill.launches if mode == "FM" else agc.launches
        want = (2 if mode == "FM" else 1) * n_blocks
        check(launches == want,
              f"{mode}: {'ffill' if mode == 'FM' else 'agc'} launches "
              f"{launches} == {want}")
        audio_g = [_pcm16(a.cpu()) for a in audio_g]
        audio_c = [_pcm16(cpu.process(x.cpu())[0]) for x in blocks]
        worst = max(int(np.abs(g - c).max())
                    for g, c in zip(audio_g[1:], audio_c[1:]))
        worst0 = int(np.abs(audio_g[0] - audio_c[0]).max())
        check(worst <= 1, f"{mode}: card against CPU within 1 LSB from block "
              f"1 (worst {worst}; block 0 {worst0})")
        f = tone_hz(np.concatenate(audio_g[-20:]))
        check(abs(f - 1000.0) < 5.0, f"{mode}: audio peak at {f:.1f} Hz")
        if mode == "CAM":
            df = float(gpu.state.demod.delta_f)
            check(round(df / PLL_BIN) == 37,
                  f"CAM: acquired at {df:.3f} Hz = bin {df / PLL_BIN:.2f} "
                  "(carrier in bin 37)")
        (low, high), new_mode = edits[mode]
        diffs, finite = [], True
        b = n_blocks
        for name, edit in (("set_freq", lambda rx: rx.set_freq(rx_if + 300.0)),
                           ("set_filter", lambda rx: rx.set_filter(low, high)),
                           ("set_mode", lambda rx: rx.set_mode(new_mode))):
            for rx in (gpu, cpu):
                edit(rx)
            for _ in range(3):
                x = source(b)
                ag, dg = gpu.process(x)
                ac, _ = cpu.process(x.cpu())
                finite = finite and bool(torch.isfinite(ag).all()) and bool(
                    torch.isfinite(dg["n0"]).all())
                diffs.append(int(np.abs(_pcm16(ag.cpu()) - _pcm16(ac)).max()))
                b += 1
        check(finite, f"{mode}: set_freq, set_filter({low:.0f}, {high:.0f}) "
              f"and set_mode({new_mode}) mid-stream: audio and n0 finite "
              f"(card against CPU per block: {diffs} LSB)")
        timed = receiver.make_receiver(mode, device=DEV)
        timed.set_freq(rx_if)
        time_step(lambda: timed.process(blocks[-1]), 1, cfg.L, fs,
                  f"{mode} receiver, 192 kHz", 20, smi)


def phase_receiver_wide(receiver, ffill, agc, smi):
    """The receiver behind a 24.576 Msps front end: N = 2^20, decimate
    512, 20 ms blocks."""
    print("phase 16: receiver at 24.576 Msps (L 491520, M 557057)",
          flush=True)
    fs, L, f0 = 24576000, 491520, 3.0e6
    for mode in ("FM", "USB"):
        rx = receiver.make_receiver(mode, samprate=fs, L=L, M=557057,
                                    device=DEV)
        rx.set_freq(f0)
        n = torch.arange(L, device=DEV, dtype=torch.float64)
        pcm = []
        ffill.launches = agc.launches = 0
        for b in range(12):
            t = (b * L + n) / fs
            if mode == "FM":
                ph = 2 * np.pi * torch.frac(t * f0) \
                    + 3.0 * torch.sin(2 * np.pi * torch.frac(t * 1000.0))
            else:
                ph = 2 * np.pi * torch.frac(t * (f0 + 1000.0))
            x = (0.1 * torch.exp(1j * ph)).to(torch.complex64)
            pcm.append(_pcm16(rx.process(x)[0].cpu()))
        torch.cuda.synchronize()
        got = ffill.launches if mode == "FM" else agc.launches
        want = 24 if mode == "FM" else 12
        check(got == want, f"{mode}: kernel launches {got} == {want}")
        f = tone_hz(np.concatenate(pcm[4:]))
        check(abs(f - 1000.0) < 5.0, f"{mode}: audio peak at {f:.1f} Hz")
        time_step(lambda: rx.process(x), 1, L, fs,
                  f"{mode} receiver, 24.576 Msps", 20, smi)


def phase_offline(receiver, agc):
    """process_offline of 500 blocks (10 s) of 192 kHz int16 I/Q."""
    print("phase 17: offline replay, 500 blocks at 192 kHz", flush=True)
    fs, L, nb, rx_if = 192000, 3840, 500, 48000.0
    n = torch.arange(nb * L, device=DEV, dtype=torch.float64)
    ph = 2 * np.pi * torch.frac(n * ((rx_if + 1000.0) / fs))
    g = torch.Generator(device=DEV).manual_seed(SEED + 17)
    x = 0.2 * torch.stack([torch.cos(ph), torch.sin(ph)], dim=-1) \
        + 0.003 * torch.randn((nb * L, 2), generator=g, device=DEV,
                              dtype=torch.float64)
    x16 = torch.clamp(x * 32767.0, -32768, 32767).to(torch.int16)
    x16 = x16.reshape(nb, L, 2)
    warm = receiver.make_receiver("USB", device=DEV)   # cuFFT plans
    warm.set_freq(rx_if)
    warm.process_offline(x16[:3])
    rx = receiver.make_receiver("USB", device=DEV)
    rx.set_freq(rx_if)
    torch.cuda.synchronize()
    times = []
    for _ in range(2):      # the first call captures the graph of nb blocks
        agc.launches = 0
        t0 = time.perf_counter()
        audio = rx.process_offline(x16)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(agc.launches == nb, f"agc launches {agc.launches} == {nb}")
    dt = times[1]
    print(f"  the first call (warm-up, capture of {nb} blocks, replay) "
          f"{times[0]:.3f} s, capture {rx.graphs[0].capture_s:.3f} s",
          flush=True)
    a = audio.cpu().numpy()
    check(a.shape == (nb, 960) and np.isfinite(a).all(),
          f"audio {a.shape}, finite")
    f = tone_hz(_pcm16(a[-50:].reshape(-1)))
    check(abs(f - 1000.0) < 5.0, f"audio peak at {f:.1f} Hz")
    secs = nb * L / fs
    print(f"  {nb} blocks ({secs:.2f} s of signal) in {dt:.3f} s, one "
          f"replay: {secs / dt:.1f}x real time, {dt / nb * 1e3:.3f} ms/block "
          "(host clock, synchronised)", flush=True)


class _Tee:
    """A stream that keeps what is written through it and passes it on."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def daemon_flags():
    """--cpu where the script is rehearsed on the CPU (DEV = "cpu")."""
    return ["--cpu"] if DEV == "cpu" else []


def run_daemon(fn):
    """fn() (a daemon's main) with KA9Q_BANKD_TIMING=1 and its stderr kept.
    Returns (its result, its stderr, wall seconds)."""
    tee = _Tee(sys.stderr)
    old = os.environ.get("KA9Q_BANKD_TIMING")
    os.environ["KA9Q_BANKD_TIMING"] = "1"
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(tee):
            rc = fn()
    finally:
        if old is None:
            del os.environ["KA9Q_BANKD_TIMING"]
        else:
            os.environ["KA9Q_BANKD_TIMING"] = old
    return rc, "".join(tee.parts), time.perf_counter() - t0


def timing_split(err):
    """The last `bankd timing:` line of a run's stderr as {phase: ms per
    block}, with its block count under "blocks"; None if there is none."""
    lines = [ln for ln in err.splitlines() if ln.startswith("bankd timing:")]
    if not lines:
        return None
    split = {k: float(v) for k, v in re.findall(r"(\w+) (\d+\.\d+)",
                                                 lines[-1])}
    split["blocks"] = int(re.search(r"\((\d+) blocks\)", lines[-1])[1])
    return split


def print_split(label, split, smi):
    parts = ", ".join(f"{k} {split[k]:.3f}" for k in
                      ("read", "poll", "step", "copy", "wait", "emit",
                       "status"))
    print(f"  {label}: {split['total']:.3f} ms/block wall over "
          f"{split['blocks']} blocks ({parts} ms) [{smi}]", flush=True)


def free_ports(n):
    """A base port with `n` free UDP ports above it on 127.0.0.1."""
    while True:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n > 65535:
            continue
        try:
            socks = []
            for p in range(base, base + n):
                socks.append(socket.socket(socket.AF_INET, socket.SOCK_DGRAM))
                socks[-1].bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()


def record(path, blocks, samprate, io_mod):
    """An s16le I/Q recording of `blocks` ((L, 2) int16 tensors), with the
    sample rate in its metadata."""
    with open(path, "wb") as f:
        for x in blocks:
            f.write(x.cpu().numpy().tobytes())
    io_mod.write_metadata(path, {"samplerate": str(int(samprate)),
                                 "frequency": "0.0"})


def raw_pcm(audio):
    """bankd's --pcm-raw bytes of one block's float audio."""
    a = audio.cpu().numpy()
    return np.clip(a * 32767, -32768, 32767).astype("<i2").tobytes()


def phase_bankd_file(bankd, bank_mod, io_mod, ffill, smi, tmp):
    """bankd --iq-file --pcm-raw with 4096 FM channels at 393.216 Msps,
    against ChannelBank.process on the same blocks."""
    print(f"phase 18: bankd --iq-file, {SERVE['n_channels']} FM channels at "
          f"{FS / 1e6:.3f} Msps, {DAEMON_BLOCKS} blocks", flush=True)
    L, M = bankd.derive_geometry(FS)
    check((L, M) == (SERVE["L"], SERVE["M"]),
          f"derive_geometry: L {L}, M {M} (the serving geometry)")
    freqs = bank_freqs(SERVE["n_channels"])
    rec, out = os.path.join(tmp, "wide.iq"), os.path.join(tmp, "bankd.pcm")
    record(rec, [make_block(b, L, freqs, SIGNAL, NO_PL, DEV)
                 for b in range(DAEMON_BLOCKS)], FS, io_mod)
    ffill.launches = 0
    rc, err, wall = run_daemon(lambda: bankd.main(
        ["--iq-file", rec, "-r", str(int(FS)), "--channels",
         str(SERVE["n_channels"]), "-m", "FM", "--pcm-raw", out,
         *daemon_flags()]))
    launches = ffill.launches
    check(rc == 0, f"bankd.main returned {rc} ({wall:.2f} s wall, the bank's "
          "build included)")
    check(launches == 2 * DAEMON_BLOCKS,
          f"ffill launches {launches} == 2 per block x {DAEMON_BLOCKS}")
    split = timing_split(err)
    check(split is not None and split["blocks"] == DAEMON_BLOCKS,
          "KA9Q_BANKD_TIMING split printed")
    if split is not None:
        print_split("bankd --iq-file", split, smi)
    cfg = bank_mod.make_bank_config(len(freqs), "FM", samprate=FS, L=L, M=M)
    bank = bank_mod.ChannelBank(cfg, freqs, device=DEV)
    want = b"".join(raw_pcm(bank.process(blk)[0])
                    for blk in io_mod.IQReader(rec).blocks(L))
    got = open(out, "rb").read()
    check(len(got) == DAEMON_BLOCKS * SERVE["n_channels"] * 960 * 2
          and got == want,
          f"--pcm-raw ({len(got)} bytes) bit-equal to ChannelBank.process on "
          "the same blocks")
    pcm = np.frombuffer(got, "<i2").reshape(DAEMON_BLOCKS,
                                            SERVE["n_channels"], 960)
    for ch in SIGNAL:
        f = tone_hz(pcm[2:, ch].reshape(-1))
        check(abs(f - 1000.0) < 5.0, f"ch {ch}: audio peak at {f:.1f} Hz")
    os.unlink(rec)


def phase_bankd_mixed(bankd, bank_mod, io_mod, status, ffill, agc, smi, tmp):
    """bankd --channel-file: the mixed-mode daemon at bench's first mixed
    row, --spare-slots 1, and a RADIO_MODE command on its command socket
    between blocks; against a MultiBank driven directly with the same
    edit."""
    spec = MIXED_ROWS[0]
    print("phase 19: bankd --channel-file " + " + ".join(
        f"{m}:{n}" for m, n in spec) + f", --spare-slots 1, FM ch "
        f"{MIGRATE_CH} -> USB before block {MIGRATE_AT}", flush=True)
    L = SERVE["L"]
    groups = _mixed_groups(spec)
    chans = os.path.join(tmp, "channels.txt")
    with open(chans, "w") as f:
        for mode, fr in groups:
            f.writelines(f"{x / 1e6:.7f}m {mode}\n" for x in fr)
    fm_f, usb_f, cam_f = (fr for _, fr in groups)
    fm = [(fm_f[c], False) for c in MIXED_FM_SIG]
    carriers = ([(usb_f[c] + 1000.0, False, None) for c in MIXED_USB_SIG]
                + [(cam_f[c] + o * PLL_BIN, True, None)
                   for c, o in MIXED_CAM_SIG.items()])
    rec, out = os.path.join(tmp, "mixed.iq"), os.path.join(tmp, "mixed.pcm")
    record(rec, [make_iq(b, L, FS, SEED + 11, fm=fm, carriers=carriers)
                 for b in range(DAEMON_BLOCKS)], FS, io_mod)
    port = free_ports(3)
    pkt = bytearray([1])
    status.encode_int(pkt, status.StatusType.OUTPUT_SSRC, MIGRATE_CH + 1)
    status.encode_string(pkt, status.StatusType.RADIO_MODE, "USB")
    status.encode_eol(pkt)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    file_source = bankd._file_source

    def source(path, block_len):
        """The recording, with the command sent to the daemon's command
        socket before block MIGRATE_AT is read: the daemon polls it
        between reading that block and stepping it."""
        nxt, n = file_source(path, block_len), [0]

        def next_block():
            if n[0] == MIGRATE_AT:
                tx.sendto(bytes(pkt), ("127.0.0.1", port + 2))
            n[0] += 1
            return nxt()
        return next_block

    ffill.launches = agc.launches = 0
    bankd._file_source = source
    try:
        rc, err, wall = run_daemon(lambda: bankd.main(
            ["--iq-file", rec, "-r", str(int(FS)), "--channel-file", chans,
             "--spare-slots", "1", "-R", f"127.0.0.1:{port}",
             "--pcm-raw", out, *daemon_flags()]))
    finally:
        bankd._file_source = file_source
        tx.close()
    launches = (ffill.launches, agc.launches)
    check(rc == 0, f"bankd.main returned {rc} ({wall:.2f} s wall, the "
          "MultiBank's build included)")
    check(launches == (2 * DAEMON_BLOCKS, 2 * DAEMON_BLOCKS),
          f"ffill launches {launches[0]} == 2 per block (FM group), agc "
          f"launches {launches[1]} == 2 per block (USB and CAM groups)")
    check(f"migrated ssrc {MIGRATE_CH + 1} FM->USB" in err,
          "the daemon took the RADIO_MODE command and migrated the channel")
    split = timing_split(err)
    check(split is not None and split["blocks"] == DAEMON_BLOCKS,
          "KA9Q_BANKD_TIMING split printed")
    if split is not None:
        print_split("bankd --channel-file", split, smi)
    parsed = bankd.read_channel_file(chans)
    padded = [(m, list(fr) + [0.0]) for m, fr in parsed]
    mb = bank_mod.MultiBank(padded, samprate=FS, L=L, M=SERVE["M"],
                            device=DEV)
    for g, (_, fr) in enumerate(padded):        # the spares' commissioning
        mb.init_channel(g, len(fr) - 1, fr[-1])
    want = []
    for b, blk in enumerate(io_mod.IQReader(rec).blocks(L)):
        if b == MIGRATE_AT:
            mb.init_channel(1, len(padded[1][1]) - 1,
                            mb.group_freqs[0][MIGRATE_CH])
        want += [raw_pcm(audio) for audio, _ in mb.process(blk)]
    got = open(out, "rb").read()
    check(got == b"".join(want),
          f"--pcm-raw ({len(got)} bytes) bit-equal to a MultiBank driven "
          "directly with the same edit")
    os.unlink(rec)


def phase_bankd_live(bankd, native, ffill, smi, mesh=0):
    """bankd -I at README's deployment line over 127.0.0.1 unicast, fed by
    the port's native RTPSender at the wire rate.  With `mesh`, bankd --mesh
    at two channels fewer (padded back), a carrier on the last channel, so
    the padding rows that copy it are as loud as a real one: none may take
    an active slot."""
    fs, n_ch = LIVE["samprate"], LIVE["channels"] - (2 if mesh else 0)
    sig = LIVE_SIG if not mesh else (
        tuple(c for c in LIVE_SIG if c < n_ch - 1) + (n_ch - 1,))
    extra = ["--mesh", str(mesh)] if mesh else []
    print(f"phase {'26b' if mesh else 20}: bankd -I {' '.join(extra)}, "
          f"{n_ch} FM channels at {fs / 1e6:.3f} Msps, "
          f"--max-active {LIVE['max_active']}, {LIVE['blocks']} blocks from "
          "the native sender at the wire rate", flush=True)
    L, _ = bankd.derive_geometry(fs)
    freqs = np.linspace(-0.45 * fs, 0.45 * fs, n_ch, endpoint=False)
    # one second of I/Q, which repeats seamlessly: every carrier and tone
    # is a whole number of Hz
    sec = torch.cat([make_iq(b, L, fs, SEED + 20,
                             fm=[(freqs[c], False) for c in sig])
                     for b in range(fs // L)]).cpu().numpy().reshape(-1)
    p_in = free_ports(4)           # I/Q in; PCM out on +1, commands on +3
    p_out = p_in + 1
    stop = threading.Event()
    pcm_rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    pcm_rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 << 20)
    pcm_rx.bind(("127.0.0.1", p_out))
    pcm_rx.settimeout(0.2)
    got = {"packets": 0, "ssrcs": set(), "sent": 0}

    def drain():
        while not stop.is_set():
            try:
                d = pcm_rx.recv(9000)
            except OSError:
                continue
            got["packets"] += 1
            got["ssrcs"].add(int.from_bytes(d[8:12], "big"))

    def send():
        """Paced at the wire rate.  Until the daemon has bound its port a
        send is refused; a new sender then restarts the pacing clock."""
        pkts = -(-len(sec) // 2 // 2048)
        while not stop.is_set():
            tx = native.RTPSender("127.0.0.1", p_in, samprate=fs, ssrc=77)
            while not stop.is_set():
                n = tx.send(sec, pkt_samples=2048)
                got["sent"] += max(n, 0)
                if n < pkts:
                    break
            tx.close()
            stop.wait(0.02)

    result = {}

    def serve():
        result["rc"] = bankd.main(
            ["-I", f"127.0.0.1:{p_in}", "-R", f"127.0.0.1:{p_out}", "-r",
             str(fs), "--channels", str(n_ch), "-m", "FM", "--max-active",
             str(LIVE["max_active"]), "--blocks", str(LIVE["blocks"]),
             *extra, *daemon_flags()])

    emitted, emit = [], bankd.BankDaemon.emit_active

    def emit_active(self, copy, L_dec):
        emitted.append(copy.wait()[1])
        emit(self, copy, L_dec)

    threads = [threading.Thread(target=f, daemon=True) for f in (drain, send)]
    for t in threads:
        t.start()
    daemon = threading.Thread(target=serve, daemon=True)
    ffill.launches = 0
    bankd.BankDaemon.emit_active = emit_active
    try:
        rc, err, wall = run_daemon(lambda: (daemon.start(),
                                            daemon.join(DAEMON_WAIT_S)))
    finally:
        bankd.BankDaemon.emit_active = emit
    launches = ffill.launches
    stop.set()
    for t in threads:
        t.join(5.0)
    pcm_rx.close()
    idx = np.stack(emitted) if emitted else np.zeros((0, 1), np.int32)
    top = int(idx.max()) if idx.size else None
    check(len(idx) == LIVE["blocks"] and top is not None and top < n_ch,
          f"{len(idx)} blocks of active slots emitted, every index below "
          f"{n_ch} (max {top}): no padding row took a slot")
    check(result.get("rc") == 0,
          f"bankd -I served {LIVE['blocks']} blocks and returned "
          f"{result.get('rc')} ({wall:.2f} s wall, build and warm-up "
          f"included; {got['sent']} I/Q packets sent)")
    per = 2 * (mesh or 1)
    check(launches >= per * LIVE["blocks"],
          f"ffill launches {launches} >= {per} per block")
    want = {c + 1 for c in sig}
    check(got["packets"] > 0 and got["ssrcs"] == want,
          f"{got['packets']} PCM packets on -R from SSRCs "
          f"{sorted(got['ssrcs'])} (the signal channels {sorted(want)})")
    split = timing_split(err)
    check(split is not None, "KA9Q_BANKD_TIMING split printed")
    if split is not None:
        print_split(f"bankd -I --max-active {' '.join(extra)}".rstrip(),
                    split, smi)
    return split


def phase_radio(radio, receiver, modulate, io_mod, status, ffill, agc, smi,
                tmp):
    """radio at its defaults on --iq-file recordings, against
    Receiver.process on the same blocks; and its status packet."""
    fs, L, rx_if = 192000, 3840, 48000.0
    print(f"phase 21: radio --iq-file at 192 kHz (L {L}, M 4353), FM, AM, "
          f"USB, {RADIO_BLOCKS} blocks each", flush=True)
    for mode in ("FM", "AM", "USB"):
        source = _rx_source(mode, modulate, rx_if, fs, L)
        blocks = []
        for b in range(RADIO_BLOCKS):
            x = source(b)
            blocks.append(torch.clamp(torch.round(torch.stack(
                [x.real, x.imag], -1) * 32767.0), -32768, 32767)
                .to(torch.int16))
        rec = os.path.join(tmp, f"radio-{mode}.iq")
        out = os.path.join(tmp, f"radio-{mode}.pcm")
        record(rec, blocks, fs, io_mod)
        argv = ["--iq-file", rec, "-f", "48k", "-m", mode, "-S", "1",
                *daemon_flags()]
        ffill.launches = agc.launches = 0
        rc, _, wall = run_daemon(lambda: radio.main(argv
                                                    + ["--pcm-raw", out]))
        launches = ffill.launches if mode == "FM" else agc.launches
        per = (2 if mode == "FM" else 1) * RADIO_BLOCKS
        check(rc == 0 and launches == per,
              f"{mode}: radio.main returned {rc}, "
              f"{'ffill' if mode == 'FM' else 'agc'} launches {launches} == "
              f"{per}; {wall * 1e3 / RADIO_BLOCKS:.3f} ms/block wall "
              f"(the receiver's build included) [{smi}]")
        rx = receiver.Receiver(receiver.make_receiver_config(
            mode, samprate=fs, out_rate=48000, L=L, M=4353, kaiser_beta=3.0),
            device=DEV)
        rx.set_freq(rx_if)
        payloads = []
        pcm = io_mod.PCMOutput(send=lambda dg: payloads.append(dg[12:]),
                               ssrc=1)
        for blk in io_mod.IQReader(rec).blocks(L):
            pcm.send_mono(rx.process(blk)[0].cpu().numpy())
        got = open(out, "rb").read()
        check(len(got) > 0 and got == b"".join(payloads),
              f"{mode}: --pcm-raw ({len(got)} bytes) bit-equal to "
              "Receiver.process on the same blocks")
        f = tone_hz(np.frombuffer(got, ">i2")[-15 * 960:])
        check(abs(f - 1000.0) < 5.0, f"{mode}: audio peak at {f:.1f} Hz")
        args = radio.build_parser().parse_args(argv + ["--blocks", "2"])
        d = radio.RadioDaemon(args)
        sent = []
        d.status_sock = type("Sink", (), {"send": lambda self, b:
                                          sent.append(bytes(b))})()
        d.run_file()
        d.close()
        items = dict(status.decode_packet(sent[0][1:])) if sent else {}
        T = status.StatusType
        check(bool(sent) and sent[0][0] == 0
              and status.decode_double(items[T.RADIO_FREQUENCY]) == rx_if
              and items[T.RADIO_MODE] == mode.encode()
              and status.decode_int(items[T.OUTPUT_SSRC]) == 1
              and T.NOISE_DENSITY in items,
              f"{mode}: status packet decodes ({len(items)} items)")
        os.unlink(rec)


def aprs_frame(ax25):
    """The APRS position report the chain carries (KA9Q-9, 37 22.50 N
    122 00.00 W), built by the port's AX.25 encoders."""
    return ax25.append_crc(ax25.encode_callsign("APRS")
                           + ax25.encode_callsign("KA9Q-9", last=True)
                           + bytes([0x03, 0xF0]) + b"!3722.50N/12200.00W-")


APRS_REPORT = "KA9Q-9: Lat 37.375000 Long -122.000000"


def afsk_period(afsk, frame, seconds):
    """`seconds` of 48 kHz audio: the frame's AFSK-1200 waveform from
    APRS_START_S on, silence around it.  Returns the audio and the
    second at which the frame ends."""
    audio = np.zeros(int(seconds * 48000), np.float32)
    wave = afsk.afsk_modulate(frame, amplitude=1.0)
    start = int(APRS_START_S * 48000)
    audio[start:start + len(wave)] = wave
    return audio, (start + len(wave)) / 48000.0


def fm_cycles(audio, fs):
    """The FM phase, in cycles at rate fs, of 48 kHz audio held for each
    output sample (zero-order hold) at APRS_DEV_HZ deviation."""
    held = torch.as_tensor(audio, dtype=torch.float64,
                           device=DEV).repeat_interleave(int(fs) // 48000)
    return torch.cumsum(held, 0) * (APRS_DEV_HZ / fs)


class _Relay:
    """The AX.25 port: keeps each datagram with its arrival time on the
    host clock and passes it on to `forward` (aprs's port)."""

    def __init__(self, port, forward):
        self.rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.rx.bind(("127.0.0.1", port))
        self.rx.settimeout(0.1)
        self.tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.forward = forward
        self.got = []
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while not self.stop.is_set():
            try:
                d = self.rx.recv(9000)
            except OSError:
                continue
            self.got.append((time.monotonic(), d))
            if self.forward:
                self.tx.sendto(d, ("127.0.0.1", self.forward))

    def close(self):
        self.stop.set()
        self.thread.join(5.0)
        self.rx.close()
        self.tx.close()


def run_thread(fn, res, key):
    """fn() on a thread of its own, its result in res[key]."""
    t = threading.Thread(target=lambda: res.__setitem__(key, fn()),
                         daemon=True)
    t.start()
    return t


def drain_packetd(thread, port, rtp):
    """Send packetd tiny PCM datagrams until its --packets count ends it."""
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    seq = 0
    while thread.is_alive() and seq < 1 << 20:
        for _ in range(200):
            tx.sendto(rtp.RTPHeader(type=rtp.PCM_MONO_PT, seq=seq & 0xFFFF,
                                    timestamp=seq, ssrc=FILLER_SSRC)
                      .to_bytes() + b"\x00\x01", ("127.0.0.1", port))
            seq += 1
        thread.join(0.01)
    thread.join(5.0)
    tx.close()


def phase_aprs_bank(mods, ffill, smi, tmp):
    """APRS end to end through the live bank at README's deployment line:
    iqplay --native -> bankd -I -> packetd -> aprs, all through main()."""
    bankd, native, iqplay, packetd, aprs_app, ax25, afsk, io_mod, rtp = (
        mods[k] for k in ("bankd", "native", "iqplay", "packetd", "aprs",
                          "ax25", "afsk", "io", "rtp"))
    fs, n_ch = LIVE["samprate"], LIVE["channels"]
    L, _ = bankd.derive_geometry(fs)
    per_s = fs // L
    blocks = APRS_SECONDS * per_s - 5
    print(f"phase 22: APRS through iqplay --native -> bankd -I ({n_ch} FM "
          f"channels at {fs / 1e6:.3f} Msps, --max-active "
          f"{LIVE['max_active']}, {blocks} blocks) -> packetd -> aprs; the "
          f"frame on ch {APRS_CH}, tones on ch {list(APRS_TONES)}",
          flush=True)
    freqs = np.linspace(-0.45 * fs, 0.45 * fs, n_ch, endpoint=False)
    frame = aprs_frame(ax25)
    audio, end_s = afsk_period(afsk, frame, 1.0)
    dev = fm_cycles(audio, fs)
    sec = []
    for b in range(per_s):
        x = make_iq(b, L, fs, SEED + 22, fm=[(freqs[c], False)
                                             for c in APRS_TONES])
        n = b * L + torch.arange(L, device=DEV, dtype=torch.float64)
        ph = 2 * np.pi * torch.frac(torch.frac(n * (freqs[APRS_CH] / fs))
                                    + dev[b * L:(b + 1) * L])
        x = x.to(torch.float64)
        x[:, 0] += 0.05 * 32767.0 * torch.cos(ph)
        x[:, 1] += 0.05 * 32767.0 * torch.sin(ph)
        sec.append(torch.clamp(x, -32768, 32767).to(torch.int16))
    rec = os.path.join(tmp, "aprs-wide.iq")
    record(rec, sec * APRS_SECONDS, fs, io_mod)
    del sec, dev
    base = free_ports(6)
    p_iq, p_pcm, p_ax, p_aprs = base, base + 1, base + 4, base + 5
    max_pcm = 2 * LIVE["max_active"] * blocks + 1   # more than bankd sends
    res, pcm = {}, {}
    bound = threading.Event()
    real_rx, real_feed = native.RTPReceiver, packetd.PacketSession.feed

    class BoundReceiver(real_rx):
        """bankd's receive engine; tells the sender when it has bound."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            bound.set()

    def counting_feed(session, hdr, payload):
        """PacketSession.feed, its PCM kept and its CPU time summed for
        every datagram but the fillers."""
        if hdr.ssrc == FILLER_SSRC:
            return real_feed(session, hdr, payload)
        pcm.setdefault(hdr.ssrc, []).append(payload)
        t0 = time.thread_time()
        real_feed(session, hdr, payload)
        res["feed_cpu"] = res.get("feed_cpu", 0.0) + time.thread_time() - t0

    def send():
        if bound.wait(DAEMON_WAIT_S):
            res["t_send"] = time.monotonic()
            return iqplay.main(["-R", f"127.0.0.1:{p_iq}", "--native", "-b",
                                "2048", rec])

    out = _Tee(sys.stdout)
    relay = _Relay(p_ax, p_aprs)
    native.RTPReceiver, packetd.PacketSession.feed = (BoundReceiver,
                                                      counting_feed)
    try:
        with contextlib.redirect_stdout(out):
            t_aprs = run_thread(lambda: aprs_app.main(
                ["-I", f"127.0.0.1:{p_aprs}", "--lat", "37.0", "--lon",
                 "-122.5", "--packets", "1"]), res, "aprs")
            t_pk = run_thread(lambda: packetd.main(
                ["-I", f"127.0.0.1:{p_pcm}", "-R", f"127.0.0.1:{p_ax}", "-v",
                 "--packets", str(max_pcm)]), res, "packetd")
            t_tx = run_thread(send, res, "iqplay")
            daemon = threading.Thread(target=lambda: res.__setitem__(
                "bankd", bankd.main(
                    ["-I", f"127.0.0.1:{p_iq}", "-R", f"127.0.0.1:{p_pcm}",
                     "-r", str(fs), "--channels", str(n_ch), "-m", "FM",
                     "--max-active", str(LIVE["max_active"]), "--blocks",
                     str(blocks), *daemon_flags()])), daemon=True)
            ffill.launches = 0
            _, err, wall = run_daemon(lambda: (daemon.start(),
                                               daemon.join(DAEMON_WAIT_S)))
            launches = ffill.launches
            t_tx.join(DAEMON_WAIT_S)
            drain_packetd(t_pk, p_pcm, rtp)
            t_aprs.join(5.0)
            if t_aprs.is_alive():
                # no frame came: end aprs with a status frame, which leaves
                # the position checks below failing
                stop = ax25.append_crc(
                    ax25.encode_callsign("APRS")
                    + ax25.encode_callsign("STOP", last=True)
                    + bytes([0x03, 0xF0]) + b">no frame decoded")
                relay.tx.sendto(rtp.RTPHeader(type=rtp.AX25_PT).to_bytes()
                                + stop, ("127.0.0.1", p_aprs))
                t_aprs.join(5.0)
    finally:
        native.RTPReceiver, packetd.PacketSession.feed = real_rx, real_feed
        relay.close()
    os.unlink(rec)
    check(all(res.get(k) == 0 for k in ("iqplay", "bankd", "packetd",
                                        "aprs")),
          "iqplay, bankd, packetd and aprs returned 0 ("
          + ", ".join(f"{k} {res.get(k)}" for k in ("iqplay", "bankd",
                                                     "packetd", "aprs"))
          + f"; bankd {wall:.2f} s wall, its build and warm-up included)")
    check(launches >= 2 * blocks,
          f"ffill launches {launches} >= 2 per block x {blocks}")
    got = relay.got[0][1] if relay.got else b""
    check(got[1:2] == bytes([rtp.AX25_PT]) and got[12:] == frame,
          f"the first of {len(relay.got)} AX.25 datagrams is the modulated "
          f"frame, byte for byte ({len(frame)} bytes)")
    check(APRS_REPORT in "".join(out.parts),
          f"aprs printed the frame's position ({APRS_REPORT!r})")
    want = {c + 1 for c in APRS_TONES + (APRS_CH,)}
    check(set(pcm) == want, f"packetd took PCM from SSRCs {sorted(pcm)} "
          f"(the signal channels {sorted(want)})")
    tone = np.frombuffer(b"".join(pcm.get(APRS_TONES[0] + 1, [])), ">i2")
    f = tone_hz(tone[-48000:]) if len(tone) else float("nan")
    check(abs(f - 1000.0) < 5.0,
          f"tone ch {APRS_TONES[0]} still comes out of bankd: audio peak at "
          f"{f:.1f} Hz")
    split = timing_split(err)
    check(split is not None, "KA9Q_BANKD_TIMING split printed")
    if split is not None:
        print_split("bankd -I --max-active (APRS)", split, smi)
    secs = sum(len(p) for ps in pcm.values() for p in ps) / 2 / 48000.0
    if secs:
        print(f"  packetd: {res.get('feed_cpu', 0.0) * 1e3 / secs:.3f} ms of "
              f"CPU per second of PCM in PacketSession.feed (its thread's "
              f"CPU clock) over {secs:.2f} channel-seconds, {len(pcm)} "
              f"sessions [{smi}]", flush=True)
    if relay.got and "t_send" in res:
        # the frame's last sample leaves the paced sender end_s after its
        # start in each second of signal
        t = relay.got[0][0] - res["t_send"] - end_s
        k = max(0, int(t // 1.0))
        print(f"  decode latency {(t - k) * 1e3:.1f} ms, from the last I/Q "
              f"sample of the frame's airing {k + 1} leaving the sender (its "
              "pacing clock) to the AX.25 datagram arriving (host clock) "
              f"[{smi}]", flush=True)


def multicast_loopback(port, mc):
    """True when one datagram sent to a multicast group arrives at a
    socket joined to it on this host."""
    grp = f"239.77.23.9:{port}"
    try:
        rx = mc.setup_mcast(grp, output=False)
        tx = mc.setup_mcast(grp, output=True)
    except OSError:
        return False
    rx.settimeout(1.0)
    try:
        tx.send(b"probe")
        return rx.recv(64) == b"probe"
    except OSError:
        return False
    finally:
        rx.close()
        tx.close()


def phase_aprs_radio(mods, ffill, smi, tmp):
    """APRS end to end at radio's defaults: frontend --iq-file -> radio -I
    -> packetd; iqrecord -d 1 -> radio --iq-file; modulate -m usb."""
    (frontend, fe_model, radio, iqrecord, packetd, modulate_app, modulate,
     afsk, ax25, io_mod, rtp, status, mc) = (mods[k] for k in (
        "frontend", "fe_model", "radio", "iqrecord", "packetd",
        "modulate_app", "modulate", "afsk", "ax25", "io", "rtp", "status",
        "multicast"))
    fs = 192000
    print(f"phase 23: APRS through frontend --iq-file -> radio -I -> packetd "
          f"at 192 kHz (L 3840, M 4353, {FE_RADIO_BLOCKS} blocks); iqrecord "
          "-d 1 -> radio --iq-file; modulate -m usb", flush=True)
    base = free_ports(10)
    # frontend and radio -I share data port + 2 for commands and status;
    # over 127.0.0.1 the two sockets bound there would split its datagrams
    # between them, so the control loop needs a multicast group
    mcast = multicast_loopback(base + 9, mc)
    check(mcast, "a datagram sent to a multicast group on this host "
          "arrived (the front end's control loop runs over one)")
    if not mcast:
        return
    data, data2 = f"239.77.23.1:{base}", f"239.77.23.2:{base + 3}"
    p_pcm = base + 6                    # radio's RTCP on +1, status on +2
    frame = aprs_frame(ax25)
    audio, _ = afsk_period(afsk, frame, FE_PERIOD_S)
    cyc = fm_cycles(audio, fs).cpu().numpy()
    n = np.arange(len(cyc))
    rng = np.random.default_rng(SEED + 23)
    iq = 0.1 * np.exp(2j * np.pi * (n * (FE_IF / fs) + cyc)) + 0.003 * (
        rng.standard_normal(len(n)) + 1j * rng.standard_normal(len(n)))
    x = np.empty((len(n), 2), np.int16)
    x[:, 0], x[:, 1] = np.round(iq.real * 32767), np.round(iq.imag * 32767)
    rec = os.path.join(tmp, "aprs-192k.iq")
    x.tofile(rec)
    io_mod.write_metadata(rec, {"samplerate": str(fs),
                                "frequency": f"{FE_CENTER:.1f}"})
    rf = FE_CENTER + FE_IF
    lo1 = rf + fs / 4                   # the LO1 radio asks for (LO2 fs/4)
    res = {}
    ax = _Relay(0, None)
    p_ax = ax.rx.getsockname()[1]
    watch = mc.setup_mcast(data, output=False, offset=2)
    max_pcm = 2 * (FE_RADIO_BLOCKS + 1) + 1
    t_pk = run_thread(lambda: packetd.main(
        ["-I", f"127.0.0.1:{p_pcm}", "-R", f"127.0.0.1:{p_ax}", "-v",
         "--packets", str(max_pcm)]), res, "packetd")
    t_fe = run_thread(lambda: frontend.main(
        ["-R", data, "-f", f"{FE_CENTER:.0f}", "--iq-file", rec,
         "--seconds", str(FE_SECONDS)]), res, "frontend")
    time.sleep(0.2)
    ffill.launches = 0
    t0 = time.perf_counter()
    t_rx = run_thread(lambda: radio.main(
        ["-I", data, "-R", f"127.0.0.1:{p_pcm}", "-f", f"{rf:.0f}", "-m",
         "FM", "-S", "1", "--blocks", str(FE_RADIO_BLOCKS),
         *daemon_flags()]), res, "radio")
    t_rx.join(FE_SECONDS + DAEMON_WAIT_S)
    wall = time.perf_counter() - t0
    launches = ffill.launches
    t_fe.join(FE_SECONDS + 5.0)
    drain_packetd(t_pk, p_pcm, rtp)
    ax.close()
    check(all(res.get(k) == 0 for k in ("frontend", "radio", "packetd")),
          f"frontend, radio -I and packetd returned 0 (frontend "
          f"{res.get('frontend')}, radio {res.get('radio')}, packetd "
          f"{res.get('packetd')}; radio {wall:.2f} s wall)")
    check(launches == 2 * (FE_RADIO_BLOCKS + 1),
          f"ffill launches {launches} == 2 per radio block x "
          f"{FE_RADIO_BLOCKS}, its warm-up block included")
    got = ax.got[0][1] if ax.got else b""
    check(got[12:] == frame,
          f"packetd sent the modulated frame first, byte for byte "
          f"({len(ax.got)} AX.25 datagrams)")
    T = status.StatusType
    cmds, fe_status = [], {}
    watch.setblocking(False)
    while True:
        try:
            d = watch.recv(9000)
        except OSError:
            break
        items = dict(status.decode_packet(d[1:]))
        if d[:1] == b"\x01" and T.RADIO_FREQUENCY in items:
            cmds.append(status.decode_double(items[T.RADIO_FREQUENCY]))
        elif d[:1] == b"\x00":
            fe_status.update(items)
    watch.close()
    actual = (status.decode_double(fe_status[T.RADIO_FREQUENCY])
              if T.RADIO_FREQUENCY in fe_status else None)
    commands = (status.decode_int(fe_status[T.COMMANDS])
                if T.COMMANDS in fe_status else 0)
    check(lo1 in cmds and commands >= 1
          and actual == fe_model.fcd_actual_frequency(lo1),
          f"radio commanded LO1 {lo1:.0f} Hz on the wire ({len(cmds)} "
          f"commands), the front end took {commands} and reports LO1 "
          f"{actual} Hz, the MSi001's quantisation of it")

    # iqrecord -d 1 on the front end's stream, then radio on the recording
    rec_dir = os.path.join(tmp, "iqrecord")
    os.makedirs(rec_dir)
    t_rec = run_thread(lambda: iqrecord.main(
        ["-I", data2, "-D", rec_dir, "-d", "1"]), res, "iqrecord")
    time.sleep(0.3)
    res["frontend2"] = frontend.main(["-R", data2, "-f", f"{FE_CENTER:.0f}",
                                      "--iq-file", rec, "--seconds", "1.3"])
    t_rec.join(5.0)
    names = [f for f in os.listdir(rec_dir) if not f.endswith(".attrs")]
    meta = (io_mod.read_metadata(os.path.join(rec_dir, names[0]))
            if len(names) == 1 else {})
    check(res.get("iqrecord") == 0 and res.get("frontend2") == 0
          and len(names) == 1 and meta.get("samplerate") == str(fs),
          f"iqrecord -d 1 returned {res.get('iqrecord')}: {names}, "
          f"samplerate {meta.get('samplerate')}, frequency "
          f"{meta.get('frequency')}")
    if len(names) == 1:
        path = os.path.join(rec_dir, names[0])
        out = os.path.join(tmp, "aprs-radio.pcm")
        ffill.launches = 0
        rc = radio.main(["--iq-file", path, f"--frequency={FE_IF / 1e3:.0f}k",
                         "-m", "FM", "-S", "1", "--pcm-raw", out,
                         *daemon_flags()])
        nblk = -(-os.path.getsize(path) // (4 * 3840))  # tail zero-padded
        frames = afsk.AFSKDemodulator().process(
            np.frombuffer(open(out, "rb").read(), ">i2").astype(np.float32)
            / 32767.0)
        check(rc == 0 and ffill.launches == 2 * nblk and frame in frames,
              f"radio --iq-file on the recording returned {rc}, ffill "
              f"launches {ffill.launches} == 2 x {nblk} blocks, frames "
              f"{[len(f) for f in frames]} hold the modulated one")

    # modulate -m usb on the card against the Modulator on the CPU
    rng = np.random.default_rng(SEED + 24)
    tt = np.arange(6 * 240) / 48000.0
    a16 = (0.5 * np.sin(2 * np.pi * 1000.0 * tt) * 32767
           + rng.standard_normal(len(tt)) * 200).astype("<i2")
    buf = type("Stream", (), {})
    fin, fout = buf(), buf()
    fin.buffer, fout.buffer = io.BytesIO(a16.tobytes()), io.BytesIO()
    stdin, stdout = sys.stdin, sys.stdout
    sys.stdin, sys.stdout = fin, fout
    try:
        rc = modulate_app.main(["-m", "usb", *daemon_flags()])
    finally:
        sys.stdin, sys.stdout = stdin, stdout
    got = np.frombuffer(fout.buffer.getvalue(), np.int16)
    m = modulate.Modulator("usb", frequency=48000.0, amplitude_db=-20.0,
                           samprate=fs, device="cpu")
    want = np.frombuffer(b"".join(
        m.to_int16(m.process(a16[i:i + 240].astype(np.float32) / 32767.0))
        for i in range(0, len(a16), 240)), np.int16)
    err = (int(np.abs(got.astype(np.int32) - want).max())
           if len(got) == len(want) else None)
    check(rc == 0 and err is not None and err <= 1,
          f"modulate -m usb on the {DEV} returned {rc}: {len(got)} int16 "
          f"within {err} LSB of the Modulator on the CPU")
    os.unlink(rec)


def chain_second(fs, L, carriers):
    """One second of phase 24's I/Q, made on the device from the seed: a
    little complex noise plus FM carriers (freq Hz, tone Hz or None) at
    CHAIN['dev'] deviation, each tone at a random phase (tones in phase
    on a 50 Hz grid would sum to a 20 ms pulse train in a mix).  Every
    carrier and tone is a whole number of Hz, so the second repeats
    seamlessly."""
    out = []
    phases = np.random.default_rng(SEED + 24).uniform(0, 1, len(carriers))
    for b in range(fs // L):
        g = torch.Generator(device=DEV).manual_seed(SEED + 24 + b)
        n = b * L + torch.arange(L, device=DEV, dtype=torch.float64)
        x = 0.003 * torch.randn((L, 2), generator=g, device=DEV,
                                dtype=torch.float32).to(torch.float64)
        for (f, tone), p in zip(carriers, phases):
            ph = 2 * np.pi * torch.frac(n * (f / fs))
            if tone:
                ph = ph + CHAIN["dev"] / tone * torch.sin(
                    2 * np.pi * torch.frac(n * (tone / fs) + p))
            x[:, 0] += 0.02 * torch.cos(ph)
            x[:, 1] += 0.02 * torch.sin(ph)
        out.append(torch.clamp(x * 32767.0, -32768, 32767).to(torch.int16))
    return torch.cat(out).cpu().numpy().reshape(-1)


def rtp_sessions(caps, group, rtp):
    """Per SSRC, the (arrival, header, payload) of one captured group's
    datagrams, in arrival order."""
    out = {}
    for t, i, d in caps:
        if i != group:
            continue
        try:
            h, off = rtp.RTPHeader.from_bytes(d)
        except ValueError:
            continue
        out.setdefault(h.ssrc, []).append((t, h, rtp.rtp_payload(h, d, off)))
    return out


def laid_out(items, t_lo, t_hi):
    """The float audio of (arrival, RTP timestamp, samples) items that
    arrived in [t_lo, t_hi), placed on the RTP clock (zeros in gaps)."""
    sel = [(ts, a) for t, ts, a in items if t_lo <= t < t_hi]
    if not sel:
        return np.zeros(0)
    ts0 = min(ts for ts, _ in sel)
    out = np.zeros(max(ts - ts0 + len(a) for ts, a in sel))
    for ts, a in sel:
        out[ts - ts0:ts - ts0 + len(a)] = a
    return out


def tone_peak(audio, rate=48000.0):
    """The strongest line above 100 Hz, and its level in dB over the
    median bin."""
    if len(audio) < 256:
        return float("nan"), 0.0
    spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
    f = np.fft.rfftfreq(len(audio), 1.0 / rate)
    spec, f = spec[f >= 100.0], f[f >= 100.0]
    i = int(np.argmax(spec))
    return f[i], 20 * np.log10(spec[i] / max(np.median(spec), 1e-30))


def line_db(audio, hz, rate=48000.0):
    """The level of the bin nearest `hz`, in dB over the median bin."""
    spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
    i = int(round(hz * len(audio) / rate))
    return 20 * np.log10(spec[i - 1:i + 2].max()
                         / max(np.median(spec), 1e-30))


def proc_cpu_s(pid):
    """User + system CPU seconds of a process, from /proc/<pid>/stat."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def stop_procs(procs):
    """SIGINT each subprocess (the daemons' Ctrl-C), then kill what is
    left after 10 s."""
    for p in procs.values():
        if p.poll() is None:
            p.send_signal(signal.SIGINT)
    for p in procs.values():
        try:
            p.wait(10.0)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(5.0)


def phase_chain(mods, ffill, smi, live_split, tmp):
    """The deployment chain on the card: bankd -I (in-process, fed at the
    wire rate) -> opusd -> monitor, with pcmcat on the PCM group and
    control retuning a channel mid-run, over multicast groups."""
    t_phase = time.monotonic()
    bankd, native, control, mc, rtp, opus_codec = (mods[k] for k in (
        "bankd", "native", "control", "multicast", "rtp", "opus_codec"))
    fs, n_ch, n_act = LIVE["samprate"], LIVE["channels"], LIVE["max_active"]
    L, _ = bankd.derive_geometry(fs)
    blocks = CHAIN["blocks"]
    opus = opus_codec.OPUS_AVAILABLE
    print(f"phase 24: the deployment chain, bankd -I ({n_ch} FM channels at "
          f"{fs / 1e6:.3f} Msps, --max-active {n_act}, {blocks} blocks) -> "
          f"opusd {' '.join(OPUSD_FLAGS)} -> monitor, pcmcat on the PCM "
          "group, control retuning a channel mid-run", flush=True)
    if not opus:
        print("  opus: libopus absent on this machine", flush=True)
        print("  the Opus legs wait on the library: opusd and its checks "
              "(native engine, each tone on the Opus group, DTX), its CPU, "
              "counters and latency; pcmcat, monitor and control run on the "
              "PCM group, and the retune is read there", flush=True)
    base = free_ports(8)
    if not check(multicast_loopback(base + 7, mc),
                 "a datagram sent to a multicast group on this host arrived "
                 "(the chain runs over groups)"):
        return
    g_pcm = f"239.77.24.1:{base + 1}"        # status and commands on +2
    g_opus = f"239.77.24.2:{base + 5}"
    freqs = np.linspace(-0.45 * fs, 0.45 * fs, n_ch, endpoint=False)
    step = n_ch // n_act
    chans = [CHAIN["first"] + step * k for k in range(n_act - 1)]
    tones = {c: CHAIN["tone0"] + CHAIN["tone_step"] * k
             for k, c in enumerate(chans[:-1])}
    quiet, moved = chans[-1], chans[min(CHAIN["retune"], len(chans) - 2)]
    f_new = (freqs[5] + freqs[6]) / 2
    ssrc = moved + 1
    sec = chain_second(fs, L, [(freqs[c], tones.get(c)) for c in chans]
                       + [(f_new, CHAIN["new_tone"])])
    print(f"  {len(tones)} tone carriers ({CHAIN['tone0']:.0f}-"
          f"{max(tones.values()):.0f} Hz), ch {quiet} unmodulated, "
          f"{CHAIN['new_tone']:.0f} Hz at {f_new:.0f} Hz between ch 5 and "
          f"6; ch {moved} (SSRC {ssrc}, {tones[moved]:.0f} Hz) moves there",
          flush=True)
    root = os.path.dirname(os.path.abspath(__file__))
    paths = {k: os.path.join(tmp, f"chain-{k}") for k in (
        "caps", "pcmcat", "mix", "monitor.err", "opusd.err")}
    files, procs, res = [], {}, {}

    def spawn(name, args, out=subprocess.DEVNULL, err=subprocess.DEVNULL):
        procs[name] = subprocess.Popen([sys.executable, *args], cwd=root,
                                       stdout=out, stderr=err)
        return procs[name]

    def log(name, mode="wb"):
        files.append(open(paths[name], mode))
        return files[-1]

    bound, stop = threading.Event(), threading.Event()
    rx_stats, cpu = {}, []
    real_rx = native.RTPReceiver

    class BoundReceiver(real_rx):
        """bankd's receive engine: tells the sender when it has bound,
        and keeps its counters when the daemon closes it."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            bound.set()

        def close(self):
            if self._h:
                rx_stats.update(self.stats())
            super().close()

    def send():
        """Paced at the wire rate from the moment bankd has bound."""
        if not bound.wait(DAEMON_WAIT_S):
            return
        pkts = -(-len(sec) // 2 // 2048)
        res["t_send"] = time.monotonic()
        while not stop.is_set():
            tx = native.RTPSender("127.0.0.1", base, samprate=fs, ssrc=24)
            while not stop.is_set():
                if tx.send(sec, pkt_samples=2048) < pkts:
                    break
            tx.close()
            stop.wait(0.02)

    def sample_cpu():
        """The listeners' CPU seconds every 0.25 s while they run."""
        while not stop.is_set():
            now = time.monotonic()
            for name in ("monitor", "opusd"):
                if name in procs and procs[name].poll() is None:
                    try:
                        cpu.append((name, now, proc_cpu_s(procs[name].pid)))
                    except OSError:
                        pass
            stop.wait(0.25)

    daemon = threading.Thread(target=lambda: res.__setitem__(
        "bankd", bankd.main(["-I", f"127.0.0.1:{base}", "-R", g_pcm, "-r",
                             str(fs), "--channels", str(n_ch), "-m", "FM",
                             "--max-active", str(n_act), "--blocks",
                             str(blocks), *daemon_flags()])), daemon=True)
    threads = [threading.Thread(target=send, daemon=True)]

    def orchestrate():
        """bankd and the sender start; control retunes `moved` at
        retune_s into the stream and reads it back."""
        daemon.start()
        threads[0].start()
        if not bound.wait(DAEMON_WAIT_S):
            return
        while "t_send" not in res and daemon.is_alive():
            time.sleep(0.01)
        t_retune = res.get("t_send", 0.0) + CHAIN["retune_s"]
        while time.monotonic() < t_retune and daemon.is_alive():
            time.sleep(0.005)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res["t_cmd"] = time.monotonic()
            res["tune"] = control.main([g_pcm, "--ssrc", str(ssrc),
                                        f"--tune={f_new:.0f}"])
            t0 = time.monotonic()
            res["once"] = control.main([g_pcm, "--ssrc", str(ssrc),
                                        "--once", "--seconds", "4"])
            res["once_s"] = time.monotonic() - t0
        res["control_out"] = out.getvalue()
        daemon.join(DAEMON_WAIT_S + blocks * 0.02)

    try:
        cap = spawn("capture", ["-c", CAPTURE, paths["caps"], g_pcm,
                                g_opus], out=subprocess.PIPE)
        ready = cap.stdout.readline().strip() == b"ready"
        spawn("pcmcat", ["-m", "ka9q_sdr_tpu_torch.apps.pcmcat", g_pcm,
                         "-s", str(ssrc)], out=log("pcmcat"))
        # monitor mixes from before the stream to after it: its first
        # sound is the first PCM datagram, which places the retune
        spawn("monitor", ["-m", "ka9q_sdr_tpu_torch.apps.monitor", g_pcm,
                          "-v", "--seconds", str(CHAIN["monitor_s"])],
              out=log("mix"), err=log("monitor.err"))
        if opus:
            spawn("opusd", ["-m", "ka9q_sdr_tpu_torch.apps.opusd", "-I",
                            g_pcm, "-R", g_opus, *OPUSD_FLAGS, "-v"],
                  err=log("opusd.err"))
        threads.append(threading.Thread(target=sample_cpu, daemon=True))
        threads[-1].start()
        time.sleep(2.5)                  # the subprocesses join their groups
        native.RTPReceiver = BoundReceiver
        ffill.launches = 0
        _, err, wall = run_daemon(orchestrate)
        launches = ffill.launches
        try:
            procs["monitor"].wait(CHAIN["monitor_s"] + 10.0)
        except subprocess.TimeoutExpired:
            pass
        time.sleep(0.5)                  # the last datagrams land
    finally:
        native.RTPReceiver = real_rx
        stop.set()
        for t in threads:
            t.join(5.0)
        stop_procs(procs)
        for f in files:
            f.close()
    check(ready, "the capture process joined the PCM and Opus groups")
    check(res.get("bankd") == 0,
          f"bankd -I served {blocks} blocks and returned {res.get('bankd')} "
          f"({wall:.2f} s wall, build and warm-up included)")
    check(launches >= 2 * blocks,
          f"ffill launches {launches} >= 2 per block x {blocks}")
    split = timing_split(err)
    check(split is not None and split["blocks"] == blocks
          and rx_stats.get("overruns", 1) == 0
          and rx_stats.get("drops", 1) == 0,
          f"bankd kept the wire rate: {rx_stats.get('blocks')} blocks "
          f"assembled, {rx_stats.get('drops')} I/Q packets lost, "
          f"{rx_stats.get('overruns')} ring overruns")
    if split is not None:
        print_split("bankd -I --max-active (chain)", split, smi)
    if live_split is not None:
        print_split("bankd -I --max-active (phase 20, this call)",
                    live_split, smi)
    if "t_send" not in res or "t_cmd" not in res:
        check(False, "the stream started and control ran")
        return
    t_send, t_cmd = res["t_send"], res["t_cmd"]
    t_stop = t_send + blocks * L / fs

    with open(paths["caps"], "rb") as f:
        caps = pickle.load(f)
    pcm = rtp_sessions(caps, 0, rtp)
    want = {c + 1 for c in tones}
    check(want <= set(pcm) <= {c + 1 for c in chans},
          f"PCM on the group from {len(pcm)} SSRCs: every tone channel's "
          f"{len(want)}, none off the carriers")
    pcm_items = {s: [(t, h.timestamp,
                      np.frombuffer(p, ">i2").astype(np.float64) / 32767.0)
                     for t, h, p in v] for s, v in pcm.items()}
    streams = {"PCM": pcm_items}
    if opus:
        ops = rtp_sessions(caps, 1, rtp)
        dec_items = {}
        for s, v in ops.items():
            dec = opus_codec.OpusDecoder()
            dec_items[s] = [(t, h.timestamp, dec.decode(p)[:, 0]
                             .astype(np.float64)) for t, h, p in v]
        streams["Opus"] = dec_items
        err_o = open(paths["opusd.err"]).read()
        stats = [ln for ln in err_o.splitlines() if ln.startswith("{")]
        check(stats and "falling back" not in err_o,
              f"opusd ran the native engine ({len(stats)} counter lines "
              "from -v, no fallback to the Python loop)")
    for name, items in streams.items():
        before = (t_send + 0.5, t_cmd)
        after = (t_cmd + 0.6, t_stop + 1.0)
        bad, worst = [], float("inf")
        for c, tone in tones.items():
            f, db = tone_peak(laid_out(items.get(c + 1, []), *before))
            worst = min(worst, db)
            if not (abs(f - tone) < 3.0 and db >= 20.0):
                bad.append((c, round(f, 1), round(db, 1)))
        check(not bad, f"{name}: every tone SSRC ({len(tones)}) shows its "
              f"tone as the peak before the retune, >= 20 dB over the median "
              f"bin (least {worst:.1f} dB){'; off: ' + str(bad[:5]) if bad else ''}")
        kept = []
        for c, tone in tones.items():
            if c == moved:
                continue
            f, db = tone_peak(laid_out(items.get(c + 1, []), *after))
            if not (abs(f - tone) < 3.0 and db >= 20.0):
                kept.append((c, round(f, 1), round(db, 1)))
        f_b, db_b = tone_peak(laid_out(items.get(ssrc, []), *before))
        f_a, db_a = tone_peak(laid_out(items.get(ssrc, []), *after))
        check(abs(f_b - tones[moved]) < 3.0
              and abs(f_a - CHAIN["new_tone"]) < 3.0 and db_a >= 20.0
              and not kept,
              f"{name}: SSRC {ssrc} peaks at {f_b:.1f} Hz before the retune "
              f"and {f_a:.1f} Hz ({db_a:.1f} dB) after it; every other tone "
              f"SSRC keeps its tone{'; not: ' + str(kept[:5]) if kept else ''}")
        # the command to the first 10 ms of the new tone on the wire
        new = None
        for t, _, a in items.get(ssrc, []):
            if t > t_cmd and len(a) >= 240:
                spec = np.abs(np.fft.rfft(a * np.hanning(len(a)), 8192))
                if abs(np.argmax(spec) * 48000 / 8192
                       - CHAIN["new_tone"]) < 60.0:
                    new = t
                    break
        print(f"  {name}: control command to SSRC {ssrc}'s new tone on the "
              f"group: " + (f"{(new - t_cmd) * 1e3:.1f} ms" if new else
                            "not seen") + f" (host clock) [{smi}]",
              flush=True)
    if opus:
        # opusd's output against the Python transcoder (deploy/opus-vhf's
        # flags) on the PCM datagrams the capture saw: this holds its DTX
        # to libopus's own decision on the same audio
        same, sent = 0, {}
        for s, v in pcm.items():
            ref = []
            tc = mods["transcode"].OpusTranscoder(send=ref.append,
                                                  bitrate=32000, dtx=True)
            for _, h, p in v:
                tc.feed_packet(h.to_bytes() + p)
            got_o = [h.to_bytes() + p for _, h, p in ops.get(s, [])]
            same += got_o == ref
            sent[s] = len(got_o)
        q = quiet + 1
        n_frames = sum(len(p) // 2 for _, _, p in pcm.get(q, [])) // 960
        check(same == len(pcm),
              f"Opus: opusd's stream equals the Python transcoder's on the "
              f"captured PCM for {same} of {len(pcm)} SSRCs; the unmodulated "
              f"SSRC {q} sent {sent.get(q)} packets for {n_frames} frames of "
              f"its PCM ({n_frames - sent.get(q, 0)} suppressed by DTX)")
        last = ast.literal_eval(stats[-1]) if stats else {}
        print(f"  opusd: packets_in {last.get('packets_in')}, packets_out "
              f"{last.get('packets_out')}, frames {last.get('frames')}, "
              f"resets {last.get('resets')}, sessions "
              f"{last.get('sessions')} [{smi}]", flush=True)
        lat = []
        for s, v in ops.items():
            starts = {h.timestamp: t for t, h, _ in pcm.get(s, [])}
            if not starts:
                continue
            ts0 = min(starts)
            ends = {ts + 479: t for ts, t in starts.items()}
            for t, h, _ in v:
                t_pcm = ends.get(ts0 + h.timestamp + 959)
                if t_pcm is not None:
                    lat.append(t - t_pcm)
        if lat:
            print(f"  opusd added latency: median "
                  f"{np.median(lat) * 1e3:.3f} ms, p99 "
                  f"{np.percentile(lat, 99) * 1e3:.3f} ms over {len(lat)} "
                  "frames (Opus packet arrival less the arrival of the PCM "
                  f"packet that completes its frame, host clock) [{smi}]",
                  flush=True)
    for name in ("monitor", "opusd"):
        win = [(t, c) for n, t, c in cpu
               if n == name and t_send + 1.0 <= t <= t_stop - 0.2]
        if len(win) >= 2:
            (ta, ca), (tb, cb) = win[0], win[-1]
            print(f"  {name}: {(cb - ca) / (tb - ta) / len(pcm) * 1e3:.3f} "
                  f"ms of CPU per session-second (/proc, {tb - ta:.2f} s "
                  f"steady window, {len(pcm)} sessions) [{smi}]", flush=True)
    text = res.get("control_out", "")
    check(res.get("tune") == 0 and res.get("once") == 0
          and f"Freq {f_new:,.3f} Hz" in text,
          f"control --tune and --once returned {res.get('tune')}, "
          f"{res.get('once')}; --once shows "
          f"{[ln for ln in text.splitlines() if ln.startswith('Freq')]} "
          f"after {res.get('once_s', float('nan')):.2f} s")
    # pcmcat -s against the captured payloads, gaps zero-filled, from the
    # first datagram pcmcat itself took: it joined 2.5 s before the
    # stream, so it may miss at most PCMCAT_JOIN_SLACK at the head
    def pcmcat_bytes(pkts):
        state, out = rtp.RTPState(), bytearray()
        for _, h, p in pkts:
            gap = rtp.rtp_process(state, h, len(p) // 2)
            if gap < 0:
                continue
            out += bytes(2 * min(gap, 48000))
            out += np.frombuffer(p, ">i2").astype(np.int16).tobytes()
        return bytes(out)

    got = open(paths["pcmcat"], "rb").read()
    mine = pcm.get(ssrc, [])
    skip = next((k for k in range(min(PCMCAT_JOIN_SLACK + 1, len(mine)))
                 if pcmcat_bytes(mine[k:]) == got), None)
    check(len(got) > 0 and skip is not None,
          f"pcmcat -s {ssrc} wrote {len(got)} bytes, equal sample for sample "
          f"to the {len(mine)} captured payloads (gaps filled) from payload "
          f"{skip} on, where it joined (at most {PCMCAT_JOIN_SLACK} missed)")
    # monitor: length, the new tone in the mix, its summary
    mix = np.frombuffer(open(paths["mix"], "rb").read(), np.int16)
    chunks = len(mix) / 2 / 960
    check(abs(chunks - CHAIN["monitor_s"] / 0.02) <= 2,
          f"monitor --seconds {CHAIN['monitor_s']} wrote {chunks:.1f} "
          f"chunks of 20 ms 48 kHz stereo ({CHAIN['monitor_s'] / 0.02:.0f} "
          "+- 2)")
    left = mix[0::2].astype(np.float64) / 32767.0
    # the mix's first sound is the first PCM datagram's arrival plus the
    # playout delay; the retune and the stream's end sit after it on the
    # host clock
    t_first = min((v[0][0] for v in pcm.values() if v), default=t_send)
    i0 = int(np.argmax(left != 0.0))
    at = lambda t: i0 + int((t - t_first) * 48000)          # noqa: E731
    pre = left[i0 + 14400:max(at(t_cmd) - 14400, i0 + 14400)]
    post = left[at(t_cmd) + 28800:at(t_stop)]
    if len(pre) >= 4800 and len(post) >= 4800:
        lb, la = line_db(pre, CHAIN["new_tone"]), line_db(post,
                                                          CHAIN["new_tone"])
    else:
        lb = la = float("nan")
    check(la >= 20.0 and la >= lb + 10.0,
          f"monitor's mix shows the new {CHAIN['new_tone']:.0f} Hz tone "
          f"after the retune: {la:.1f} dB over the median bin ({lb:.1f} dB "
          "before)")
    summary = open(paths["monitor.err"]).read().strip().splitlines()
    print(f"  {summary[-1] if summary else 'monitor: no summary'} [{smi}]",
          flush=True)
    print(f"  phase 24 took {time.monotonic() - t_phase:.1f} s", flush=True)


#: the sharded phases (25-26): the card stands in for a mesh of MESH_D
#: shards (a list that repeats one card runs the sharded code on it); the
#: blocks compared sharded against unsharded; the channels of bankd
#: --mesh's recording at the live line's rate (not divisible by MESH_D)
MESH_D, SHARD_BLOCKS, MESH_FILE_CH, MESH_FILE_BLOCKS = 4, 20, 1022, 8
#: the soak (phase 29)
SOAK = dict(channels=5120, seconds=30)


def _worst(a, r, rtol):
    """max(|a - r| - rtol |r|), which atol must cover, and max |a - r|."""
    d = torch.abs(a.to(torch.float32) - r.to(torch.float32))
    return (float(torch.max(d - rtol * torch.abs(r.to(torch.float32)))),
            float(torch.max(d)))


def phase_sharded(bank_mod, mesh_mod, ffill, agc, smi, freqs, cards=False):
    """The bank with its channel axis sharded over MESH_D shards of the
    card (or, with `cards`, over the machine's first MESH_D cards), at the
    full serving width, against the unsharded bank on the (first) card:
    FM+PL (replicated master FFT), FM+PL with the distributed master FFT
    (shard_fft), and CAM through the AGC kernel."""
    n_ch, L, M = SERVE["n_channels"], SERVE["L"], SERVE["M"]
    mesh = mesh_mod.make_channel_mesh(
        MESH_D if cards else None, devices=None if cards else [DEV] * MESH_D)
    where = (f"{MESH_D} cards" if cards
             else f"{MESH_D} shards of one card")
    print(f"phase 25{'c' if cards else ''}: the sharded bank, {n_ch} channels "
          f"x {FS / 1e6:.3f} Msps (N = 2^24) on {where}, {SHARD_BLOCKS} "
          f"blocks against the unsharded bank", flush=True)
    cam_carriers = [(freqs[c] + o * PLL_BIN, True, None)
                    for c, o in CAM_SIGNAL.items()]
    cases = (("FM+PL", "FM", False, 2e-5, 1e-5, 0, ffill, 2),
             ("FM+PL shard_fft", "FM", True, 3e-5, 1e-4, 0, ffill, 2),
             ("CAM", "CAM", False, 2e-5, 1e-5, 1, agc, 1))
    for label, mode, shard_fft, atol, rtol, first, kmod, per in cases:
        cfg = bank_mod.make_bank_config(n_ch, mode, samprate=FS, L=L, M=M,
                                        enable_pl=mode == "FM")
        flat = bank_mod.ChannelBank(cfg, freqs, device=DEV)
        sb = bank_mod.ChannelBank(cfg, freqs, mesh=mesh, shard_fft=shard_fft)

        def block(b):
            if mode == "FM":
                return make_block(b, L, freqs, SIGNAL, NO_PL, DEV)
            return make_am_block(b, L, FS, cam_carriers, DEV)

        worst, diff, launches = -1.0, 0.0, 0
        r0 = _replays(sb)
        for b in range(SHARD_BLOCKS):
            x = block(b)
            k0 = kmod.launches
            a, _ = sb.process_i16(x)
            launches += kmod.launches - k0
            r, _ = flat.process_i16(x)
            if b >= first:
                w, d = _worst(a, r, rtol)
                worst, diff = max(worst, w), max(diff, d)
        kname = kmod.__name__.rsplit(".", 1)[-1]
        check(worst <= atol and a.shape == r.shape,
              f"{label} sharded over {MESH_D}: audio within atol {atol:g} "
              f"rtol {rtol:g} of the unsharded bank from block {first} "
              f"(max |diff| {diff:.3e})")
        check(launches == per * MESH_D * SHARD_BLOCKS,
              f"{label} sharded: {kname} launches {launches} = "
              f"{launches / SHARD_BLOCKS:g} per block ({per} per shard)")
        links = 3 if shard_fft else 1      # the shard_fft chain's graphs
        replays = _replays(sb) - r0
        check(replays == links * MESH_D * SHARD_BLOCKS,
              f"{label} sharded: {replays / SHARD_BLOCKS:g} graph replays a "
              f"block ({links} a shard)")
        x = block(0)
        if not shard_fft:       # the FM+PL case timed it already
            time_step(lambda: flat.process_i16_pcm(x), n_ch, L, FS,
                      f"{mode} {n_ch} ch unsharded", 10, smi)
        if cards:
            # CUDA events on the first card, where every shard's output is
            # gathered; device busy is per card, so not one number here
            ms = cuda_ms(lambda: sb.process_i16_pcm(x), 10)
            print(f"  {label} {n_ch} ch on {where}: {ms:.3f} ms/block "
                  f"({n_ch * L / (ms / 1e3) / 1e6:,.0f} ch x Msps) "
                  f"[{smi}]", flush=True)
        else:
            time_step(lambda: sb.process_i16_pcm(x), n_ch, L, FS,
                      f"{label} {n_ch} ch on {where}", 10, smi)
        del flat, sb
        torch.cuda.empty_cache()


def phase_bankd_mesh(bankd, bank_mod, mesh_mod, io_mod, native, ffill, smi,
                     tmp):
    """bankd --mesh through main(): --iq-file at 1022 FM channels padded to
    1024 (PCM equal to bankd without the mesh, no padding row written);
    bankd -I --mesh --max-active where padding rows never take a slot."""
    fs, n_ch = LIVE["samprate"], MESH_FILE_CH
    print(f"phase 26: bankd --mesh {MESH_D} (a {MESH_D}-shard mesh of the "
          f"card), --iq-file at {n_ch} FM channels x {fs / 1e6:.3f} Msps, "
          f"{MESH_FILE_BLOCKS} blocks; then -I --max-active", flush=True)
    mesh = mesh_mod.make_channel_mesh(devices=[DEV] * MESH_D)
    real_mesh = bankd._mesh
    got = real_mesh(argparse.Namespace(mesh=MESH_D, cpu=DEV == "cpu"))
    check(got.size == (MESH_D if DEV == "cpu" else min(
              MESH_D, torch.cuda.device_count())),
          f"--mesh {MESH_D} on this machine: a {got.size}-device mesh "
          f"({', '.join(map(str, got.devices))}), printed")
    # the one-card machine's stand-in for MESH_D cards: --mesh gets the
    # MESH_D shards of the card
    bankd._mesh = lambda args: mesh if args.mesh else None
    try:
        L, _ = bankd.derive_geometry(fs)
        freqs = np.linspace(-0.45 * fs, 0.45 * fs, n_ch, endpoint=False)
        # a carrier on the last channel: the padding rows copy its
        # frequency, so they are as loud as a real channel
        sig = (3, n_ch // 10, n_ch - 1)
        rec = os.path.join(tmp, "mesh.iq")
        record(rec, [make_iq(b, L, fs, SEED + 26,
                             fm=[(freqs[c], False) for c in sig])
                     for b in range(MESH_FILE_BLOCKS)], fs, io_mod)
        outs = {}
        for tag, extra in (("mesh", ["--mesh", str(MESH_D)]), ("flat", [])):
            outs[tag] = os.path.join(tmp, f"{tag}.pcm")
            k0 = ffill.launches
            rc, err, wall = run_daemon(lambda: bankd.main(
                ["--iq-file", rec, "-r", str(fs), "--channels", str(n_ch),
                 "-m", "FM", "--pcm-raw", outs[tag], *extra,
                 *daemon_flags()]))
            check(rc == 0, f"bankd --iq-file {' '.join(extra)} returned "
                  f"{rc} ({wall:.2f} s wall, build included); ffill "
                  f"launches {ffill.launches - k0}")
            if tag == "mesh":
                check(f"padded {n_ch} channels to {n_ch + 2} for the "
                      f"{MESH_D}-device mesh" in err,
                      "bankd printed the mesh and its padding")
                check(ffill.launches - k0 == 2 * MESH_D * MESH_FILE_BLOCKS,
                      f"ffill launched {ffill.launches - k0} times: 2 per "
                      f"shard and block")
        pa, pb = (np.fromfile(outs[t], "<i2").astype(np.int32)
                  for t in ("mesh", "flat"))
        check(pa.size == MESH_FILE_BLOCKS * n_ch * 960 and pa.shape ==
              pb.shape and np.abs(pa - pb).max() <= 1,
              f"bankd --mesh --pcm-raw: {pa.size} samples ({n_ch} channels, "
              f"no padding row), within {np.abs(pa - pb).max()} LSB of "
              f"bankd without the mesh")
        os.unlink(rec)
        phase_bankd_live(bankd, native, ffill, smi, mesh=MESH_D)
    finally:
        bankd._mesh = real_mesh


def phase_dryrun(dryrun):
    print(f"phase 27: dryrun_multichip({MESH_D}) on {MESH_D} shards of the "
          "card", flush=True)
    t0 = time.perf_counter()
    try:
        dryrun.dryrun_multichip(MESH_D, devices=[DEV] * MESH_D)
        ok = True
    except AssertionError as e:
        print(f"  dryrun: {e}", flush=True)
        ok = False
    check(ok, f"dryrun_multichip({MESH_D}): FM, CAM, N = 2^16, shard_fft at "
          f"8192 and 2^16, fft_fourstep, bankd --mesh, MultiBank, Doppler, "
          f"ISB, migration ({time.perf_counter() - t0:.1f} s)")


def _tool_json(main_fn, argv):
    """Run a tool's main(argv) in this process; its last stdout line as
    JSON (None if it failed)."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = main_fn(argv)
    lines = "".join(tee.parts).strip().splitlines()
    if rc != 0 or not lines:
        return None
    return json.loads(lines[-1])


def phase_tools(stage_profile, serve_soak, ffill, smi):
    print("phase 28: tools/stage_profile at 8192 ch on long blocks (N = "
          "2^26) and 4096 ch at 20 ms, with the receiver front end",
          flush=True)
    rows = ("master_ms", "chan_ms", "full_ms", "d_channelize_ms",
            "d_demod_ms", "fills_ms", "pl_ring_ms", "pl_fft_ms",
            "pl_fft_amortised_ms", "front_nco_ms", "front_n0_ms",
            "front_psd_ms", "realtime_x")
    for argv in (["--channels", str(LONG["n_channels"]), "--L",
                  str(LONG["L"]), "--M", str(LONG["M"])],
                 ["--channels", str(SERVE["n_channels"]), "--L",
                  str(SERVE["L"]), "--M", str(SERVE["M"])]):
        t0 = time.perf_counter()
        res = _tool_json(stage_profile.main, argv)
        ok = res is not None and all(isinstance(res.get(k), (int, float))
                                     for k in rows)
        check(ok and res["d_channelize_ms"] == round(
                  res["chan_ms"] - res["master_ms"], 3)
              and res["device"] == torch.cuda.get_device_name(0),
              f"stage_profile {' '.join(argv[:2])}: every row, derived "
              f"rows exact ({time.perf_counter() - t0:.1f} s)")
        if ok:
            print(f"  stage_profile {res['channels']} ch, L_dec "
                  f"{res['L_dec']}: " + ", ".join(f"{k} {res[k]}"
                                                  for k in rows)
                  + f" [{smi}]", flush=True)
        torch.cuda.empty_cache()
    print(f"phase 29: tools/serve_soak, {SOAK['channels']} FM+PL channels "
          f"at 20 ms, --max-active 64, {SOAK['seconds']} s", flush=True)
    k0 = ffill.launches
    res = _tool_json(serve_soak.main, ["--channels", str(SOAK["channels"]),
                                       "--seconds", str(SOAK["seconds"])])
    keys = ("blocks", "sustained_rt", "p50_ms", "p99_ms", "max_ms",
            "channels", "block_ms", "peak_rss_kb")
    check(res is not None and all(k in res for k in keys)
          and res["blocks"] > 0
          and 0 < res["p50_ms"] <= res["p99_ms"] <= res["max_ms"]
          and ffill.launches - k0 >= 2 * res["blocks"],
          f"serve_soak: {res and {k: res[k] for k in keys}}; ffill launches "
          f"{ffill.launches - k0} [{smi}]")


#: phase 30: blocks every captured wrapper and its eager twin run (a retune,
#: a Doppler step and a filter swap at GRAPH_EDITS), the blocks of a scan,
#: and the calls timed per wrapper (the long block: GRAPH_LONG_ITERS)
GRAPH_BLOCKS, GRAPH_EDITS, GRAPH_SCAN = 20, (6, 10, 14), 8
GRAPH_ITERS, GRAPH_LONG_ITERS = 20, 6
#: phase 30's rows, for the summary it prints last
GRAPH_ROWS = []


def _bits(t):
    """A tensor's bit patterns, so that NaN equals NaN and -0 is not +0."""
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _bit_equal(a, b):
    from ka9q_sdr_tpu_torch.utils.graphs import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(_bits(x), _bits(y)) for x, y in zip(la, lb))


def _state(w):
    return w.states if hasattr(w, "states") else w.state


def _replays(w):
    return sum(g.replays for g in w.graphs)


def _twins(label, make, block, step, edits, smi, scan=None,
           iters=GRAPH_ITERS, busy=True, links=1):
    """A captured wrapper (make(True)) against its eager twin
    (make(False)): GRAPH_BLOCKS blocks through step(w, x) with `edits`
    ({block: (name, fn(w))}) between them, every output and the whole
    state bit-equal after each block, `links` replays a block on each
    device (a shard_fft mesh's chain: 3); `scan` = (blocks, run_scan(w,
    xs), run_twin(w, xs)): a scan on the captured wrapper, one replay a
    device, bit-equal to run_twin on the twin.  Then ms/block of each by
    CUDA events (in
    turns: eager, captured, captured, eager), device busy by device_ms,
    the capture time and the memory each holds (busy=False: not the
    busy time, for a mesh of several cards, where it is one per card)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    r0 = torch.cuda.memory_reserved()
    cap, eag = make(True), make(False)
    n_dev = len(cap.graphs)
    differ, replays = [], []
    for b in range(GRAPH_BLOCKS):
        for w in (cap, eag):
            if b in edits:
                edits[b][1](w)
        x = block(b)
        r = _replays(cap)
        got, want = step(cap, x), step(eag, x)
        replays.append(_replays(cap) - r)
        if not (_bit_equal(got, want) and _bit_equal(_state(cap),
                                                     _state(eag))):
            differ.append(b)
    names = ", ".join(f"{n} before block {b}" for b, (n, _) in edits.items())
    check(not differ, f"{label}: captured = eager twin bit for bit, state "
          f"included, over {GRAPH_BLOCKS} blocks ({names}); blocks that "
          f"differ: {differ}")
    check(set(replays) == {links * n_dev}, f"{label}: replays a block "
          f"{replays} ({links} a device: {n_dev} device(s))")
    scan_ms = float("nan")
    if scan is not None:
        xs, run_scan, run_twin = scan
        r = _replays(cap)
        got = run_scan(cap, xs)
        n = _replays(cap) - r
        want = run_twin(eag, xs)
        check(torch.equal(_bits(got), _bits(want)) and n == n_dev
              and _bit_equal(_state(cap), _state(eag)),
              f"{label}: a {len(xs)}-block scan = the eager twin's bit for "
              f"bit, state included; {n} replay(s) for the call")
        del got, want
        scan_ms = cuda_ms(lambda: run_scan(cap, xs), 3) / len(xs)
        del xs
    x = block(0)
    run_c, run_e = (lambda: step(cap, x)), (lambda: step(eag, x))
    run_c()
    run_e()
    e1, c1 = cuda_ms(run_e, iters), cuda_ms(run_c, iters)
    c2, e2 = cuda_ms(run_c, iters), cuda_ms(run_e, iters)
    busy_e = busy_c = float("nan")
    if busy:
        busy_e = sum(device_ms(run_e, 1) for _ in range(3)) / 3
        busy_c = sum(device_ms(run_c, 1) for _ in range(3)) / 3
    e, c = (e1 + e2) / 2, (c1 + c2) / 2
    cap_s = sum(g.capture_s for g in cap.graphs)
    n_graphs = sum(len(g.graphs) for g in cap.graphs)
    del x
    gc.collect()
    torch.cuda.empty_cache()     # the cached blocks of neither wrapper
    held = [torch.cuda.memory_reserved()]    # what each wrapper holds
    del run_c, cap
    gc.collect()
    torch.cuda.empty_cache()
    held.append(torch.cuda.memory_reserved())
    del run_e, eag, w
    gc.collect()
    torch.cuda.empty_cache()
    held.append(torch.cuda.memory_reserved())
    held = [(held[0] - held[1]) / 2**20, (held[1] - held[2]) / 2**20]
    idle = max(0.0, 1 - busy_c / c) if busy_c == busy_c else busy_c
    print(f"  {label}: eager {e:.3f} ms/block ({e1:.3f}, {e2:.3f}), captured "
          f"{c:.3f} ({c1:.3f}, {c2:.3f}): {e / c:.2f}x; device busy eager "
          f"{busy_e:.3f}, captured {busy_c:.3f} ms/block, captured idle "
          f"{idle:.0%}; a scan {scan_ms:.3f} ms/block; {n_graphs} graph(s) "
          f"on {n_dev} device(s) captured in {cap_s:.2f} s; reserved memory: "
          f"captured wrapper {held[0]:.1f} MiB (state and graph pools), "
          f"eager twin {held[1]:.1f} MiB (of {r0 / 2**20:.1f} before) "
          f"[{smi}]", flush=True)
    GRAPH_ROWS.append((label, e, c, busy_e, busy_c, scan_ms, cap_s,
                       held[0], held[1]))


def _bank_edits(freqs, ch, low, high):
    return {GRAPH_EDITS[0]: ("retune", lambda w: w.tune(ch[0], freqs[ch[0]]
                                                        + 2000.0)),
            GRAPH_EDITS[1]: ("Doppler step", lambda w: w.set_doppler(
                ch[1], 50.0, 100.0)),
            GRAPH_EDITS[2]: (f"set_filter({low:g}, {high:g})",
                             lambda w: w.set_filter(low, high))}


def _bank_scan(block, single=True):
    """A scan of GRAPH_SCAN blocks, held against the twin's single steps
    (or, where those differ from a scan, as a shard_fft bank's
    distributed FFT does, against the twin's scan)."""
    xs = torch.stack([block(GRAPH_BLOCKS + i) for i in range(GRAPH_SCAN)])
    run = lambda w, xs: w.process_scan_i16(xs, pcm_out=True)  # noqa: E731
    return (xs, run, (lambda w, xs: torch.stack(
        [w.process_i16_pcm(x)[0] for x in xs])) if single else run)


def phase_graphs(bank_mod, receiver, modulate, mesh_mod, smi, freqs,
                 cards=False):
    """Every path's captured CUDA graphs against an eager twin
    (capture=False) at the widths of the phases above: bit-equal through
    live edits, a k-block scan equal to k single steps with one replay a
    call, and eager against captured ms/block in one call.  With `cards`
    only the mesh paths, over the machine's first MESH_D cards."""
    print(f"phase 30{'c' if cards else ''}: captured CUDA graphs against "
          f"eager twins ({GRAPH_BLOCKS} blocks, a retune, a Doppler step and "
          f"a filter swap; a {GRAPH_SCAN}-block scan)", flush=True)
    GRAPH_ROWS.clear()
    n_ch, L, M = SERVE["n_channels"], SERVE["L"], SERVE["M"]
    pcm = lambda w, x: w.process_i16_pcm(x)          # noqa: E731
    cam_car = [(freqs[c] + o * PLL_BIN, True, None)
               for c, o in CAM_SIGNAL.items()]
    usb_car = [(freqs[c] + 1000.0, False, None) for c in SIGNAL]
    fm_block = lambda b: make_block(b, L, freqs, SIGNAL, NO_PL, DEV)  # noqa
    if not cards:
        _graph_paths(bank_mod, receiver, modulate, smi, freqs, pcm, cam_car,
                     usb_car, fm_block)
    mesh = mesh_mod.make_channel_mesh(
        MESH_D if cards else None, devices=None if cards else [DEV] * MESH_D)
    where = f"{MESH_D} cards" if cards else f"{MESH_D} shards of the card"
    for label, mode, block, (low, high), shard_fft in (
            ("FM+PL", "FM", fm_block, (-6000.0, 6000.0), False),
            ("FM+PL shard_fft", "FM", fm_block, (-6000.0, 6000.0), True),
            ("CAM", "CAM", lambda b: make_am_block(b, L, FS, cam_car, DEV),
             (-3000.0, 3000.0), False)):
        cfg = bank_mod.make_bank_config(n_ch, mode, samprate=FS, L=L, M=M,
                                        enable_pl=mode == "FM")
        ch = list(CAM_SIGNAL) if mode == "CAM" else SIGNAL
        _twins(f"{label} 4096 ch on {where}",
               lambda c, cfg=cfg, sf=shard_fft: bank_mod.ChannelBank(
                   cfg, freqs, mesh=mesh, shard_fft=sf, capture=c),
               block, pcm, _bank_edits(freqs, ch, low, high), smi,
               scan=_bank_scan(block, single=not shard_fft), iters=10,
               busy=not cards, links=3 if shard_fft else 1)
    print(f"  summary (ms/block; {smi}): path | eager | captured | busy "
          "eager | busy captured | scan | capture s | captured wrapper MiB | "
          "eager twin MiB", flush=True)
    for row in GRAPH_ROWS:
        print("  | " + " | ".join(f"{v:.3f}" if isinstance(v, float) else v
                                  for v in row) + " |", flush=True)


def _graph_paths(bank_mod, receiver, modulate, smi, freqs, pcm, cam_car,
                 usb_car, fm_block):
    """phase_graphs' single-device paths."""
    n_ch, L, M = SERVE["n_channels"], SERVE["L"], SERVE["M"]
    banks = (
        ("FM+PL 4096 ch", "FM", fm_block, pcm, (-6000.0, 6000.0)),
        ("FM+PL 4096 ch, process_active (64)", "FM", fm_block,
         lambda w, x: w.process_active(x, max_active=64), (-6000.0, 6000.0)),
        ("CAM 4096 ch", "CAM",
         lambda b: make_am_block(b, L, FS, cam_car, DEV), pcm,
         (-3000.0, 3000.0)),
        ("AM 4096 ch", "AM",
         lambda b: make_am_block(b, L, FS, cam_car, DEV), pcm,
         (-3000.0, 3000.0)),
        ("USB 4096 ch", "USB",
         lambda b: make_am_block(b, L, FS, usb_car, DEV), pcm,
         (200.0, 2800.0)),
    )
    for label, mode, block, step, (low, high) in banks:
        cfg = bank_mod.make_bank_config(n_ch, mode, samprate=FS, L=L, M=M,
                                        enable_pl=mode == "FM")
        ch = list(CAM_SIGNAL) if mode in ("CAM", "AM") else SIGNAL
        _twins(label, lambda c: bank_mod.ChannelBank(cfg, freqs, device=DEV,
                                                     capture=c),
               block, step, _bank_edits(freqs, ch, low, high), smi,
               scan=None if step is not pcm else _bank_scan(block))
    long_cfg = bank_mod.make_bank_config(LONG["n_channels"], "FM",
                                         samprate=FS, L=LONG["L"],
                                         M=LONG["M"], enable_pl=True)
    long_f = bank_freqs(LONG["n_channels"])
    long_block = lambda b: make_block(b, LONG["L"], long_f,  # noqa: E731
                                      LONG_SIGNAL, (), DEV)
    _twins("FM+PL 8192 ch, long blocks",
           lambda c: bank_mod.ChannelBank(long_cfg, long_f, device=DEV,
                                          capture=c),
           long_block, pcm,
           _bank_edits(long_f, LONG_SIGNAL, -6000.0, 6000.0), smi,
           scan=_bank_scan(long_block), iters=GRAPH_LONG_ITERS)
    of = _other_freqs()
    isb_block = lambda b: make_am_block(  # noqa: E731
        b, OTHER["L"], OTHER["samprate"],
        [(of[9] + 1000.0, False, None), (of[130] - 1500.0, False, None)],
        DEV)
    isb_cfg = bank_mod.make_bank_config(
        OTHER["n_channels"], "ISB", samprate=OTHER["samprate"],
        L=OTHER["L"], M=OTHER["M"])
    _twins("ISB 256 ch, 24.576 Msps",
           lambda c: bank_mod.ChannelBank(isb_cfg, of, device=DEV,
                                          capture=c),
           isb_block, pcm, _bank_edits(of, (9, 130), -2800.0, 2800.0), smi,
           scan=_bank_scan(isb_block))
    for spec in MIXED_ROWS:
        groups = _mixed_groups(spec)
        fm_f, usb_f, cam_f = (f for _, f in groups)
        fm = [(fm_f[c], False) for c in MIXED_FM_SIG]
        car = ([(usb_f[c] + 1000.0, False, None) for c in MIXED_USB_SIG]
               + [(cam_f[c] + o * PLL_BIN, True, None)
                  for c, o in MIXED_CAM_SIG.items()])
        u0, c0 = MIXED_USB_SIG[0], list(MIXED_CAM_SIG)[0]
        edits = {GRAPH_EDITS[0]: ("retune", lambda w, u0=u0, f=usb_f:
                                  w.tune(1, u0, f[u0] + 500.0)),
                 GRAPH_EDITS[1]: ("Doppler step", lambda w, c0=c0:
                                  w.set_doppler(2, c0, 30.0, 50.0)),
                 GRAPH_EDITS[2]: ("FM set_filter(-6000, 6000)",
                                  lambda w: w.set_filter(0, -6000.0,
                                                         6000.0))}
        _twins("MultiBank " + " + ".join(f"{m}:{n}" for m, n in spec),
               lambda c, g=groups: bank_mod.MultiBank(
                   g, samprate=FS, L=L, M=M, device=DEV, capture=c),
               lambda b, fm=fm, car=car: make_iq(b, L, FS, SEED + 11, fm=fm,
                                                 carriers=car),
               pcm, edits, smi)
    fs, rx_if = 192000, 48000.0
    rx_filters = {"FM": (-7000.0, 7000.0), "AM": (-4000.0, 4000.0),
                  "USB": (200.0, 2800.0), "LSB": (-2800.0, -200.0),
                  "CAM": (-4000.0, 4000.0)}
    for mode, (low, high) in rx_filters.items():
        cfg = receiver.make_receiver_config(mode, samprate=fs)
        src = _rx_source(mode, modulate, rx_if, fs, cfg.L)
        blocks = [src(b) for b in range(GRAPH_BLOCKS + GRAPH_SCAN)]

        def make(c, cfg=cfg):
            rx = receiver.Receiver(cfg, device=DEV, capture=c)
            rx.set_freq(rx_if)
            return rx

        x16 = torch.clamp(torch.view_as_real(torch.stack(
            blocks[GRAPH_BLOCKS:])) * 32767.0, -32768, 32767).to(torch.int16)
        _twins(f"receiver {mode}, 192 kHz", make,
               lambda b, blocks=blocks: blocks[b],
               lambda w, x: w.process(x),
               {GRAPH_EDITS[0]: ("retune", lambda w: w.set_freq(rx_if
                                                                 + 300.0)),
                GRAPH_EDITS[1]: ("Doppler step",
                                 lambda w: w.set_doppler(40.0, 0.0)),
                GRAPH_EDITS[2]: (f"set_filter({low:g}, {high:g})",
                                 lambda w, lo=low, hi=high:
                                 w.set_filter(lo, hi))},
               smi, scan=(x16, lambda w, xs: w.process_offline(xs),
                          lambda w, xs: torch.stack([w.process(
                              bank_mod.iq_from_i16(x))[0] for x in xs])))



#: phase 31: the notch at a 192 kHz receiver's block and a 24.576 Msps
#: block, NOTCH_BLOCKS blocks each with the state carried; its frequency
#: (cycles/sample) and bandwidth; entry()'s blocks
NOTCH_RATES = ((192000, 3840), (24576000, 491520))
NOTCH_F, NOTCH_BW, NOTCH_BLOCKS = 0.05, 0.01, 3
ENTRY_BLOCKS = 20


def notch_f64(x, f, bw):
    """The notch of filter.c:551-571 per sample in float64: the oscillator
    starts at phase 0 and steps f cycles a sample, and each sample is spun
    down, has the running DC estimate taken off before that estimate takes
    it in, and is spun back up."""
    oscs = np.exp(2j * np.pi * ((f * np.arange(len(x))) % 1.0))
    out = []
    dc = 0j
    for s, osc in zip(x.astype(np.complex128).tolist(), oscs.tolist()):
        u = s * osc.conjugate()
        r = u - dc
        dc += bw * r
        out.append(r * osc)
    return np.array(out), dc


def phase_notch_entry(iir, dryrun, bank_mod, ffill, smi):
    """The complex notch on the card against the CPU port's notch and a
    float64 transliteration of the C; then ``dryrun.entry()``: each block
    one replay, bit-equal to the eager bank_step, two fills a block."""
    print("phase 31: the complex notch (ops/iir) on the card; "
          "parallel.dryrun.entry(), the flagship step's compile check",
          flush=True)
    rng = np.random.default_rng(SEED + 31)
    for fs, L in NOTCH_RATES:
        n = L * NOTCH_BLOCKS
        x = (0.1 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
             + np.exp(2j * np.pi * NOTCH_F * np.arange(n))).astype(
                 np.complex64)
        xd = torch.as_tensor(x, device=DEV)
        out = {}
        for dev, xs in ((DEV, xd), ("cpu", torch.as_tensor(x))):
            st = iir.notch_init(NOTCH_F, NOTCH_BW, device=dev)
            ys = []
            for b in range(NOTCH_BLOCKS):
                st, y = iir.notch_block(st, xs[b * L:(b + 1) * L])
                ys.append(y)
            out[dev] = (torch.cat(ys).cpu().numpy(),
                        complex(st.dcstate.cpu()))
        y64, dc64 = notch_f64(x, NOTCH_F, NOTCH_BW)
        (yc, dcc), (yh, dch) = out[DEV], out["cpu"]
        rms = float(np.sqrt(np.mean(np.abs(y64) ** 2)))
        e_cpu = float(np.sqrt(np.mean(np.abs(yc - yh) ** 2))) / rms
        e_64 = float(np.sqrt(np.mean(np.abs(yc - y64) ** 2))) / rms
        e_dc = abs(dcc - dch) / abs(dch)
        tone = abs(np.vdot(np.exp(2j * np.pi * NOTCH_F * np.arange(n - L, n)),
                           yc[n - L:])) / L
        st = iir.notch_init(NOTCH_F, NOTCH_BW, device=DEV)
        blk = xd[:L]
        ms = cuda_ms(lambda: iir.notch_block(st, blk), 20)
        print(f"  notch {fs / 1e3:g} kHz, {NOTCH_BLOCKS} blocks of {L}: "
              f"card against the CPU port RMS {e_cpu:.3e} of the output's, "
              f"dcstate {e_dc:.3e}; against float64 filter.c {e_64:.3e}; "
              f"tone left {tone:.2e} of 1; {ms:.4f} ms/block [{smi}]",
              flush=True)
        check(e_cpu <= 1e-5 and e_dc <= 1e-5 and e_64 <= 1e-4
              and tone < 0.01 and yc.shape == (n,) and np.isfinite(yc).all(),
              f"notch at {fs / 1e3:g} kHz on the card: within 1e-5 of the "
              f"CPU port (output RMS, dcstate) and 1e-4 of float64 filter.c, "
              f"the tone gone")
    fn, (state, x0) = dryrun.entry()
    bank = fn.bank
    cfg = bank.cfg
    g = torch.Generator(device=DEV).manual_seed(SEED + 32)
    blocks = [x0 if b < ENTRY_BLOCKS // 2 else x0 + 1e-3 * torch.randn(
        x0.shape, dtype=torch.complex64, device=DEV, generator=g)
        for b in range(ENTRY_BLOCKS)]
    ffill.launches = 0
    r0 = bank.graphs[0].replays
    st, outs = state, []
    for x in blocks:
        st, audio, diag = fn(st, x)
        outs.append((st, audio, diag))
    launches = ffill.launches
    replays = bank.graphs[0].replays - r0
    ref, equal = state, True
    for x, got in zip(blocks, outs):
        ref, audio, diag = bank_mod.bank_step(cfg, ref, x)
        equal = equal and _bit_equal(got, (ref, audio, diag))
    ok = all(torch.isfinite(a).all() and a.shape == (16, cfg.L_dec)
             for _, a, _ in outs)
    check(equal and ok and replays == ENTRY_BLOCKS
          and launches == 2 * ENTRY_BLOCKS,
          f"entry(): {ENTRY_BLOCKS} blocks of the 16-ch FM bank (N = "
          f"{cfg.N}), each one replay ({replays}), bit-equal, state "
          f"included, to the eager bank_step; ffill launches {launches} "
          f"(2 a block)")
    ms = cuda_ms(lambda: fn(st, x0), 20)
    eager = {"s": state}

    def step():
        eager["s"], _, _ = bank_mod.bank_step(cfg, eager["s"], x0)

    ms_eager = cuda_ms(step, 20)
    print(f"  entry(): {ms:.4f} ms/block through fn (state in, one replay, "
          f"state out), eager bank_step {ms_eager:.4f} [{smi}]", flush=True)


#: phase 32: the runner's watchdog (s), and how far its FM+PL 4096
#: serving row's ms/block may be from phase 30's captured scan
BENCH_DEADLINE_S = 600
BENCH_ROW_TOL = 0.15
#: the runner's default rows in order ("# measuring ..." label), each with
#: the kernels it must launch (ffill, agc) and must not
BENCH_ROWS = (
    ("FM 8192 ch x 393.216 Msps L=58195968", (True, False)),
    ("FM 4096 ch x 393.216 Msps L=7864320", (True, False)),
    ("FM 5120 ch x 393.216 Msps L=7864320", (True, False)),
    ("FM 6144 ch x 393.216 Msps L=7864320", (True, False)),
    ("FM 2048 ch x 393.216 Msps L=58195968", (True, False)),
    ("MultiBank FM:3072+USB:512+CAM:512 x 393.216 Msps L=7864320",
     (True, True)),
    ("MultiBank FM:5120+USB:512+CAM:512 x 393.216 Msps L=7864320",
     (True, True)),
    ("CAM 4096 ch x 393.216 Msps L=7864320", (False, True)),
    ("CAM 2048 ch x 24.576 Msps L=491520", (False, True)),
)
BENCH_ROW_RE = re.compile(
    r"#   row: slope ([\d.]+) ms/block \| CUDA events ([\d.]+) ms/block \| "
    r"peak allocated (\d+) B .*\| launches ffill \+(\d+) agc \+(\d+)")


def phase_bench(smi, scan_ms):
    """``python -m ka9q_sdr_tpu_torch.bench`` at bench.py's defaults in a
    subprocess: its stderr rows printed here, one result line naming the
    card, every default row in order with the fill or AGC kernel launched
    as its path needs, and the FM+PL 4096 serving row's slope within
    BENCH_ROW_TOL of phase 30's captured scan (`scan_ms`, a block)."""
    import gc

    print("phase 32: the benchmark runner, python -m "
          "ka9q_sdr_tpu_torch.bench at bench.py's defaults", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "ka9q_sdr_tpu_torch.bench"], cwd=root,
        env=dict(os.environ, BENCH_DEADLINE_S=str(BENCH_DEADLINE_S)),
        capture_output=True, text=True, timeout=BENCH_DEADLINE_S + 60)
    secs = time.monotonic() - t0
    for line in proc.stderr.splitlines():
        print(f"  {line}", flush=True)
    check(proc.returncode == 0, f"bench exits 0 (rc {proc.returncode}, "
          f"{secs:.1f} s)")
    lines = proc.stdout.splitlines()
    try:
        res = json.loads(lines[0]) if len(lines) == 1 else {}
    except json.JSONDecodeError:
        res = {}
    print(f"  stdout: {proc.stdout.strip()}", flush=True)
    power = res.get("power_limit_w")
    check(set(res) == {"metric", "value", "unit", "vs_baseline", "device",
                       "power_limit_w"}
          and res["metric"] == "channels_x_Msps_demodulated_per_chip"
          and isinstance(res["value"], (int, float)) and res["value"] > 0
          and res["device"] == torch.cuda.get_device_name(0)
          and isinstance(power, (int, float)) and power > 0,
          "one stdout JSON line: metric, value > 0, unit, vs_baseline, "
          "device (this card), power_limit_w")
    rows, label = [], None
    for line in proc.stderr.splitlines():
        if line.startswith("# measuring "):
            label = line[len("# measuring "):].removesuffix("...")
        m = BENCH_ROW_RE.match(line)
        if m:
            rows.append((label, float(m[1]), float(m[2]), int(m[3]),
                         int(m[4]), int(m[5])))
    check([r[0] for r in rows] == [r for r, _ in BENCH_ROWS],
          f"the {len(BENCH_ROWS)} default rows in order, each with its "
          f"card line ({len(rows)} found)")
    for (label, slope, events, peak, fills, agcs), (_, (fill, agc_)) in zip(
            rows, BENCH_ROWS):
        check((fills > 0) == fill and (agcs > 0) == agc_,
              f"{label}: launches ffill +{fills}, agc +{agcs} (on its "
              f"path: ffill {fill}, agc {agc_})")
    serve = [r for r in rows if r[0] == BENCH_ROWS[1][0]]
    if serve:
        slope = serve[0][1]
        check(abs(slope / scan_ms - 1) <= BENCH_ROW_TOL,
              f"FM+PL 4096 serving row {slope:.4f} ms/block (CUDA events "
              f"{serve[0][2]:.4f}) within {BENCH_ROW_TOL:.0%} of phase 30's "
              f"captured scan {scan_ms:.4f} [{smi}]")


#: phase 33: the captured scan's blocks (36 = two firings of every FM
#: channel's PL measurement, at blocks 17 and 35); the CAM bank's blocks
#: before it must be locked, the locked blocks profiled (one acquisition
#: ring period is 35), and its carriers' level and the noise's; the calls
#: timed per due and per not-due block; the blocks of the runner's CAM
#: inputs whose searches are counted
GATE_SCAN, GATE_CAM_MAX, GATE_LOCKED = 36, 260, 40
GATE_RUNNER_BLOCKS = 80
GATE_CAM_AMP, GATE_CAM_NOISE, GATE_ITERS = 0.01, 0.003, 10


def kernel_counts(fn, setup=None):
    """{kernel name: launches} on the card while fn() runs, from
    torch.profiler (graph replays included: CUPTI sees each kernel node);
    setup() runs before, outside the profile.  Records of replays made
    outside a profile can reach the next one, so an empty profile takes
    them in first.  A profile that recorded no kernel lost its records
    (fn always launches) and is taken again."""
    from collections import Counter
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        if setup is not None:
            setup()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = Counter(e.name for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        if out:
            return out
        print("  (the profile recorded no kernel: profiled again)",
              flush=True)
    return out


def _body_check(label, fft, due, notdue, window=None, n_window=0):
    """A gated body's kernels, a due replay's launches less a not-due
    one's: they hold an FFT kernel whose name holds `fft`, which the
    not-due replay launches no time where `window` is None; a `window` of
    n_window replays, none due, launches it n_window times what the
    not-due replay did (the kernel may serve another FFT of the step too).
    Prints the body's kernels and counts."""
    body = due - notdue
    print(f"  {label}: {sum(due.values())} kernels a due replay, "
          f"{sum(notdue.values())} a not-due one" + (
              f", {sum(window.values())} in {n_window} replays none of which"
              f" is due" if window is not None else "")
          + "; the difference, per kernel: due, not due" + (
              f", {n_window} replays" if window is not None else ""),
          flush=True)
    ffts = [n for n in body if "fft" in n and fft in n]
    for name, n in sorted(body.items()):
        extra = f", {window[name]}" if window is not None else ""
        print(f"    {name[:110]}: +{n}; {due[name]}, {notdue[name]}{extra}",
              flush=True)
    if window is None:
        return bool(ffts) and all(notdue[n] == 0 for n in ffts)
    return bool(ffts) and all(window[n] == n_window * notdue[n]
                              for n in ffts)


def _cam_all_block(b, L, fs, freqs, dev):
    """Block b of a CAM bank's input with an unmodulated carrier on every
    channel (offsets of -120..120 PLL bins, 7 apart), low noise; made on
    the device from the seed."""
    g = torch.Generator(device=dev).manual_seed(SEED + 33 + b)
    n = b * L + torch.arange(L, device=dev, dtype=torch.float64)
    x = GATE_CAM_NOISE * torch.randn((L, 2), generator=g, device=dev,
                                     dtype=torch.float64)
    offs = torch.as_tensor([((7 * c) % 241 - 120) * PLL_BIN
                            for c in range(len(freqs))], device=dev,
                           dtype=torch.float64)
    f = torch.as_tensor(freqs, device=dev, dtype=torch.float64) + offs
    for i in range(0, len(freqs), 32):
        cyc = torch.frac(n[None, :] * (f[i:i + 32, None] / fs))
        x[:, 0] += GATE_CAM_AMP * torch.cos(2 * np.pi * cyc).sum(0)
        x[:, 1] += GATE_CAM_AMP * torch.sin(2 * np.pi * cyc).sum(0)
    return torch.clamp(x * 32767.0, -32768, 32767).to(torch.int16)


def _due_ms(bank, field, due, notdue, x):
    """Device ms of one block by spin-padded CUDA events, with the gate's
    counter (`field` of the demod state) set in place so the block is due
    or not: (due ms, not-due ms), in turns."""
    counter = getattr(bank._state.demod, field)

    def run(v):
        return lambda: (counter.fill_(v), bank.process_i16_pcm(x))

    d1, n1 = device_ms(run(due), GATE_ITERS), device_ms(run(notdue),
                                                        GATE_ITERS)
    n2, d2 = device_ms(run(notdue), GATE_ITERS), device_ms(run(due),
                                                           GATE_ITERS)
    return (d1 + d2) / 2, (n1 + n2) / 2


def phase_gates(bank_mod, demod_fm, freqs, smi):
    """The JAX package's two lax.cond gates as IF nodes of the captured
    graphs: the PL measurement and the PLL acquisition run only on blocks
    where a channel is due."""
    print("phase 33: gated PL and PLL acquisition (conditional nodes in "
          "the captured graphs)", flush=True)
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, driver "
          f"{driver}; torch binds begin_capture_to_if_node: "
          f"{hasattr(torch.cuda.CUDAGraph, 'begin_capture_to_if_node')}; "
          "the port's IF nodes: csrc/cond.cu (cudaGraphConditionalHandle"
          "Create, cudaGraphAddNode, cudaStreamBeginCaptureToGraph)",
          flush=True)
    n_ch, L, M = SERVE["n_channels"], SERVE["L"], SERVE["M"]
    cfg = bank_mod.make_bank_config(n_ch, "FM", samprate=FS, L=L, M=M,
                                    enable_pl=True)
    xs = torch.stack([make_block(b, L, freqs, SIGNAL, NO_PL, DEV)
                      for b in range(GATE_SCAN)])
    scan = bank_mod.ChannelBank(cfg, freqs, device=DEV)
    single = bank_mod.ChannelBank(cfg, freqs, device=DEV)
    eager = bank_mod.ChannelBank(cfg, freqs, device=DEV, capture=False)
    got = scan.process_scan_i16(xs, pcm_out=True)
    one = torch.stack([single.process_i16_pcm(x)[0] for x in xs])
    twin = torch.stack([eager.process_i16_pcm(x)[0] for x in xs])
    check(torch.equal(got, one) and torch.equal(got, twin)
          and _bit_equal(scan.state, single.state)
          and _bit_equal(scan.state, eager.state),
          f"FM+PL {n_ch} ch: a {GATE_SCAN}-block captured scan, the blocks "
          f"replayed one at a time and the eager gated twin are bit-equal, "
          f"PCM and state")
    check(scan.graphs[0].replays == 1
          and single.graphs[0].replays == GATE_SCAN,
          f"one replay for the scan ({GATE_SCAN} IF nodes in its graph), "
          f"one a block for the single steps")
    k = cfg.L_dec // demod_fm.PL_DECIMATE
    every = -(-demod_fm.PL_FFT_INTERVAL // k)
    pl = scan.state.demod.plfreq.cpu().numpy()
    tones = [float(pl[c]) for c in SIGNAL if c not in NO_PL]
    left = (GATE_SCAN % every) * k
    check(all(abs(t - 100.0) < 2.0 for t in tones)
          and (scan.state.demod.pl_counter == left).all().item(),
          f"the PL measurement ran inside the scan (1 block in {every}): "
          f"plfreq {tones} Hz on the PL channels, every counter at {left}")
    del got, one, twin, scan, eager

    # the rFFT's kernels only on the due block
    counter = single._state.demod.pl_counter
    x = xs[0]
    notdue = kernel_counts(lambda: single.process_i16_pcm(x),
                           lambda: counter.fill_(0))
    due = kernel_counts(lambda: single.process_i16_pcm(x),
                        lambda: counter.fill_(demod_fm.PL_FFT_INTERVAL - k))
    check(_body_check(f"FM+PL {n_ch} ch, the (B, 16384) rFFT", "16384",
                      due, notdue),
          "the 16384-point rFFT's kernels run on the due replay only")
    d_ms, n_ms = _due_ms(single, "pl_counter",
                         demod_fm.PL_FFT_INTERVAL - k, 0, x)
    print(f"  FM+PL {n_ch} ch, 20 ms: due block {d_ms:.3f} ms, not due "
          f"{n_ms:.3f} ms; the PL measurement {d_ms - n_ms:.3f} ms, 1 block "
          f"in {every}: {(d_ms - n_ms) / every:.3f} ms/block amortised, "
          f"{n_ms + (d_ms - n_ms) / every:.3f} ms/block on average [{smi}]",
          flush=True)
    del single, xs, x
    torch.cuda.empty_cache()

    lcfg = bank_mod.make_bank_config(LONG["n_channels"], "FM", samprate=FS,
                                     L=LONG["L"], M=LONG["M"], enable_pl=True)
    long_bank = bank_mod.ChannelBank(lcfg, bank_freqs(LONG["n_channels"]),
                                     device=DEV)
    x = make_block(0, LONG["L"], long_bank.freqs, LONG_SIGNAL, (), DEV)
    k = lcfg.L_dec // demod_fm.PL_DECIMATE
    d_ms, n_ms = _due_ms(long_bank, "pl_counter",
                         demod_fm.PL_FFT_INTERVAL - k, 0, x)
    every = -(-demod_fm.PL_FFT_INTERVAL // k)
    print(f"  FM+PL {LONG['n_channels']} ch, long block: due block "
          f"{d_ms:.3f} ms, not due {n_ms:.3f} ms; the PL measurement "
          f"{d_ms - n_ms:.3f} ms, 1 block in {every}: "
          f"{(d_ms - n_ms) / every:.3f} ms/block amortised, "
          f"{n_ms + (d_ms - n_ms) / every:.3f} ms/block on average [{smi}]",
          flush=True)
    del long_bank, x
    torch.cuda.empty_cache()

    # CAM 4096: the acquisition's cost on a due block (unlocked bank)
    ccfg = bank_mod.make_bank_config(n_ch, "CAM", samprate=FS, L=L, M=M)
    cam = bank_mod.ChannelBank(ccfg, freqs, device=DEV)
    x = make_am_block(0, L, FS, (), DEV)
    ring_size = ccfg.demod_cfg.ring_size
    d_ms, n_ms = _due_ms(cam, "fft_samples", ring_size, 0, x)
    print(f"  CAM {n_ch} ch, 20 ms, no channel locked: due block {d_ms:.3f} "
          f"ms, not due {n_ms:.3f} ms; the acquisition {d_ms - n_ms:.3f} ms "
          f"[{smi}]", flush=True)
    del cam, x
    torch.cuda.empty_cache()

    # how often the runner's CAM rows search: its input holds three
    # carriers in noise (ka9q_sdr_tpu_torch.bench.bench_inputs)
    from ka9q_sdr_tpu_torch.bench import bench_inputs
    for rn, rfs, rL, rM in ((n_ch, FS, L, M), (2048, OTHER["samprate"],
                                               OTHER["L"], OTHER["M"])):
        rfreqs, rx = bench_inputs(rn, rfs, rL)
        cam = bank_mod.ChannelBank(
            bank_mod.make_bank_config(rn, "CAM", samprate=rfs, L=rL, M=rM),
            rfreqs, device=DEV)
        rx = torch.as_tensor(rx, device=DEV)
        fired = []
        for b in range(GATE_RUNNER_BLOCKS):
            cam.process_i16(rx)
            if (cam.state.demod.fft_samples == 0).any().item():
                fired.append(b)
        print(f"  the runner's CAM {rn} ch x {rfs / 1e6:g} Msps input: the "
              f"search ran on blocks {fired} of {GATE_RUNNER_BLOCKS}; "
              f"{int(cam.state.demod.pll_lock.sum())} channels locked",
              flush=True)
        del cam, rx
    torch.cuda.empty_cache()

    # a CAM bank whose every channel locks: no acquisition once locked
    ofs, oL = OTHER["samprate"], OTHER["L"]
    ofreqs = _other_freqs()
    cam = _other_bank(bank_mod, "CAM", ofreqs)
    on = cam.cfg.n_channels
    lc = cam.cfg.demod_cfg
    # no channel locked yet: a ring 30 samples in is not due, a full one is
    samples = cam._state.demod.fft_samples
    x = _cam_all_block(0, oL, ofs, ofreqs, DEV)
    cam.process_i16_pcm(x)          # its capture, outside the profiles
    notdue = kernel_counts(lambda: cam.process_i16_pcm(x),
                           lambda: samples.fill_(0))
    due = kernel_counts(lambda: cam.process_i16_pcm(x),
                        lambda: samples.fill_(lc.ring_size))
    b, t0 = 1, time.perf_counter()
    while b < GATE_CAM_MAX and not cam.state.demod.pll_lock.all().item():
        cam.process_i16_pcm(_cam_all_block(b, oL, ofs, ofreqs, DEV))
        b += 1
    locked_at = b
    check(cam.state.demod.pll_lock.all().item(),
          f"CAM {on} ch at {ofs / 1e6:g} Msps, a carrier on every channel: "
          f"all locked after {locked_at} blocks "
          f"({time.perf_counter() - t0:.1f} s, signal generation included)")
    xs = [_cam_all_block(b, oL, ofs, ofreqs, DEV)
          for b in range(locked_at, locked_at + GATE_LOCKED)]

    def locked_run():
        for x in xs:
            cam.process_i16_pcm(x)

    window = kernel_counts(locked_run)
    still = cam.state.demod.pll_lock.all().item()
    check(_body_check(f"CAM {on} ch, the ({on}, {lc.ring_size}) "
                      "acquisition FFT", str(lc.ring_size), due, notdue,
                      window, GATE_LOCKED) and still,
          f"the locked bank launches no acquisition FFT in {GATE_LOCKED} "
          f"blocks (still locked after them: {still})")
    del cam, xs
    torch.cuda.empty_cache()


#: phase 34: the long-block shard_fft bank's blocks held against the
#: unsharded captured bank, the blocks held bit-equal to its eager twin
#: (on 4 cards the check of the chain's order across blocks), the calls
#: timed.  Block 0 is held on its signal channels only: there FM on a
#: dozen noise channels turns the master FFT's float32 rounding into runs
#: of samples 0.4 apart, as far for a second exact FFT of the same block
#: (fft_fourstep in place of the 2^26 cuFFT) as for the distributed one
#: (PERF.md §6)
LONG_SHARD_BLOCKS, LONG_TWIN_BLOCKS, LONG_SHARD_ITERS = 6, 24, 6


def _reserved(mesh):
    """Bytes the caching allocator holds on the mesh's cards."""
    cards = {torch.device(d).index or 0 for d in mesh.devices}
    return sum(torch.cuda.memory_reserved(i) for i in cards)


def phase_shard_fft_long(bank_mod, mesh_mod, demod_fm, ffill, smi,
                         cards=False):
    """The distributed-master-FFT bank at the long-block geometry (FM+PL
    8192 ch, N = 2^26, 148 ms blocks), the geometry shard_fft exists for,
    on MESH_D shards of the card (or, with `cards`, MESH_D cards), its step
    a chain of three captured graphs a shard: LONG_SHARD_BLOCKS blocks
    within 3e-5 / 1e-4 of the unsharded captured bank, with 2 fills and 3
    replays a shard a block; LONG_TWIN_BLOCKS blocks bit-equal to the
    eager twin; eager and captured ms/block by CUDA events beside the
    unsharded bank's; the memory the captured bank holds; and a due and a
    not-due block under torch.cuda.set_sync_debug_mode("error")."""
    import gc

    n_ch, L, M = LONG["n_channels"], LONG["L"], LONG["M"]
    mesh = mesh_mod.make_channel_mesh(
        MESH_D if cards else None, devices=None if cards else [DEV] * MESH_D)
    where = f"{MESH_D} cards" if cards else f"{MESH_D} shards of the card"
    print(f"phase 34{'c' if cards else ''}: the shard_fft bank at long "
          f"blocks, {n_ch} FM+PL channels x {FS / 1e6:.3f} Msps (N = 2^26) "
          f"on {where}", flush=True)
    cfg = bank_mod.make_bank_config(n_ch, "FM", samprate=FS, L=L, M=M,
                                    enable_pl=True)
    freqs = bank_freqs(n_ch)
    block = lambda b: make_block(b, L, freqs, LONG_SIGNAL, (), DEV)  # noqa
    flat = bank_mod.ChannelBank(cfg, freqs, device=DEV)
    refs = [flat.process_i16(block(b))[0] for b in range(LONG_SHARD_BLOCKS)]
    x = block(0)
    pcm = lambda w: (lambda: w.process_i16_pcm(x))  # noqa: E731
    flat_ms = cuda_ms(pcm(flat), LONG_SHARD_ITERS)
    del flat
    gc.collect()
    torch.cuda.empty_cache()
    r0 = _reserved(mesh)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sb = bank_mod.ChannelBank(cfg, freqs, mesh=mesh, shard_fft=True)
    worst, diff = -1.0, 0.0
    k0, rp0 = ffill.launches, _replays(sb)
    sig = list(LONG_SIGNAL)
    for b, r in enumerate(refs):
        a, _ = sb.process_i16(block(b))
        # block 0: the signal channels (see LONG_SHARD_BLOCKS)
        w, d = _worst(a[sig], r[sig], 1e-4) if b == 0 else _worst(a, r, 1e-4)
        worst, diff = max(worst, w), max(diff, d)
        if b == 0:
            d0 = (a - r).abs().amax(dim=1)
            noisy = torch.nonzero(d0 > 3e-5).flatten().tolist()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches, replays = ffill.launches - k0, _replays(sb) - rp0
    check(worst <= 3e-5 and a.shape == refs[0].shape,
          f"FM+PL {n_ch} ch shard_fft on {where}: audio within atol 3e-5 "
          f"rtol 1e-4 of the unsharded captured bank, every channel from "
          f"block 1 and the signal channels from block 0, over "
          f"{LONG_SHARD_BLOCKS} blocks (max |diff| {diff:.3e})")
    print(f"  block 0's noise channels past 3e-5: {len(noisy)} "
          f"(max |diff| {float(d0.max()):.3e}), none a signal channel: "
          f"{not set(noisy) & set(sig)}", flush=True)
    check(launches == 2 * MESH_D * LONG_SHARD_BLOCKS
          and replays == 3 * MESH_D * LONG_SHARD_BLOCKS,
          f"FM+PL {n_ch} ch shard_fft: ffill launches {launches}, graph "
          f"replays {replays} in {LONG_SHARD_BLOCKS} blocks (2 and 3 a "
          f"shard a block)")
    del refs, a, r
    held = (_reserved(mesh) - r0) / 2**30
    peak = torch.cuda.max_memory_allocated() / 2**30
    eag = bank_mod.ChannelBank(cfg, freqs, mesh=mesh, shard_fft=True,
                               capture=False)
    eag.state = sb.state
    differ = []
    for b in range(LONG_TWIN_BLOCKS):
        xb = block(LONG_SHARD_BLOCKS + b)
        if not (_bit_equal(sb.process_i16_pcm(xb), eag.process_i16_pcm(xb))
                and _bit_equal(sb.state, eag.state)):
            differ.append(b)
    check(not differ, f"FM+PL {n_ch} ch shard_fft on {where}: captured = "
          f"eager twin bit for bit, state included, over {LONG_TWIN_BLOCKS} "
          f"blocks; blocks that differ: {differ}")
    del xb
    e1, c1 = cuda_ms(pcm(eag), LONG_SHARD_ITERS), cuda_ms(pcm(sb),
                                                          LONG_SHARD_ITERS)
    c2, e2 = cuda_ms(pcm(sb), LONG_SHARD_ITERS), cuda_ms(pcm(eag),
                                                         LONG_SHARD_ITERS)
    e, c = (e1 + e2) / 2, (c1 + c2) / 2
    cap_s = sum(g.capture_s for g in sb.graphs)
    print(f"  FM+PL {n_ch} ch shard_fft on {where}: eager {e:.3f} ms/block "
          f"({e1:.3f}, {e2:.3f}), captured {c:.3f} ({c1:.3f}, {c2:.3f}); "
          f"the unsharded captured bank {flat_ms:.3f}; "
          f"{n_ch * L / (c / 1e3) / 1e6:,.0f} ch x Msps captured; "
          f"{sum(len(g.graphs) for g in sb.graphs)} graphs captured in "
          f"{cap_s:.2f} s (first {LONG_SHARD_BLOCKS} blocks {first_s:.2f} s); "
          f"the captured bank holds {held:.2f} GiB reserved (state and "
          f"graph pools), peak allocated {peak:.2f} GiB on card 0 [{smi}]",
          flush=True)
    del eag
    # a due and a not-due block with every host sync an error
    k = cfg.L_dec // demod_fm.PL_DECIMATE
    raised, counts = None, []
    for v in (demod_fm.PL_FFT_INTERVAL - k, 0):
        for st in sb._state:
            st.demod.pl_counter.fill_(v)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            sb.process_i16_pcm(x)
        except RuntimeError as err:
            raised = raised or err
        finally:
            torch.cuda.set_sync_debug_mode("default")
        counts.append(sorted({int(c) for st in sb._state
                              for c in st.demod.pl_counter.unique()}))
    check(raised is None and counts == [[0], [k]],
          f"FM+PL {n_ch} ch shard_fft: a due and a not-due block under "
          f"set_sync_debug_mode('error'): {raised or 'no host sync'}; PL "
          f"counters after them {counts} (the due block fired)")
    del sb, x
    gc.collect()
    torch.cuda.empty_cache()


#: phase 35: CUDA-event calls timed a row after its checked blocks
REF_ITERS = 5
#: the fill and AGC launches a block of each reference row's path: FM 2
#: fills, CAM 1 AGC, the mixed row's FM group 2 fills and its USB and CAM
#: groups an AGC each
REF_LAUNCHES = {"R1": (2, 0), "R2": (2, 0), "R3": (2, 2), "R4": (0, 1),
                "R5": (0, 1)}


def phase_reference(ref_mod, smi):
    """The runner's rows R1-R5 against the JAX package's reference outputs
    (``ka9q_sdr_tpu_torch/data/reference``, ``tools/reference.py``): each
    row's input made again and its SHA-256 held to the file's, its K
    blocks through the port's captured calls (``process_i16_pcm`` one
    block a call, ``process_scan_i16(pcm_out=True)`` in chunks of 8,
    ``MultiBank.process``) with the fill and AGC launched as the path needs
    and one replay a call, every bound of tools/reference.py held (integer
    state bit-equal; flags; kept PCM within PARITY.md #9; audio RMS within
    0.1 dB); per row the worst LSB, the RMS error, the flags that differ
    and the device ms a block by CUDA events."""
    import gc

    print("phase 35: the runner's rows against the JAX package's reference "
          f"outputs ({', '.join(ref_mod.ROWS)}; bounds: integer state "
          f"bit-equal, flags equal, kept PCM <= {ref_mod.PCM_LSB} LSB and "
          f"<= {ref_mod.PCM_RMS_DBFS:g} dBFS, RMS within {ref_mod.RMS_DB} dB "
          "above -90 dBFS)", flush=True)
    t0 = time.perf_counter()
    rows = []
    for name, row in ref_mod.ROWS.items():
        ref = ref_mod.load(name)
        t_in = time.perf_counter()
        freqs, x = ref_mod.row_input(row)
        t_in = time.perf_counter() - t_in
        sha = ref_mod.input_sha256(x)
        if not check(sha == ref["sha256"], f"{name}: the input made here "
                     f"({t_in:.1f} s on the host) has the reference's "
                     f"SHA-256 {ref['sha256'][:16]}..."):
            continue
        for call in row.calls:
            arrays, stats = ref_mod.run_port(row, DEV, call, x=x,
                                             freqs=freqs,
                                             timing_iters=REF_ITERS)
            rep = ref_mod.compare(ref, arrays, name, call)
            fills, agcs = REF_LAUNCHES[name]
            n_calls = (row.K // ref_mod.SCAN_CHUNK + row.K
                       % ref_mod.SCAN_CHUNK) if call == "scan" else row.K
            got = stats["launches"]
            check(got == {"ffill": fills * row.K, "agc": agcs * row.K}
                  and stats["replays"] == n_calls,
                  f"{name} {call}: {row.K} blocks launched ffill "
                  f"{got['ffill']}, agc {got['agc']} ({fills} / {agcs} a "
                  f"block) in {stats['replays']} graph replays ({n_calls} "
                  "calls)")
            ms = stats["ms"]
            check(rep.ok, f"{rep.summary()}; "
                  + ("not measured" if ms is None else f"{ms:.4f} ms")
                  + f" a block by CUDA events [{smi}]")
            rows.append((name, call, max(rep.lsb), max(rep.lsb_out),
                         max(rep.pcm_rms_dbfs), rep.flags_differ[0],
                         sum(f for f in rep.flags_differ[1:] if f >= 0),
                         not rep.state_differ, max(rep.rms_db),
                         max(rep.rms_db_out), ms))
            del arrays
        del x, ref
        gc.collect()
    print(f"  summary [{smi}]: row | call | kept PCM worst LSB in the "
          "bounds' domain | outside it | kept PCM difference RMS dBFS | "
          "flags differing in block 0 | later | integer state equal | audio "
          "RMS worst dB in the domain | outside it | ms a block", flush=True)
    for r in rows:
        print("  | " + " | ".join(f"{v:.4f}" if isinstance(v, float) else
                                  str(v) for v in r) + " |", flush=True)
    print(f"  phase 35 took {time.perf_counter() - t0:.1f} s", flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    try:
        from ka9q_sdr_tpu_torch import interop
        from ka9q_sdr_tpu_torch.io import modulate
        from ka9q_sdr_tpu_torch.models import bank as bank_mod
        from ka9q_sdr_tpu_torch.models import receiver
        from ka9q_sdr_tpu_torch.models import demod_fm
        from ka9q_sdr_tpu_torch.models.demod_fm import _pl_measure
        from ka9q_sdr_tpu_torch.models.demod_linear import _acquire
        from ka9q_sdr_tpu_torch.ops import _kernels, agc, ffill, iir, pstock
        from ka9q_sdr_tpu_torch import io as io_mod, native
        from ka9q_sdr_tpu_torch.apps import bankd, radio
        from ka9q_sdr_tpu_torch.net import status
        from ka9q_sdr_tpu_torch.apps import (aprs as aprs_app, frontend,
                                             iqplay, iqrecord, packetd)
        from ka9q_sdr_tpu_torch.apps import modulate as modulate_app
        from ka9q_sdr_tpu_torch.decode import afsk, ax25
        from ka9q_sdr_tpu_torch.models import frontend as fe_model
        from ka9q_sdr_tpu_torch.net import multicast, rtp
        from ka9q_sdr_tpu_torch.apps import control
        from ka9q_sdr_tpu_torch.audio import opus_codec, transcode
        from ka9q_sdr_tpu_torch.parallel import dryrun, mesh as mesh_mod
        from ka9q_sdr_tpu_torch.tools import (reference, serve_soak,
                                              stage_profile)
    except ModuleNotFoundError as e:
        print(f"chip_smoke: the port is not importable ({e}); run this "
              "script from the root of a checkout", file=sys.stderr)
        return 3

    print("phase 1: environment", flush=True)
    smi = nvidia_smi()
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}",
          flush=True)
    print(f"  nvidia-smi: {smi}", flush=True)
    t0 = time.perf_counter()
    libs = _kernels.load_all(["ffill", "agc", "pstock", "cond"])
    print(f"  kernels built in parallel, {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, kl in libs.items():
        print(f"  {name}: {kl.path.name} nvcc {kl.seconds:.2f} s (cached: "
              f"{kl.cached})", flush=True)
        kernel = name
        for line in kl.log.splitlines():
            m = re.search(r"Function properties for \S*?"
                          r"(ffill_rows|agc_ring|fft_cols_small|fft_cols)"
                          r"(?:ILi(\d+)E)?", line)
            if m:
                kernel = m[1] + (f"<{m[2]}>" if m[2] else "")
            if "registers" in line or "spill" in line:
                print(f"  ptxas {kernel}: {line.strip()}", flush=True)

    max_err, ktimes = phase_kernel(ffill)
    agc_err, agc_times = phase_agc(agc)
    pst_launches, pst_err, pst_times = phase_pstock(pstock)
    freqs = bank_freqs(SERVE["n_channels"])
    launches, blocks = phase_serving(bank_mod, ffill, freqs)
    phase_card_vs_cpu(bank_mod, interop, freqs, blocks)
    del blocks
    long_bank, long_cfg = phase_long(bank_mod, ffill)
    agc_launches, cam_bank, cam_carriers = phase_cam(bank_mod, agc, freqs)
    phase_cam_card_vs_cpu(bank_mod, interop, freqs, cam_carriers)
    phase_other_modes(bank_mod, agc)
    phase_live_control(bank_mod)

    print("phase 12: timing (CUDA events, device-resident int16 input)",
          flush=True)

    def fills_ms(T):
        """An FM block's two fills (complex, float) at phase 2's cold
        times."""
        B = SERVE["n_channels"] if T == 960 else LONG["n_channels"]
        return sum(ktimes[(B, T, d)][0] for d in (torch.complex64,
                                                   torch.float32))

    serve_cfg = bank_mod.make_bank_config(SERVE["n_channels"], "FM",
                                          samprate=FS, L=SERVE["L"],
                                          M=SERVE["M"], enable_pl=True)
    serve_bank = bank_mod.ChannelBank(serve_cfg, freqs, device=DEV)
    time_bank(serve_bank, SERVE["L"], SIGNAL, "FM+PL 4096 ch, 20 ms blocks",
              20, smi, fills_ms(960))
    del serve_bank
    time_bank(long_bank, LONG["L"], LONG_SIGNAL, "FM+PL 8192 ch, long blocks",
              6, smi, fills_ms(7104))
    del long_bank
    time_bank(cam_bank, SERVE["L"], SIGNAL, "CAM 4096 ch, 20 ms blocks", 20,
              smi)
    for mode in ("AM", "USB"):
        cfg = bank_mod.make_bank_config(SERVE["n_channels"], mode,
                                        samprate=FS, L=SERVE["L"],
                                        M=SERVE["M"])
        bank = bank_mod.ChannelBank(cfg, freqs, device=DEV)
        time_bank(bank, SERVE["L"], SIGNAL, f"{mode} 4096 ch, 20 ms blocks",
                  20, smi)
        del bank
    isb = _other_bank(bank_mod, "ISB", _other_freqs())
    x = make_am_block(0, OTHER["L"], OTHER["samprate"], (), DEV)
    _, _, busy = time_step(lambda: isb.process_i16_pcm(x), OTHER["n_channels"],
                           OTHER["L"], OTHER["samprate"],
                           "ISB 256 ch, 24.576 Msps", 20, smi)
    check(busy == busy, "ISB step measured by device_ms (it queues without "
          "making the host wait)")
    del isb, x
    for n_ch, cfg in ((SERVE["n_channels"], serve_cfg),
                      (LONG["n_channels"], long_cfg)):
        fm = cfg.demod_cfg.to(DEV)
        ring = torch.randn((n_ch, 16384), device=DEV)
        prev = torch.full((n_ch,), float("nan"), device=DEV)
        ms = cuda_ms(lambda: _pl_measure(fm, ring, prev), 20)
        print(f"  PL measurement (16k rFFT + peak pick; only on blocks "
              f"where a channel is due) at ({n_ch}, 16384): {ms:.3f} ms "
              f"[{smi}]", flush=True)
    lc = cam_bank.cfg.demod_cfg
    ring = torch.randn((SERVE["n_channels"], lc.ring_size),
                       dtype=torch.complex64, device=DEV)
    ms = cuda_ms(lambda: _acquire(lc, ring), 20)
    print(f"  PLL acquisition ({lc.ring_size}-point FFT + search; only on "
          f"blocks where an unlocked channel is due) at "
          f"({SERVE['n_channels']}, {lc.ring_size}): {ms:.3f} ms [{smi}]",
          flush=True)
    del cam_bank

    phase_multibank(bank_mod, ffill, agc, smi)
    phase_multibank_card_vs_cpu(bank_mod, interop)
    phase_receiver(receiver, modulate, ffill, agc, smi)
    phase_receiver_wide(receiver, ffill, agc, smi)
    phase_offline(receiver, agc)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        phase_bankd_file(bankd, bank_mod, io_mod, ffill, smi, tmp)
        torch.cuda.empty_cache()
        phase_bankd_mixed(bankd, bank_mod, io_mod, status, ffill, agc, smi,
                          tmp)
        torch.cuda.empty_cache()
        live_split = phase_bankd_live(bankd, native, ffill, smi)
        phase_radio(radio, receiver, modulate, io_mod, status, ffill, agc,
                    smi, tmp)
        mods = dict(bankd=bankd, native=native, iqplay=iqplay,
                    packetd=packetd, aprs=aprs_app, ax25=ax25, afsk=afsk,
                    io=io_mod, rtp=rtp, frontend=frontend, fe_model=fe_model,
                    radio=radio, iqrecord=iqrecord, modulate_app=modulate_app,
                    modulate=modulate, status=status, multicast=multicast,
                    control=control, opus_codec=opus_codec,
                    transcode=transcode)
        phase_aprs_bank(mods, ffill, smi, tmp)
        phase_aprs_radio(mods, ffill, smi, tmp)
        phase_chain(mods, ffill, smi, live_split, tmp)
        torch.cuda.empty_cache()
        phase_sharded(bank_mod, mesh_mod, ffill, agc, smi, freqs)
        if torch.cuda.device_count() >= MESH_D:
            phase_sharded(bank_mod, mesh_mod, ffill, agc, smi, freqs,
                          cards=True)
        phase_bankd_mesh(bankd, bank_mod, mesh_mod, io_mod, native, ffill,
                         smi, tmp)
        torch.cuda.empty_cache()
        phase_dryrun(dryrun)
        phase_tools(stage_profile, serve_soak, ffill, smi)
        torch.cuda.empty_cache()
        phase_graphs(bank_mod, receiver, modulate, mesh_mod, smi, freqs)
        fm_scan_ms = next(r[5] for r in GRAPH_ROWS if r[0] == "FM+PL 4096 ch")
        if torch.cuda.device_count() >= MESH_D:
            phase_graphs(bank_mod, receiver, modulate, mesh_mod, smi, freqs,
                         cards=True)
        phase_notch_entry(iir, dryrun, bank_mod, ffill, smi)
        phase_bench(smi, fm_scan_ms)
        phase_gates(bank_mod, demod_fm, freqs, smi)
        phase_shard_fft_long(bank_mod, mesh_mod, demod_fm, ffill, smi)
        if torch.cuda.device_count() >= MESH_D:
            phase_shard_fft_long(bank_mod, mesh_mod, demod_fm, ffill, smi,
                                 cards=True)
        phase_reference(reference, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:", flush=True)
        for f in FAILURES:
            print(f"  {f}", flush=True)
        return 1
    k_ms, p_ms, k_bound = ktimes[(4096, 960, torch.complex64)]
    a_ms, a_plain, a_bound = agc_times[(4096, 960)]   # a_plain: CUDA events
    s_ms, s_plain, s_cufft, s_bound = pst_times
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "ffill",
        "route": "cuda",
        "source": "ka9q_sdr_tpu_torch/csrc/ffill.cu",
        "replaces": "ka9q_sdr_tpu/ops/ffill.py:68",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": k_bound,
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "agc",
        "route": "cuda",
        "source": "ka9q_sdr_tpu_torch/csrc/agc.cu",
        "replaces": "ka9q_sdr_tpu/ops/agc.py:73",
        "launches": agc_launches,
        "max_abs_err": agc_err,
        "ms": a_ms,
        "plain_ms": a_plain,
        "bound_ms": a_bound,
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "pstock",
        "route": "cuda",
        "source": "ka9q_sdr_tpu_torch/csrc/pstock.cu",
        "replaces": "ka9q_sdr_tpu/ops/pstock.py:66",
        "launches": pst_launches,
        "max_abs_err": pst_err,
        "ms": s_ms,
        "plain_ms": s_plain,
        "bound_ms": s_bound,
        "bound_by": "bytes",
        "library_ms": s_cufft,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
