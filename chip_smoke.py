#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ka9q_sdr_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``ka9q_sdr_tpu_torch/csrc``
(one ``nvcc`` per source, all at once) and holds each against its plain
PyTorch version: the FM forward fill and the hang AGC bit for bit, the
column Stockham FFT within 2e-6 (and against numpy and cuFFT).  Then it
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
  Doppler sweep that stays locked across k hops, a narrower filter.

Times come from CUDA events.  Phases print their findings line by line.
The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Any failed check makes the exit code 1
and suppresses both JSON lines; no CUDA device means exit code 2.
"""

import json
import subprocess
import sys
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
#: CAM (PLL) bank at the serving geometry: lock comes 90-150 blocks in (35
#: to the first acquisition, the 1 Hz loop's pull-in, then the 1 s
#: hysteresis climbing from below zero).
CAM_BLOCKS, CAM_ACTIVE, CAM_CPU_BLOCKS = 190, 2, 190
PLL_BIN = 48000.0 / 65536          # the acquisition FFT's bin, Hz
#: CAM signal channels and their carrier offsets in PLL bins (+-300 Hz)
CAM_SIGNAL = {7: 37, 1000: -56, 2047: 17, 3333: 90}
#: Other modes: 256 channels at 24.576 Msps, N = 2^20, decimate 512
OTHER = dict(n_channels=256, samprate=24.576e6, L=491520, M=557057)


def check(cond, what):
    print(("  ok   " if cond else "  FAIL ") + what, flush=True)
    if not cond:
        FAILURES.append(what)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    """Mean device time of fn() in ms over `iters` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters, match=None):
    """Device time per call from torch.profiler's CUDA activity: the summed
    durations of the device events (kernels, copies) whose name contains
    `match` (of every one when None), over `iters` calls after a warm-up.
    Unlike cuda_ms it leaves out the gaps where the device waits for the
    host."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and (match is None or match in e.name))
    return total / iters / 1e3


def bank_freqs(n):
    usable = 0.9 * FS
    return list(np.linspace(-usable / 2, usable / 2, n, endpoint=False))


def make_block(b, L, freqs, signal, no_pl, dev):
    """Block b of the wideband int16 I/Q stream, made on the device from
    the seed: complex noise plus FM carriers at the `signal` channels
    (1 kHz audio at 3 kHz deviation, a 100 Hz PL tone at 500 Hz deviation
    except on `no_pl`)."""
    g = torch.Generator(device=dev).manual_seed(SEED + b)
    n = b * L + torch.arange(L, device=dev, dtype=torch.float64)
    x = 0.03 * torch.randn((L, 2), generator=g, device=dev,
                           dtype=torch.float32).to(torch.float64)
    audio = 3.0 * torch.sin(2 * np.pi * torch.frac(n * (1000.0 / FS)))
    pl = 5.0 * torch.sin(2 * np.pi * torch.frac(n * (100.0 / FS)))
    for ch in signal:
        cyc = torch.frac(n * (freqs[ch] / FS))
        ph = 2 * np.pi * cyc + audio + (0.0 if ch in no_pl else pl)
        x[:, 0] += 0.05 * torch.cos(ph)
        x[:, 1] += 0.05 * torch.sin(ph)
    return torch.clamp(x * 32767.0, -32768, 32767).to(torch.int16)


def make_am_block(b, L, fs, carriers, dev):
    """Block b of a wideband int16 I/Q stream made on the device from the
    seed: complex noise plus carriers.  carriers: (freq Hz, am, sweep) with
    am = 1 kHz AM at depth 0.5, and sweep = None or (start sample, Hz/s):
    a linear chirp from that sample on."""
    g = torch.Generator(device=dev).manual_seed(SEED + 7 + b)
    n = b * L + torch.arange(L, device=dev, dtype=torch.float64)
    x = 0.03 * torch.randn((L, 2), generator=g, device=dev,
                           dtype=torch.float32).to(torch.float64)
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


def tone_hz(pcm_rows, rate=48000.0):
    spec = np.abs(np.fft.rfft(pcm_rows.astype(np.float64)))
    spec[0] = 0.0
    return np.argmax(spec) * rate / len(pcm_rows)


def phase_kernel(ffill):
    """Kernel against plain version: bit-equal, and timed at the main
    path's shapes."""
    print("phase 2: ffill kernel against its plain version", flush=True)
    g = torch.Generator(device=DEV).manual_seed(SEED)
    max_err = 0.0
    cases = [(4096, 960), (8192, 7104), (7, 100), (130, 391)]
    for B, T in cases:
        for dtype in (torch.complex64, torch.float32):
            v = torch.randn((B, T), generator=g, device=DEV, dtype=dtype)
            init = torch.randn((B,), generator=g, device=DEV, dtype=dtype)
            m = torch.rand((B, T), generator=g, device=DEV) < 0.6
            m[::5] = False                      # rows that take init
            for mask in (m, torch.zeros_like(m)):
                (got,) = ffill.forward_fill_multi((v,), mask, (init,))
                (want,) = ffill.fill_plain((v,), mask, (init,))
                torch.cuda.synchronize()
                max_err = max(max_err, float((got - want).abs().max()))
                check(torch.equal(got, want),
                      f"kernel == plain at ({B}, {T}) {dtype}"
                      f"{' all rows weak' if not mask.any() else ''}")
    times = {}
    for B, T in ((4096, 960), (8192, 7104)):
        for dtype in (torch.complex64, torch.float32):
            v = torch.randn((B, T), generator=g, device=DEV, dtype=dtype)
            init = torch.zeros((B,), device=DEV, dtype=dtype)
            m = torch.rand((B, T), generator=g, device=DEV) < 0.9
            plain = cuda_ms(lambda: ffill.fill_plain((v,), m, (init,)), 20)
            kern = cuda_ms(lambda: ffill.forward_fill_multi((v,), m, (init,)),
                           20)
            kern2 = cuda_ms(lambda: ffill.forward_fill_multi((v,), m, (init,)),
                            20)
            plain2 = cuda_ms(lambda: ffill.fill_plain((v,), m, (init,)), 20)
            dev_k = device_ms(
                lambda: ffill.forward_fill_multi((v,), m, (init,)), 20,
                "ffill_rows")
            dev_p = device_ms(lambda: ffill.fill_plain((v,), m, (init,)), 20)
            times[(B, T, dtype)] = (dev_k, dev_p)
            nbytes = B * T * (1 + 2 * v.element_size())
            print(f"  time ({B}, {T}) {dtype}: kernel {kern:.4f}/{kern2:.4f} "
                  f"ms, plain {plain:.4f}/{plain2:.4f} ms (CUDA events); "
                  f"device only: kernel {dev_k:.4f} ms, plain {dev_p:.4f} ms;"
                  f" kernel moves {nbytes / 1e6:.1f} MB -> "
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


def phase_agc(agc):
    """AGC kernel against its plain loop: bit-equal, timed at the bank's
    shapes."""
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
    for B, T in ((4096, 960), (8192, 7104), (7, 100), (130, 391)):
        lev, gain, hang = _agc_case(B, T, g)
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
                  f"{int((st.hangcount > 0).sum())} rows hanging)")
    times = {}
    p = params["linear (hangmax 52800)"]
    for B, T, iters in ((4096, 960, 20), (8192, 7104, 5)):
        lev, gain, hang = _agc_case(B, T, g)
        st = agc.AGCState(gain, hang)
        kern = cuda_ms(lambda: agc.agc_block(st, lev, p), iters)
        plain = cuda_ms(lambda: agc.agc_plain(gain, hang, lev, p), 1)
        kern2 = cuda_ms(lambda: agc.agc_block(st, lev, p), iters)
        dev_k = device_ms(lambda: agc.agc_block(st, lev, p), iters,
                          "agc_rows")
        dev_p = device_ms(lambda: agc.agc_plain(gain, hang, lev, p), 1)
        times[(B, T)] = (dev_k, dev_p)
        cycles = dev_k * 1e-3 * 1.98e9 / T
        print(f"  time ({B}, {T}): kernel {kern:.4f}/{kern2:.4f} ms, plain "
              f"loop {plain:.2f} ms ({T} steps) (CUDA events); device only:"
              f" kernel {dev_k:.4f} ms (~{cycles:.0f} cycles per sample at "
              f"1.98 GHz), plain {dev_p:.2f} ms", flush=True)
    return max_err, times


def phase_pstock(pstock):
    """Column FFT kernel against its plain version, numpy and cuFFT."""
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
    max_err = 0.0
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
        check(e_np < 2e-6 and e_plain < 2e-6,
              f"column FFT ({Q}, {P}): rel err {e_np:.2e} vs np.fft, "
              f"{e_plain:.2e} vs plain")
    xr, xi = planes[(4096, 4096)]
    f = fns[(4096, 4096)]
    xc = torch.complex(xr, xi)
    kern = cuda_ms(lambda: f(xr, xi), 20)
    plain = cuda_ms(lambda: pstock.fft_cols_plain(xr, xi), 5)
    cufft = cuda_ms(lambda: torch.fft.fft(xc, dim=0), 20)
    kern2 = cuda_ms(lambda: f(xr, xi), 20)
    dev_k = device_ms(lambda: f(xr, xi), 20, "fft_cols")
    dev_p = device_ms(lambda: pstock.fft_cols_plain(xr, xi), 5)
    dev_c = device_ms(lambda: torch.fft.fft(xc, dim=0), 20)
    mb = 4096 * 4096 * 16 / 1e6
    print(f"  time (4096, 4096): kernel {kern:.4f}/{kern2:.4f} ms, plain "
          f"{plain:.3f} ms, torch.fft (cuFFT, complex64) {cufft:.4f} ms "
          f"(CUDA events); device only: kernel {dev_k:.4f} ms "
          f"({mb / dev_k:.0f} GB/s of reads+writes), plain {dev_p:.3f} ms, "
          f"cuFFT {dev_c:.4f} ms", flush=True)
    return launches, max_err, (dev_k, dev_p, dev_c)


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


def time_bank(bank, L, signal, label, iters, smi):
    """Per-block device time on a device-resident input, after warm-up."""
    x = make_block(0, L, bank.freqs, signal, (), DEV)
    bank.process_i16_pcm(x)
    torch.cuda.reset_peak_memory_stats()
    t_host = time.perf_counter()
    ms = cuda_ms(lambda: bank.process_i16_pcm(x), iters)
    t_host = (time.perf_counter() - t_host) / (iters + 1) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    busy = device_ms(lambda: bank.process_i16_pcm(x), 3)
    n_ch = bank.cfg.n_channels
    rate = n_ch * L / (ms / 1e3) / 1e6
    realtime = (L / FS) / (ms / 1e3)
    print(f"  {label}: {ms:.3f} ms/block on the device ({t_host:.3f} ms host "
          f"wall incl. sync), {rate:,.0f} ch x Msps, {realtime:.2f}x "
          f"realtime, peak {peak:.1f} GiB; kernels busy {busy:.3f} ms/block "
          f"(profiler), device idle {max(0.0, 1 - busy / ms):.0%} [{smi}]",
          flush=True)
    return ms, rate


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    from ka9q_sdr_tpu_torch import interop
    from ka9q_sdr_tpu_torch.models import bank as bank_mod
    from ka9q_sdr_tpu_torch.models.demod_fm import _pl_measure
    from ka9q_sdr_tpu_torch.models.demod_linear import _acquire
    from ka9q_sdr_tpu_torch.ops import _kernels, agc, ffill, pstock

    print("phase 1: environment", flush=True)
    smi = nvidia_smi()
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}",
          flush=True)
    print(f"  nvidia-smi: {smi}", flush=True)
    t0 = time.perf_counter()
    libs = _kernels.load_all(["ffill", "agc", "pstock"])
    print(f"  kernels built in parallel, {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, kl in libs.items():
        print(f"  {name}: {kl.path.name} nvcc {kl.seconds:.2f} s (cached: "
              f"{kl.cached})", flush=True)
        for line in kl.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

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
    serve_cfg = bank_mod.make_bank_config(SERVE["n_channels"], "FM",
                                          samprate=FS, L=SERVE["L"],
                                          M=SERVE["M"], enable_pl=True)
    serve_bank = bank_mod.ChannelBank(serve_cfg, freqs, device=DEV)
    time_bank(serve_bank, SERVE["L"], SIGNAL, "FM+PL 4096 ch, 20 ms blocks",
              20, smi)
    del serve_bank
    time_bank(long_bank, LONG["L"], LONG_SIGNAL, "FM+PL 8192 ch, long blocks",
              6, smi)
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
    for n_ch, cfg in ((SERVE["n_channels"], serve_cfg),
                      (LONG["n_channels"], long_cfg)):
        fm = cfg.demod_cfg.to(DEV)
        ring = torch.randn((n_ch, 16384), device=DEV)
        prev = torch.full((n_ch,), float("nan"), device=DEV)
        ms = cuda_ms(lambda: _pl_measure(fm, ring, prev), 20)
        print(f"  always-on PL measurement (16k rFFT + peak pick) at "
              f"({n_ch}, 16384): {ms:.3f} ms/block [{smi}]", flush=True)
    lc = cam_bank.cfg.demod_cfg
    ring = torch.randn((SERVE["n_channels"], lc.ring_size),
                       dtype=torch.complex64, device=DEV)
    ms = cuda_ms(lambda: _acquire(lc, ring), 20)
    print(f"  always-on PLL acquisition ({lc.ring_size}-point FFT + search) "
          f"at ({SERVE['n_channels']}, {lc.ring_size}): {ms:.3f} ms/block "
          f"[{smi}]", flush=True)

    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:", flush=True)
        for f in FAILURES:
            print(f"  {f}", flush=True)
        return 1
    k_ms, p_ms = ktimes[(4096, 960, torch.complex64)]
    a_ms, a_plain = agc_times[(4096, 960)]
    s_ms, s_plain, _ = pst_times
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
    }, {
        "name": "agc",
        "route": "cuda",
        "source": "ka9q_sdr_tpu_torch/csrc/agc.cu",
        "replaces": "ka9q_sdr_tpu/ops/agc.py:73",
        "launches": agc_launches,
        "max_abs_err": agc_err,
        "ms": a_ms,
        "plain_ms": a_plain,
    }, {
        "name": "pstock",
        "route": "cuda",
        "source": "ka9q_sdr_tpu_torch/csrc/pstock.cu",
        "replaces": "ka9q_sdr_tpu/ops/pstock.py:66",
        "launches": pst_launches,
        "max_abs_err": pst_err,
        "ms": s_ms,
        "plain_ms": s_plain,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
