#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ka9q_sdr_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernel from ``ka9q_sdr_tpu_torch/csrc``,
holds it against its plain PyTorch version, drives the FM+PL channel bank
(the path ``bench.py`` measures and ``apps/bankd.py`` serves) through its
user entry points at the 4096-channel 20 ms serving geometry and at the
8192-channel long-block geometry, checks what comes out (squelch, 1 kHz
audio, 100 Hz PL tone, active-channel compaction, a card-against-CPU
comparison), and times the kernel and the bank with CUDA events.

Phases print their findings line by line.  The line before the last is the
kernels' JSON record, the last line ``{"ok": true, "device": {...}}``.  Any
failed check makes the exit code 1 and suppresses both JSON lines; no CUDA
device means exit code 2.
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
            times[(B, T, dtype)] = (min(kern, kern2), min(plain, plain2))
            nbytes = B * T * (1 + 2 * v.element_size())
            print(f"  time ({B}, {T}) {dtype}: kernel {kern:.4f}/{kern2:.4f} "
                  f"ms, plain {plain:.4f}/{plain2:.4f} ms; kernel moves "
                  f"{nbytes / 1e6:.1f} MB -> "
                  f"{nbytes / (min(kern, kern2) / 1e3) / 1e9:.0f} GB/s",
                  flush=True)
    return max_err, times


def phase_serving(bank_mod, ffill, freqs):
    """The 4096-channel FM+PL bank at the 20 ms serving geometry."""
    from ka9q_sdr_tpu_torch.models.demod_fm import PL_FFT_INTERVAL

    print("phase 3: 4096-ch FM+PL bank, 20 ms blocks (N = 2^24)", flush=True)
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
    print("phase 4: 64-ch bank on cuda against cpu, same input", flush=True)
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
    print("phase 5: 8192-ch FM+PL bank, long blocks (N = 2^26)", flush=True)
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


def time_bank(bank, L, signal, label, iters, smi):
    """Per-block device time on a device-resident input, after warm-up."""
    x = make_block(0, L, bank.freqs, signal, (), DEV)
    bank.process_i16_pcm(x)
    torch.cuda.reset_peak_memory_stats()
    t_host = time.perf_counter()
    ms = cuda_ms(lambda: bank.process_i16_pcm(x), iters)
    t_host = (time.perf_counter() - t_host) / (iters + 1) * 1e3
    n_ch = bank.cfg.n_channels
    rate = n_ch * L / (ms / 1e3) / 1e6
    realtime = (L / FS) / (ms / 1e3)
    print(f"  {label}: {ms:.3f} ms/block on the device ({t_host:.3f} ms host "
          f"wall incl. sync), {rate:,.0f} ch x Msps, {realtime:.2f}x "
          f"realtime, peak {torch.cuda.max_memory_allocated() / 2**30:.1f} "
          f"GiB [{smi}]", flush=True)
    return ms, rate


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    from ka9q_sdr_tpu_torch import interop
    from ka9q_sdr_tpu_torch.models import bank as bank_mod
    from ka9q_sdr_tpu_torch.models.demod_fm import _pl_measure
    from ka9q_sdr_tpu_torch.ops import _kernels, ffill

    print("phase 1: environment", flush=True)
    smi = nvidia_smi()
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}",
          flush=True)
    print(f"  nvidia-smi: {smi}", flush=True)
    t0 = time.perf_counter()
    kl = _kernels.load("ffill")
    print(f"  ffill kernel: {kl.path} built in {kl.seconds:.2f} s "
          f"(cached: {kl.cached}; load {time.perf_counter() - t0:.2f} s)",
          flush=True)
    for line in kl.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    max_err, ktimes = phase_kernel(ffill)
    freqs = bank_freqs(SERVE["n_channels"])
    launches, blocks = phase_serving(bank_mod, ffill, freqs)
    phase_card_vs_cpu(bank_mod, interop, freqs, blocks)
    del blocks
    long_bank, long_cfg = phase_long(bank_mod, ffill)

    print("phase 6: timing (CUDA events, device-resident int16 input)",
          flush=True)
    serve_cfg = bank_mod.make_bank_config(SERVE["n_channels"], "FM",
                                          samprate=FS, L=SERVE["L"],
                                          M=SERVE["M"], enable_pl=True)
    serve_bank = bank_mod.ChannelBank(serve_cfg, freqs, device=DEV)
    time_bank(serve_bank, SERVE["L"], SIGNAL, "4096 ch, 20 ms blocks", 20,
              smi)
    del serve_bank
    time_bank(long_bank, LONG["L"], LONG_SIGNAL, "8192 ch, long blocks", 6,
              smi)
    for n_ch, cfg in ((SERVE["n_channels"], serve_cfg),
                      (LONG["n_channels"], long_cfg)):
        fm = cfg.demod_cfg.to(DEV)
        ring = torch.randn((n_ch, 16384), device=DEV)
        prev = torch.full((n_ch,), float("nan"), device=DEV)
        ms = cuda_ms(lambda: _pl_measure(fm, ring, prev), 20)
        print(f"  always-on PL measurement (16k rFFT + peak pick) at "
              f"({n_ch}, 16384): {ms:.3f} ms/block [{smi}]", flush=True)

    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:", flush=True)
        for f in FAILURES:
            print(f"  {f}", flush=True)
        return 1
    k_ms, p_ms = ktimes[(4096, 960, torch.complex64)]
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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
