"""Per-stage device time of the FM bank block at a given channel width
(the twin of the JAX package's ``tools/stage_profile.py``), plus the
receiver's front end.

Stages (cumulative prefixes of ``bank_step_i16``, models/bank.py):
  master      i16 ingest + gain + master FFT (ops/fftfilt master_execute)
  chan        + bank_recenter + bank_channelize (gather, response, phase,
              batched IFFT, NCO)
  full        + FM demod with the PL chain (models/demod_fm.py), on a
              block where no PL measurement is due, captured as the banks
              run it (the state written back unchanged, so every call is
              the same block)

Isolated components inside the demod delta:
  fills       the two forward fills at (B, L_dec) (the csrc/ffill.cu
              kernel on the card)
  pl_ring     the PL ring shift-concat at (B, PL_FFT_SIZE)
  pl_fft      one PL measurement (rFFT + peak pick, ``_pl_measure``) at
              (B, PL_FFT_SIZE), which runs only on the blocks where a
              channel is due; pl_fft_amortised is its cost a block: it
              runs 1 block in ceil(512 / k)

The receiver's front end at the same block (models/receiver.py), ``front``:
  front_nco   the second LO and Doppler NCO ramps over L samples, mixed in
  front_n0    compute_n0's two masked reductions over the N-bin spectrum
  front_psd   the 128-bin peak-held power spectrum

On the card each row is the mean over --iters calls of one call's device
time, CUDA events around it while a spin holds the card
(``utils.timing.device_ms``), so host enqueue gaps do not count.  Under
--cpu a tiny geometry runs on the host clock.  The derived rows
(d_channelize_ms, d_demod_ms, realtime_x) come from the rounded values, so
they equal the differences of the printed ones exactly.

Usage:
  python -m ka9q_sdr_tpu_torch.tools.stage_profile --channels 8192 [--iters 10]
  python -m ka9q_sdr_tpu_torch.tools.stage_profile --cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..models import demod_fm
from ..models.bank import (ChannelBank, bank_channelize, bank_recenter,
                           bank_step_i16, iq_from_i16, make_bank_config)
from ..models.noise import compute_n0
from ..models.receiver import (make_receiver_config, mix_second_lo, psd128,
                               receiver_init)
from ..ops.fftfilt import master_execute
from ..ops.ffill import forward_fill_multi
from ..ops.nco import osc_init, set_osc
from ..utils.graphs import StepGraphs
from ..utils.runtime import configure_torch

__all__ = ["main", "fm_block"]


def fm_block(L: int, samprate: float, carriers, seed: int, device,
             deviation: float = 0.0, phase: float = 0.0) -> torch.Tensor:
    """(L, 2) int16 wideband I/Q made on `device` from `seed`: complex noise
    at 0.01 plus a 0.2 carrier at each of `carriers` (Hz), FM with a 1 kHz
    tone at `deviation` Hz (0: unmodulated) and starting tone phase
    `phase`."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = 0.01 * torch.randn((L, 2), generator=g, device=device,
                           dtype=torch.float32).to(torch.float64)
    n = torch.arange(L, device=device, dtype=torch.float64)
    tone = (deviation / 1e3) * torch.sin(
        2 * np.pi * torch.frac(n * (1e3 / samprate)) + phase)
    for f in carriers:
        ph = 2 * np.pi * torch.frac(n * (f / samprate)) + tone
        x[:, 0] += 0.2 * torch.cos(ph)
        x[:, 1] += 0.2 * torch.sin(ph)
    return torch.clamp(x * 32767.0, -32768, 32767).to(torch.int16)


def _timer(cpu: bool, iters: int, warmup: int):
    """ms per call of fn: device time on the card, host clock on the CPU."""
    if cpu:
        def host_ms(fn):
            for _ in range(warmup):
                fn()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) / iters * 1e3
        return host_ms
    from ..utils.timing import device_ms

    def card_ms(fn):
        for _ in range(warmup):
            fn()
        return sum(device_ms(fn, 1) for _ in range(iters)) / iters
    return card_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="stage_profile")
    ap.add_argument("--channels", type=int, default=7168)
    ap.add_argument("--samprate", type=float, default=393.216e6)
    ap.add_argument("--L", type=int, default=58195968)
    ap.add_argument("--M", type=int, default=8912897)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="tiny-geometry smoke run on the host CPU")
    ap.add_argument("--stages", default="master,chan,full,fills,pl,front")
    args = ap.parse_args(argv)

    dev = configure_torch(args.cpu, "stage_profile")
    if args.cpu:
        args.samprate, args.L, args.M = 1.536e6, 245760, 32769
        args.channels = min(args.channels, 16)
    ms = _timer(args.cpu, args.iters, args.warmup)
    B, L, fs = args.channels, args.L, args.samprate
    cfg = make_bank_config(B, "FM", samprate=fs, L=L, M=args.M,
                           enable_pl=True)
    L_dec = cfg.L_dec
    usable = 0.9 * fs
    freqs = list(np.linspace(-usable / 2, usable / 2, B, endpoint=False))
    print(f"# building {B}-ch FM+PL bank, L={L} (L_dec={L_dec}, "
          f"N_dec={cfg.N_dec}) on {dev}...", file=sys.stderr, flush=True)
    bank = ChannelBank(cfg, freqs, device=dev)
    dcfg, state = bank.cfg, bank.state
    x = fm_block(L, fs, [freqs[ch] for ch in (3, B // 2, B - 5)], 1, dev)

    def spectrum():
        samp = iq_from_i16(x) * state.gain_factor
        return master_execute(dcfg.master, state.overlap, samp)[1]

    def channelize():
        st = bank_recenter(dcfg, state)
        return bank_channelize(dcfg, st, spectrum())

    stages = args.stages.split(",")
    res = {}
    if "master" in stages:
        res["master_ms"] = ms(spectrum)
    if "chan" in stages:
        res["chan_ms"] = ms(channelize)
    if "full" in stages:
        # eager, the PL gate would read its predicate on the host
        steps = StepGraphs(dev)

        def full(s):
            bank_step_i16(dcfg, s, x)
            return s, ()

        res["full_ms"] = ms(lambda: steps.run("full", full, state, ()))
    if "fills" in stages:
        # the two shared-mask fills of fm_demod, ~all-strong mask (clean
        # carriers; the kernel's cost does not depend on the mask)
        g = torch.Generator(device=dev).manual_seed(2)
        strong = torch.rand((B, L_dec), generator=g, device=dev) < 0.95
        vc = torch.randn((B, L_dec), generator=g, device=dev,
                         dtype=torch.complex64)
        vr = torch.randn((B, L_dec), generator=g, device=dev)
        inits = (torch.zeros(B, dtype=torch.complex64, device=dev),
                 torch.zeros(B, device=dev))
        res["fills_ms"] = ms(lambda: forward_fill_multi((vc, vr), strong,
                                                        inits))
    if "pl" in stages:
        pl_n = demod_fm.PL_FFT_SIZE
        k = max(1, L_dec // demod_fm.PL_DECIMATE)
        ring = torch.randn((B, pl_n), device=dev)
        newsamp = torch.randn((B, k), device=dev)
        prev = torch.full((B,), float("nan"), device=dev)
        res["pl_ring_ms"] = ms(lambda: torch.cat([ring[..., k:], newsamp],
                                                 dim=-1))
        res["pl_fft_ms"] = ms(lambda: demod_fm._pl_measure(dcfg.demod_cfg,
                                                           ring, prev))
        fire = 1.0 / -(-demod_fm.PL_FFT_INTERVAL // k)
        res["pl_fft_amortised_ms"] = res["pl_fft_ms"] * fire
    if "front" in stages:
        rcfg = make_receiver_config("FM", samprate=int(fs), L=L, M=args.M)
        rstate = receiver_init(rcfg, device=dev)
        rstate = rstate._replace(
            lo2=set_osc(osc_init(device=dev), 0.01),
            doppler=set_osc(osc_init(device=dev), 1e-5, 1e-12))
        samp = iq_from_i16(x)
        mask = torch.as_tensor(rcfg.n0_mask, device=dev)
        fd = spectrum()
        res["front_nco_ms"] = ms(lambda: mix_second_lo(rstate, samp, L))
        res["front_n0_ms"] = ms(lambda: compute_n0(fd, mask, fs))
        res["front_psd_ms"] = ms(lambda: psd128(fd))

    out = {"channels": B, "L_dec": L_dec,
           "device": ("cpu" if args.cpu
                      else torch.cuda.get_device_name(dev)),
           "timing": "host clock" if args.cpu else "cuda events"}
    out.update({k: round(v, 3) for k, v in res.items()})
    if {"master_ms", "chan_ms", "full_ms"} <= out.keys():
        out["d_channelize_ms"] = round(out["chan_ms"] - out["master_ms"], 3)
        out["d_demod_ms"] = round(out["full_ms"] - out["chan_ms"], 3)
        out["realtime_x"] = round((L / fs * 1e3) / out["full_ms"], 3) \
            if out["full_ms"] else 0.0
        print(f"# TABLE ch={B}: master {out['master_ms']} | channelize "
              f"{out['d_channelize_ms']} | demod {out['d_demod_ms']} | full "
              f"{out['full_ms']} ms ({out['realtime_x']}x rt)",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
