"""Sustained serving soak of the active-channel bank (the twin of the JAX
package's ``tools/serve_soak.py``).

Deployment shape: an FM+PL bank at 393.216 Msps with 20 ms blocks (the
reference's default cadence, main.c:113-115), device-side active-channel
compaction (``ChannelBank.process_active``, audio.c:102-113's silence
suppression lifted to the bank), each block's PCM, indices and status diag
fetched through ``utils.runtime.HostCopy`` with --depth blocks in flight,
as ``apps/bankd.py``'s serving loop does.  The input is a small rotating
pool of int16 blocks made on the device (FM carriers with a 1 kHz tone at 5
kHz deviation over noise, each pool entry at another tone phase), so no
upload is timed.  Per-block latency is wall time from queuing a block to
its host copy completing, which is what serving latency means.  The run
stops after --seconds or --blocks, and prints one JSON line with the
process's peak resident memory.

Usage:
  python -m ka9q_sdr_tpu_torch.tools.serve_soak --channels 5120 --seconds 600
  python -m ka9q_sdr_tpu_torch.tools.serve_soak --cpu --blocks 40
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import time

import numpy as np
import torch

from ..models.bank import ChannelBank, make_bank_config
from ..utils.runtime import HostCopy, configure_torch
from .stage_profile import fm_block

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="serve_soak")
    ap.add_argument("--channels", type=int, default=5120)
    ap.add_argument("--samprate", type=float, default=393.216e6)
    ap.add_argument("--L", type=int, default=7864320)      # 20 ms block
    ap.add_argument("--M", type=int, default=8912897)      # M_dec = 1089
    ap.add_argument("--seconds", type=float, default=600.0,
                    help="stop after this much wall time")
    ap.add_argument("--blocks", type=int, default=0,
                    help="stop after N blocks (0 = by --seconds only)")
    ap.add_argument("--max-active", type=int, default=64)
    ap.add_argument("--pool", type=int, default=4,
                    help="rotating device-resident input blocks")
    ap.add_argument("--depth", type=int, default=3,
                    help="blocks whose host copies are in flight (bankd: 3)")
    ap.add_argument("--cpu", action="store_true",
                    help="tiny-geometry run on the host CPU")
    args = ap.parse_args(argv)

    dev = configure_torch(args.cpu, "serve_soak")
    if args.cpu:
        args.samprate, args.L, args.M = 1.536e6, 30720, 32769
        args.channels = min(args.channels, 16)
        args.blocks = args.blocks or 40
    B, L = args.channels, args.L
    max_active = min(args.max_active, B)
    block_s = L / args.samprate
    cfg = make_bank_config(B, "FM", samprate=args.samprate, L=L, M=args.M,
                           enable_pl=True)
    usable = 0.9 * args.samprate
    freqs = list(np.linspace(-usable / 2, usable / 2, B, endpoint=False))
    print(f"# building {B}-ch FM+PL bank, {args.samprate / 1e6:.3f} Msps, "
          f"{block_s * 1e3:.1f} ms blocks (L_dec={cfg.L_dec}) on {dev}...",
          file=sys.stderr, flush=True)
    bank = ChannelBank(cfg, freqs, device=dev)
    act = [freqs[ch] for ch in (3, B // 3, B // 2, (2 * B) // 3, B - 5)]
    pool = [fm_block(L, args.samprate, act, 7 + p, dev, deviation=5e3,
                     phase=float(p)) for p in range(args.pool)]

    def step(x):
        pcm, idx, diag = bank.process_active(x, max_active=max_active)
        return HostCopy([pcm, idx, diag.get("snr"), diag.get("bb_power")])

    t0 = time.perf_counter()
    step(pool[0]).wait()
    print(f"# warm-up (kernel builds, FFT plans, first block): "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss

    inflight, lat_ms = [], []
    n = 0
    t_start = time.perf_counter()
    deadline = t_start + args.seconds

    def drain_one():
        t_q, copy = inflight.pop(0)
        copy.wait()
        lat_ms.append((time.perf_counter() - t_q) * 1e3)

    while (n < args.blocks) if args.blocks else (
            time.perf_counter() < deadline):
        inflight.append((time.perf_counter(), step(pool[n % args.pool])))
        n += 1
        if len(inflight) > args.depth:
            drain_one()
        if n % 512 == 0:
            el = time.perf_counter() - t_start
            print(f"# {n} blocks, {el:.0f} s, sustained "
                  f"{n * block_s / el:.2f}x rt", file=sys.stderr, flush=True)
    while inflight:
        drain_one()

    elapsed = time.perf_counter() - t_start
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    lat = np.sort(np.asarray(lat_ms))
    print(json.dumps({
        "channels": B,
        "block_ms": round(block_s * 1e3, 2),
        "blocks": n,
        "elapsed_s": round(elapsed, 3),
        "sustained_rt": round(n * block_s / elapsed, 3),
        "p50_ms": round(float(lat[len(lat) // 2]), 3),
        "p99_ms": round(float(lat[int(len(lat) * 0.99)]), 3),
        "max_ms": round(float(lat[-1]), 3),
        "rss_growth_kb_per_blk": round((rss1 - rss0) / max(n, 1), 2),
        "peak_rss_kb": rss1,
        "device": "cpu" if args.cpu else torch.cuda.get_device_name(dev),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
