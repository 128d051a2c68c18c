"""Flagship benchmark of the port: multichannel demodulation throughput on
one CUDA card (the twin of ``bench.py`` at the root of the repo).

Metric: channels x Msamples/sec of wideband I/Q demodulated per card,
sustained (BASELINE.json): blocks/sec x L x n_channels, which exceeds real
time when the card has headroom.  The rows, their environment knobs
(names, defaults, order) and their inputs are bench.py's:

- the headline: FM with the PL-tone chain on, 8192 channels x 393.216 Msps
  on long blocks (L 58,195,968, N = 2^26), one step a block, with the
  p50/p99 block round trip;
- the serving sweep: FM+PL at 4096, 5120 and 6144 channels on 20 ms
  blocks, ``BENCH_CHUNK`` blocks a call (``process_scan_i16``);
- the cadence frontier (``BENCH_FRONTIER=1``): 20 ms blocks one step a
  block, and 62.7 ms blocks (L_dec 3008, N = 2^25);
- the scaling row: FM+PL 2048 channels on long blocks;
- the mixed rows: ``MultiBank`` groups (FM + USB + CAM) off one master FFT,
  float32 ingest;
- the CAM (PLL) rows: 4096 channels x 393.216 Msps on 20 ms blocks, one
  step a block, and 2048 channels x 24.576 Msps as a scan.

Every call goes through the captured wrappers that ``apps/bankd`` serves
with (``utils/graphs.StepGraphs``: one CUDA graph replay a call), on
device-resident inputs: each row's block is made on the host with numpy
(``bench_inputs`` / ``mixed_inputs``, bit for bit bench.py's), copied to
the card once, and a scan's chunk is broadcast on the card.  Every variant
is called once before its first timed call, so no capture lands in a
timed window.

Timing is bench.py's method on the card: the throughput is the slope
between a short and a long run of calls on the host clock, each run ending
in ``torch.cuda.synchronize()`` (so the constant end-of-run cost cancels);
the round trip is one ``process_i16`` and a two-sample copy to the host,
p50 and p99 over ``max(10, iters)`` calls.  Each row adds a ``#`` line on
stderr with the slope's ms/block, the device's ms/block by CUDA events
(``utils/timing.cuda_ms``), the peak memory allocated during the row
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``) and
how far ``ops.ffill.launches`` and ``ops.agc.launches`` moved.

Prints ONE JSON line on stdout: {"metric", "value", "unit",
"vs_baseline", "device", "power_limit_w"}; the rows go to stderr as
comments.  ``BENCH_CHANNELS=0`` skips the headline and with it the stdout
line.  There is no fallback: a row that raises ends the run with a
non-zero status.  Without a CUDA device it exits 2; ``--cpu`` runs on the
host (a control-flow check for the tests, never a device figure).

Usage:
  python -m ka9q_sdr_tpu_torch.bench
  BENCH_ITERS=10 BENCH_SERVE_CHANNELS=4096 python -m ka9q_sdr_tpu_torch.bench
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from .models.bank import ChannelBank, MultiBank, make_bank_config
from .ops import agc, ffill
from .utils.runtime import configure_torch
from .utils.timing import cuda_ms

__all__ = ["main", "bench_inputs", "mixed_inputs", "slope_lo_iters"]

#: 1 channel x 0.192 Msps per CPU core (BASELINE.md)
BASELINE = 0.192


def bench_inputs(n_channels: int, samprate: float, L: int):
    """bench.py's frequency list and (L, 2) int16 block for a bank row
    (bench.py:40-54): n_channels over 90% of the span, and default_rng(1)
    complex noise at 0.01 plus 0.2 carriers on channels 3, n/2 and n-5."""
    usable = 0.9 * samprate
    freqs = list(np.linspace(-usable / 2, usable / 2, n_channels,
                             endpoint=False))
    rng = np.random.default_rng(1)
    tt = np.arange(L) / samprate
    x = 0.01 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
    for ch in (3, n_channels // 2, n_channels - 5):
        x += 0.2 * np.exp(2j * np.pi * freqs[ch] * tt)
    x = x.astype(np.complex64)
    x_i = np.empty((L, 2), np.int16)
    x_i[:, 0] = np.clip(x.real * 32767, -32768, 32767)
    x_i[:, 1] = np.clip(x.imag * 32767, -32768, 32767)
    return freqs, x_i


def mixed_inputs(groups_spec, samprate: float, L: int):
    """bench.py's MultiBank groups and (L, 2) float32 block
    (bench.py:144-157): the channels of every group over 90% of the span
    in order, and default_rng(2) noise at 0.01 plus a 0.2 carrier on each
    group's middle channel."""
    total = sum(n for _, n in groups_spec)
    usable = 0.9 * samprate
    all_freqs = np.linspace(-usable / 2, usable / 2, total, endpoint=False)
    groups, i = [], 0
    for mode, n in groups_spec:
        groups.append((mode, list(all_freqs[i:i + n])))
        i += n
    rng = np.random.default_rng(2)
    tt = np.arange(L) / samprate
    x = 0.01 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
    for _, freqs in groups:
        x += 0.2 * np.exp(2j * np.pi * freqs[len(freqs) // 2] * tt)
    x_r = np.stack([x.real, x.imag], axis=-1).astype(np.float32)
    return groups, x_r


def slope_lo_iters(iters: int) -> int:
    """The short run's length for `iters` timed calls (bench.py:110);
    raises where it leaves no call for the slope."""
    lo_it = max(2, iters // 8)
    if iters - lo_it <= 0:
        raise ValueError(f"{iters} timed calls leave none past the short "
                         f"run's {lo_it}: the slope needs at least 3")
    return lo_it


def _sync(dev):
    if dev.type == "cuda":
        return lambda: torch.cuda.synchronize(dev)
    return lambda: None


def _slope_s(call, iters: int, chunk: int, sync) -> float:
    """Seconds a block, by the slope between a short and a long run of
    call() (bench.py:94-113)."""
    def run(n):
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        sync()
        return time.perf_counter() - t0

    lo_it = slope_lo_iters(iters)
    t_lo = run(lo_it)
    t_hi = run(iters)
    return (t_hi - t_lo) / ((iters - lo_it) * chunk)


class _Row:
    """What a row reports beside bench.py's line: the peak memory since the
    row began and the kernel launches it made."""

    def __init__(self, dev):
        self.dev = dev
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        self.counts = (ffill.launches, agc.launches)

    def report(self, dt_s: float, events_ms: float) -> None:
        fills = ffill.launches - self.counts[0]
        agcs = agc.launches - self.counts[1]
        if self.dev.type == "cuda":
            peak = torch.cuda.max_memory_allocated(self.dev)
            ev = f"{events_ms:.4f} ms/block"
            mem = f"{peak} B ({peak / 2**30:.3f} GiB)"
        else:
            ev = mem = "not measured (cpu)"
        print(f"#   row: slope {dt_s * 1e3:.4f} ms/block | CUDA events {ev} "
              f"| peak allocated {mem} | launches ffill +{fills} agc "
              f"+{agcs}", file=sys.stderr, flush=True)


def _events_ms(dev, call, iters: int, chunk: int) -> float:
    """Device ms a block by CUDA events around `iters` calls."""
    if dev.type != "cuda":
        return float("nan")
    return cuda_ms(call, iters) / chunk


def _release(dev) -> None:
    """Free what a dropped row held, between rows and outside any capture
    (a wrapper's graphs torn down inside a capture would break it)."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _measure(dev, mode, n_channels, samprate, L, M, warmup, iters,
             use_scan=True, measure_latency=True, **cfg_kw):
    """One bank row (bench.py's ``_measure``): (samples/sec, p50 ms,
    p99 ms), NaN latencies where not measured."""
    print(f"# measuring {mode} {n_channels} ch x {samprate/1e6:.3f} Msps "
          f"L={L}...", file=sys.stderr, flush=True)
    row = _Row(dev)
    cfg = make_bank_config(n_channels, mode, samprate=samprate, L=L, M=M,
                           **cfg_kw)
    freqs, x_i = bench_inputs(n_channels, samprate, L)
    bank = ChannelBank(cfg, freqs, device=dev)
    sync = _sync(dev)
    chunk = int(os.environ.get("BENCH_CHUNK", "8"))
    x_dev = torch.as_tensor(x_i, device=dev)          # the one upload
    del x_i
    for _ in range(max(1, warmup)):       # captures the k = 1 step
        bank.process_i16(x_dev)
    sync()
    xs_dev = None
    if use_scan:
        # the chunk broadcast on the device (bench.py:69-76)
        xs_dev = x_dev.expand((chunk,) + tuple(x_dev.shape)).contiguous()

        def call():
            return bank.process_scan_i16(xs_dev)

        call()                            # captures the scan
        sync()
    else:
        chunk = 1

        def call():
            return bank.process_i16(x_dev)

    dt = _slope_s(call, iters, chunk, sync)
    events = _events_ms(dev, call, iters, chunk)
    p50 = p99 = float("nan")
    if measure_latency:
        lat = []
        for _ in range(max(10, iters)):
            t1 = time.perf_counter()
            bank.process_i16(x_dev)[0].ravel()[:2].cpu()
            lat.append(time.perf_counter() - t1)
        lat = np.sort(lat)
        p50 = float(lat[len(lat) // 2]) * 1e3
        p99 = float(lat[min(len(lat) - 1, int(len(lat) * 0.99))]) * 1e3
    row.report(dt, events)
    del bank, call, x_dev, xs_dev
    _release(dev)
    return L / dt, p50, p99


def _measure_mixed(dev, groups_spec, samprate, L, M, warmup, iters):
    """A mixed-mode row (bench.py's ``_measure_mixed``): several demod
    groups off one master FFT, float32 ingest.  (samples/sec, channels)."""
    total = sum(n for _, n in groups_spec)
    print(f"# measuring MultiBank {'+'.join(f'{m}:{n}' for m, n in groups_spec)}"
          f" x {samprate/1e6:.3f} Msps L={L}...", file=sys.stderr, flush=True)
    row = _Row(dev)
    groups, x_r = mixed_inputs(groups_spec, samprate, L)
    mb = MultiBank(groups, samprate=samprate, L=L, M=M, device=dev)
    sync = _sync(dev)
    x_dev = torch.as_tensor(x_r, device=dev)
    del x_r

    def call():
        return mb.process(x_dev)

    for _ in range(max(1, warmup)):
        call()
    sync()
    dt = _slope_s(call, iters, 1, sync)
    row.report(dt, _events_ms(dev, call, iters, 1))
    del mb, call, x_dev
    _release(dev)
    return L / dt, total


def _watchdog():
    """Exit the process with status 3 after BENCH_DEADLINE_S (default 90
    min; 0 disables): an unattended run must not hang on the card.  Returns
    the timer (None when disabled)."""
    deadline = float(os.environ.get("BENCH_DEADLINE_S", "5400"))
    if deadline <= 0:
        return None

    def boom():
        print(f"# bench watchdog: {deadline:.0f}s deadline hit — aborting "
              "(the run hung on the card; BENCH_DEADLINE_S=0 disables)",
              file=sys.stderr, flush=True)
        os._exit(3)

    t = threading.Timer(deadline, boom)
    t.daemon = True
    t.start()
    return t


def _device_facts(dev):
    """(device name, power limit in W) for the result line: the first
    card's name and nvidia-smi's power limit, or ("cpu", None)."""
    if dev.type != "cuda":
        return "cpu", None
    name = torch.cuda.get_device_name(0)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"# {out}", file=sys.stderr, flush=True)
    try:
        power = float(out.rsplit(",", 1)[1].split()[0])
    except (IndexError, ValueError):
        power = None                        # e.g. "[N/A]"
    return name, power


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="bench", description="channels x Msps demodulated on one card "
        "(bench.py's rows; knobs are its BENCH_* environment variables)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host CPU: a control-flow check, never "
                    "a device figure")
    args = ap.parse_args(argv)
    dev = configure_torch(args.cpu, "bench")
    timer = _watchdog()
    try:
        return _run(dev)
    finally:
        if timer is not None:
            timer.cancel()


def _run(dev) -> int:
    n_channels = int(os.environ.get("BENCH_CHANNELS", "8192"))
    samprate = float(os.environ.get("BENCH_SAMPRATE", str(393.216e6)))
    L = int(os.environ.get("BENCH_L", str(58195968)))    # L_dec = 7104
    M = int(os.environ.get("BENCH_M", str(8912897)))     # M_dec = 1089
    warmup = int(os.environ.get("BENCH_WARMUP", "3"))
    iters = int(os.environ.get("BENCH_ITERS", "20"))
    ref_L = int(os.environ.get("BENCH_REF_L", str(7864320)))   # 20 ms
    # comma list; "0" skips the sweep
    serve_channels = [
        int(s) for s in
        os.environ.get("BENCH_SERVE_CHANNELS", "4096,5120,6144").split(",")
        if int(s) > 0
    ]
    frontier = os.environ.get("BENCH_FRONTIER", "0") != "0"
    pll_channels = int(os.environ.get("BENCH_PLL_CHANNELS", "2048"))
    pll_samprate = float(os.environ.get("BENCH_PLL_SAMPRATE", str(24.576e6)))
    pll_L = int(os.environ.get("BENCH_PLL_L", str(491520)))
    pll_M = int(os.environ.get("BENCH_PLL_M", str(557057)))
    try:
        slope_lo_iters(iters)
    except ValueError as e:
        print(f"bench: BENCH_ITERS={iters}: {e}", file=sys.stderr, flush=True)
        return 2
    name, power = _device_facts(dev)

    # Headline: FM with the PL-tone chain on, long blocks, one step a block
    if n_channels > 0:        # BENCH_CHANNELS=0 -> measure other rows only
        sps, p50, p99 = _measure(
            dev, "FM", n_channels, samprate, L, M, warmup,
            max(8, iters // 2), enable_pl=True, use_scan=False,
        )
        # channels x Msps; vs_baseline from the printed value, so the
        # line's two numbers agree at a rounding boundary
        value = round(n_channels * sps / 1e6, 3)
        print(
            json.dumps(
                {
                    "metric": "channels_x_Msps_demodulated_per_chip",
                    "value": value,
                    "unit": "ch*Msps",
                    "vs_baseline": round(value / BASELINE, 1),
                    "device": name,
                    "power_limit_w": power,
                }
            ),
            flush=True,
        )
        print(
            f"# FM+PL {n_channels} ch x {samprate/1e6:.3f} Msps bank "
            f"(long blocks, L={L}): {sps/1e6:.2f} Msps achieved "
            f"({sps/samprate:.2f}x realtime), "
            f"round-trip p50 {p50:.2f} ms / p99 {p99:.2f} ms",
            file=sys.stderr, flush=True,
        )

    # Serving sweep: the 20 ms cadence at several widths, as scans
    if ref_L > 0 and serve_channels:
        for sc in serve_channels:
            sps_r, p50r, p99r = _measure(
                dev, "FM", sc, samprate, ref_L, M, warmup, iters,
                enable_pl=True,
            )
            print(
                f"# FM+PL {sc} ch x {samprate/1e6:.3f} Msps bank "
                f"(20 ms blocks, serving cadence): {sps_r/1e6:.2f} Msps "
                f"({sps_r/samprate:.2f}x realtime), "
                f"{sc*sps_r/1e6:.0f} ch*Msps, "
                f"round-trip p50 {p50r:.2f} ms / p99 {p99r:.2f} ms",
                file=sys.stderr, flush=True,
            )

    # Cadence frontier: 20 ms one step a block, and the 62.7 ms midpoint
    if frontier and ref_L > 0 and n_channels > 0:
        sps_k1, _, _ = _measure(
            dev, "FM", n_channels, samprate, ref_L, M, warmup, iters,
            enable_pl=True, use_scan=False, measure_latency=False,
        )
        print(
            f"# frontier 20 ms k=1 (no scan chunking): "
            f"{sps_k1/1e6:.2f} Msps ({sps_k1/samprate:.2f}x realtime), "
            f"{n_channels*sps_k1/1e6:.0f} ch*Msps  [N/L=2.13]",
            file=sys.stderr, flush=True,
        )
        L_mid = 3008 * round(samprate / 48000)          # 62.7 ms, N=2^25
        sps_m, _, _ = _measure(
            dev, "FM", n_channels, samprate, L_mid, M, warmup,
            max(6, iters // 2), enable_pl=True, use_scan=False,
            measure_latency=False,
        )
        print(
            f"# frontier 62.7 ms (L_dec=3008): "
            f"{sps_m/1e6:.2f} Msps ({sps_m/samprate:.2f}x realtime), "
            f"{n_channels*sps_m/1e6:.0f} ch*Msps  [N/L=1.36]",
            file=sys.stderr, flush=True,
        )

    # Scaling row: 2048 channels on long blocks
    if os.environ.get("BENCH_SCALING", "1") != "0":
        sps_s, _, _ = _measure(
            dev, "FM", 2048, samprate, L, M, warmup, max(6, iters // 2),
            enable_pl=True, use_scan=False, measure_latency=False,
        )
        print(
            f"# scaling: 2048 ch long blocks: {sps_s/1e6:.2f} Msps "
            f"({sps_s/samprate:.2f}x realtime), "
            f"{2048*sps_s/1e6:.0f} ch*Msps",
            file=sys.stderr, flush=True,
        )

    # Mixed-mode rows: FM + USB + CAM groups sharing one master FFT at the
    # 20 ms cadence; ';'-separated specs, "0" skips
    mixed_specs = os.environ.get(
        "BENCH_MIXED",
        "FM:3072,USB:512,CAM:512;FM:5120,USB:512,CAM:512")
    if mixed_specs not in ("", "0"):
        for mixed_spec in mixed_specs.split(";"):
            spec = [(s.split(":")[0], int(s.split(":")[1]))
                    for s in mixed_spec.split(",")]
            sps_mx, total_mx = _measure_mixed(
                dev, spec, samprate, ref_L, M, warmup, iters
            )
            print(
                f"# MultiBank {'+'.join(f'{m} {n}' for m, n in spec)} x "
                f"{samprate/1e6:.3f} Msps (20 ms blocks, shared master FFT): "
                f"{sps_mx/1e6:.2f} Msps ({sps_mx/samprate:.2f}x realtime), "
                f"{total_mx*sps_mx/1e6:.0f} ch*Msps",
                file=sys.stderr, flush=True,
            )

    # Heaviest-mode rows: PLL (CAM) banks
    if pll_channels > 0:
        wide_sr = float(os.environ.get("BENCH_PLL_WIDE_SAMPRATE",
                                       str(393.216e6)))
        wide_ch = int(os.environ.get("BENCH_PLL_WIDE_CHANNELS", "4096"))
        if wide_sr > 0 and wide_ch > 0:
            sps_w, p50w, p99w = _measure(
                dev, "CAM", wide_ch, wide_sr, 7864320, 8912897,
                warmup, iters, use_scan=False,
            )
            print(
                f"# CAM(PLL) {wide_ch} ch x {wide_sr/1e6:.3f} Msps "
                f"bank (20 ms blocks, k=1): {sps_w/1e6:.2f} Msps "
                f"({sps_w/wide_sr:.2f}x realtime), "
                f"{wide_ch * sps_w / 1e6:.0f} ch*Msps, "
                f"round-trip p50 {p50w:.2f} ms / p99 {p99w:.2f} ms",
                file=sys.stderr, flush=True,
            )
        sps2, p50b, p99b = _measure(
            dev, "CAM", pll_channels, pll_samprate, pll_L, pll_M, warmup,
            iters
        )
        print(
            f"# CAM(PLL) {pll_channels} ch x {pll_samprate/1e6:.3f} Msps bank: "
            f"{sps2/1e6:.2f} Msps achieved ({sps2/pll_samprate:.2f}x realtime), "
            f"{pll_channels * sps2 / 1e6:.0f} ch*Msps, "
            f"round-trip p50 {p50b:.2f} ms / p99 {p99b:.2f} ms",
            file=sys.stderr, flush=True,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
