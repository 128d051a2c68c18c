"""The port's benchmark: one run of one cell.

    python3 -m sdrbench.run --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout that holds ``BENCHMARK.json``, this directory
and ``ka9q_sdr_tpu_torch``.  Set-up makes the cell's one-second loop of
int16 I/Q from the seed on the card, builds the configuration's bank,
and warms up the cell's entry (which captures its CUDA graph; the kernels
load from ``build/``, built there at a checkout's first run) before it
puts the bank back to its fresh state.  The window then serves blocks
for S seconds (``serve.run_window``); once it has closed, the memory peak
is read, the program is freed and every served block is held against
the plain reference (``compare``).  A traced run (``--trace 1``) also
runs ``torch.profiler`` over two seconds of the window and times the
cell's kernels alone after it, and reports the per-layer metrics.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` (traced)
and, last, ``checks`` (each compared number and its limit), which also
close standard error.  Without a CUDA card, or with fewer than the cell
asks for, it exits 2 and prints no result; it never runs on the CPU.
"""

from __future__ import annotations

import time

_T0 = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

#: blocks a traced run serves under the profiler after the window
TRACE_BLOCKS = {"closed": 100, "open": 50}

#: top-level module names that the run's process must never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "ka9q_sdr_tpu")


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among `modules` (sys.modules), each
    compared as a whole string (``ka9q_sdr_tpu_torch`` is not
    ``ka9q_sdr_tpu``)."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(t for t in tops if t in FORBIDDEN)


def _caches(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program's kernels build into ``build/`` at the root by
    themselves)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(root / "build" / "sdrbench" / sub))
    os.environ.setdefault("USE_FLAX", "0")


@dataclass
class Run:
    """What a run recorded, for the metric readers."""

    cfg: dict
    device: str
    seconds: float
    loop: str
    period: float
    setup_s: float = 0.0
    peak_reserved: int = 0
    blocks: list = field(default_factory=list)   # serve.Block
    dev_ms: list = field(default_factory=list)   # (before, after, copied)
    kernel: dict = field(default_factory=dict)   # name -> (ms, bytes)
    trace: dict | None = None                     # devtime.reduce_events

    @property
    def n_channels(self) -> int:
        return sum(n for _, n in self.cfg["groups"])

    @property
    def L(self) -> int:
        return self.cfg["L"]


def run_cell(cfg: dict, traffic: dict, limits: dict, seed: int,
             seconds: float, trace: bool, device, system_factory=None,
             kernel_reps: int = 20) -> dict:
    """Set up, serve the window, compare, and return the result line's
    parts (without the metrics' reduction to the cell's list)."""
    import torch

    from . import compare, devtime, generator, program, serve

    fs = float(cfg["samprate"])
    L = cfg["L"]
    groups = program.channel_freqs(cfg)
    plan = generator.draw(groups, fs, traffic["signals"], seed)
    blocks = generator.make_loop(plan, L, traffic["noise_rms"], seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    compact = bool(traffic.get("compact"))
    make = system_factory or program.System
    system = make(cfg, compact, device)
    check = compare.Check(groups, plan, cfg, traffic, seed)
    loop = traffic["loop"]
    for _ in range(2):                      # capture, then one replay
        out = system.call(blocks[0])
    egress = serve.Egress(out, serve.DEPTH if loop == "closed" else 1,
                          device)
    egress.start(out, 0)
    del out
    system.reset()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    period = L / fs                         # the wire rate
    rec = Run(cfg, _device_name(device), seconds, loop, period)
    rec.setup_s = time.monotonic() - _T0
    win = serve.run_window(system.call, blocks, egress, device, loop=loop,
                           seconds=seconds, period=period, keep=check.keep)
    rec.blocks = win.blocks
    rec.dev_ms = win.device_ms()
    if device.type == "cuda":
        rec.peak_reserved = torch.cuda.max_memory_reserved(device)
    found = forbidden_modules()
    traced = None
    if trace:
        # the profiler over blocks served after the window, so it slows
        # no block the metrics read; they are compared as well
        with devtime.Trace(device) as tr:
            serve.run_window(system.call, blocks, egress, device, loop=loop,
                             seconds=seconds, period=period, keep=check.keep,
                             count=TRACE_BLOCKS[loop],
                             first=len(win.blocks))
        traced = rec.trace = tr.reduce()
        rec.kernel = _kernels(cfg, device, seed, kernel_reps)
    del system, egress, win
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.monotonic()
    numbers = check.compare(blocks, device)
    print(f"# reference over {max(check.kept) + 1 if check.kept else 0} "
          f"blocks: {time.monotonic() - t_ref:.1f} s", file=sys.stderr,
          flush=True)
    print(f"# largest gaps at (block, group, channel): {check.where}",
          file=sys.stderr, flush=True)
    print(f"# numbers: {json.dumps(numbers)}", file=sys.stderr, flush=True)
    checks = {k: {"value": numbers.get(k), "limit": v}
              for k, v in limits.items()}
    correct = (bool(check.kept) and not found and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values()))
    errors = sum(1 for b in rec.blocks if b.error)
    late = 0
    if loop == "open":
        from .yardstick import late_blocks, latencies_ms, percentile

        late = late_blocks([b.done for b in rec.blocks],
                           [b.due for b in rec.blocks], period)
        lat = latencies_ms([b.due for b in rec.blocks],
                           [b.done for b in rec.blocks])
        fifths = [lat[k * len(lat) // 5:(k + 1) * len(lat) // 5]
                  for k in range(5)]
        print("# latency ms p50 / p90 / p95 / p99 / max: " + " / ".join(
            f"{percentile(lat, q):.3f}" for q in (50, 90, 95, 99, 100))
            + "; p95 of each fifth of the window: " + " / ".join(
                f"{percentile(f, 95) or float('nan'):.3f}" for f in fifths),
            file=sys.stderr, flush=True)
        print("# medians, all blocks / the slowest 5%: " + _parts(
            rec.blocks, rec.dev_ms, lat), file=sys.stderr, flush=True)
    return {"rec": rec, "correct": correct, "attempted": len(rec.blocks),
            "failed": errors + late, "checks": checks, "numbers": numbers,
            "forbidden": found, "traced": traced}


def _parts(blocks, dev_ms, lat) -> str:
    """Where an open loop's block latency went: the median of each part
    (ms) over all blocks and over the slowest 5% (late + call_host +
    wait_host is the latency; device and egress are on the card)."""
    import numpy as np

    parts = {"late": [(b.call - b.due) * 1e3 for b in blocks],
             "call_host": [(b.ret - b.call) * 1e3 for b in blocks],
             "wait_host": [(b.done - b.ret) * 1e3 for b in blocks],
             "device": [d[1] - d[0] if d else np.nan for d in dev_ms],
             "egress": [d[2] - d[1] if d else np.nan for d in dev_ms]}
    slow = np.argsort(lat)[-max(1, len(lat) // 20):]
    return ", ".join(
        f"{k} {np.nanmedian(v):.3f} / {np.nanmedian(np.take(v, slow)):.3f}"
        for k, v in parts.items())


def _kernels(cfg: dict, device, seed: int, reps: int) -> dict:
    """The cell's kernels alone, cold: the FM group's two fills, and the
    linear groups' AGC calls.  {name: (ms, bytes)}."""
    from . import devtime, program, yardstick
    from .reference.core import mode_row

    if device.type != "cuda":
        return {}
    L_dec = cfg["L"] // round(float(cfg["samprate"]) / 48000.0)
    out = {}
    fm = [n for m, n in cfg["groups"] if mode_row(m).demod == "FM"]
    if fm:
        ms = devtime.cold_ms(program.fill_call((fm[0], L_dec), device, seed),
                             reps)
        out["ffill"] = (ms, yardstick.fill_bytes(fm[0], L_dec))
    lin = [(m, n) for m, n in cfg["groups"] if mode_row(m).demod == "LINEAR"]
    if lin:
        ms = sum(devtime.cold_ms(program.agc_call((n, L_dec), device, seed,
                                                  [m]), reps)
                 for m, n in lin)
        out["agc"] = (ms, sum(yardstick.agc_bytes(n, L_dec) for _, n in lin))
    return out


def _device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def report(bench: dict, workload: str, res: dict, trace: bool,
           device_count: int) -> dict:
    """The result line from a run's record."""
    from . import cells

    rec = res["rec"]
    metrics = {}
    for m in cells.metrics_for(bench, workload, trace):
        v = cells.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": rec.device, "count": device_count,
           "memory_peak_bytes": rec.peak_reserved}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": dev}
    t = res.get("traced")
    if trace:
        if t is not None:
            dev["busy_s"] = t["busy_s"]
            dev["window_s"] = t["window_s"]
            line["breakdown"] = {"device_ops": t["device_ops"],
                                 "idle_gaps": t["idle_gaps"]}
        else:
            dev["busy_s"] = None
            dev["window_s"] = None
    line["checks"] = res["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sdrbench.run", description=__doc__
                                 .split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    _caches(root)
    from . import cells

    bench = cells.benchmark(root)
    cell = cells.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"sdrbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr, flush=True)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(f"# {_power_limit()}", file=sys.stderr, flush=True)
    res = run_cell(cells.config(cell["config"]),
                   cells.traffic(cell["traffic"]), cells.limits(args.workload),
                   args.seed, args.seconds, bool(args.trace), device)
    line = report(bench, args.workload, res, bool(args.trace), cell["chips"])
    found = res["forbidden"] or forbidden_modules()
    if found:
        print(f"sdrbench: the run's process holds {', '.join(found)}; no "
              "result", file=sys.stderr, flush=True)
        return 3
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr,
              flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
