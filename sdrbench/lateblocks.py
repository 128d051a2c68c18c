"""Where each late block of an open-loop cell's window went.

    python3 -m sdrbench.lateblocks --workload mixed6144-live --seed N \\
        --seconds 20

From the root of a checkout, on a CUDA card, as ``sdrbench.run`` is run.
It sets the cell up as ``run`` does and serves one window, without the
profiler and without the reference comparison, then prints a line for
each late block (its outputs on the host after the next block was due):
how late its call came, the host's clock around the entry and the copy's
wait, and the program's block recorder's split of the entry (``put``,
``stagein``, ``launch``, ``clone``; ``recorder.late``).  A program
without a recorder prints the blocks without the split.  The last line
is one JSON object: the cell, the seed, the blocks served, the late
count (the result line's ``failed`` less its errors) and the late blocks.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def serve_window(workload: str, seed: int, seconds: float, device):
    """Set the cell up as ``run.run_cell`` does and serve one window:
    its ``run.Run`` (blocks and device intervals)."""
    import torch

    from . import cells, generator, program, serve
    from .run import Run, _device_name

    bench = cells.benchmark(Path.cwd())
    cell = cells.cell(bench, workload)
    cfg, traffic = cells.config(cell["config"]), cells.traffic(cell["traffic"])
    fs, L = float(cfg["samprate"]), cfg["L"]
    plan = generator.draw(program.channel_freqs(cfg), fs, traffic["signals"],
                          seed)
    blocks = generator.make_loop(plan, L, traffic["noise_rms"], seed, device)
    system = program.System(cfg, bool(traffic.get("compact")), device)
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
    rec = Run(cfg, _device_name(device), seconds, loop, L / fs)
    win = serve.run_window(system.call, blocks, egress, device, loop=loop,
                           seconds=seconds, period=rec.period)
    rec.blocks = win.blocks
    rec.dev_ms = win.device_ms()
    return rec


def _fmt(v) -> str:
    return "-" if v is None else f"{v:.3f}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sdrbench.lateblocks",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from . import recorder
    from .run import _caches

    _caches(Path.cwd())
    import torch

    if not torch.cuda.is_available():
        print("sdrbench.lateblocks: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = serve_window(args.workload, args.seed, args.seconds, device)
    if run.loop != "open":
        print("sdrbench.lateblocks: a closed loop has no late blocks",
              file=sys.stderr)
        return 2
    late = recorder.late(run)
    keys = ("due_to_done", "late", "call", "put", "stagein", "launch",
            "clone", "wait", "device")
    for d in late:
        print(f"block {d['block']}: " + ", ".join(
            f"{k} {_fmt(d.get(k))}" for k in keys) + " ms", flush=True)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "blocks": len(run.blocks), "late": len(late),
                      "late_blocks": late}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
