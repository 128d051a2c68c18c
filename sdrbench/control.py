"""The control of ``correct``: the plain reference computed with every
stage rounded to bfloat16 (the next precision below the float32 the
configurations state) put in the program's place, held against the
float64 reference by the cell's own comparison and limits.  It has to
come out not correct.

    python3 -m sdrbench.control --workload NAME --seeds N [N ...] --blocks K

On the card, at the cell's own sizes: for each seed the cell's loop, the
first K blocks through both references, the numbers beside the limits.
Exits 0 when the control fails the limits on every seed, 1 otherwise,
2 without a card.  The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def control_numbers(cfg: dict, traffic: dict, seed: int, blocks: int,
                    device) -> dict:
    """The control's numbers for one seed over the first `blocks` blocks."""
    from . import compare, generator, program
    from .reference.core import Prec

    groups = program.channel_freqs(cfg)
    plan = generator.draw(groups, float(cfg["samprate"]), traffic["signals"],
                          seed)
    loop = generator.make_loop(plan, cfg["L"], traffic["noise_rms"], seed,
                               device)
    check = compare.Check(groups, plan, cfg, traffic, seed)
    return check.compare(loop, device, control=Prec("bfloat16"),
                         n_blocks=blocks)


def fails(numbers: dict, limits: dict) -> list:
    """The limits the numbers break (a missing number breaks its limit)."""
    return [k for k, lim in limits.items()
            if numbers.get(k) is None or numbers[k] > lim]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sdrbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--blocks", type=int, required=True)
    args = ap.parse_args(argv)
    import torch

    from . import cells

    if not torch.cuda.is_available():
        print("sdrbench.control: no CUDA card", file=sys.stderr)
        return 2
    bench = cells.benchmark()
    cell = cells.cell(bench, args.workload)
    cfg, traffic = cells.config(cell["config"]), cells.traffic(cell["traffic"])
    limits = cells.limits(args.workload)
    ok = True
    for seed in args.seeds:
        t0 = time.perf_counter()
        nums = control_numbers(cfg, traffic, seed, args.blocks,
                               torch.device("cuda"))
        broken = fails(nums, limits)
        ok &= bool(broken)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "blocks": args.blocks, "numbers": nums,
                          "limits": limits, "fails": broken,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
