#!/usr/bin/env python3
"""Time the AGC kernel and the device busy time of the paths that run it,
for several checkouts of the port in turns, on one GPU.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 compare_trees.py build/parent .

Each checkout runs in a process of its own, in the order given and then in
reverse (A B B A), so that a drift of the card shows as a difference
between the two turns of one tree.  Each process builds its checkout's
kernels (``ffill`` and ``agc``) and times, with ``chip_smoke.py``'s timers
from this script's directory:

- the AGC kernel (linear parameters) at phase 3's shapes, warm and with
  the L2 flushed (``device_ms``), and the walk's cycles per sample;
- the device busy time per block (and the block time) of the 4096-channel
  CAM bank, the MultiBank FM:3072 + USB:512 + CAM:512, and the AM and USB
  receivers at 192 kHz.

Each process prints its results as one ``RESULT {json}`` line; a summary
line per turn follows at the end.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def _smoke():
    spec = importlib.util.spec_from_file_location("smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(root):
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    smoke = _smoke()
    import ka9q_sdr_tpu_torch as port
    from ka9q_sdr_tpu_torch.io import modulate
    from ka9q_sdr_tpu_torch.models import bank as bank_mod
    from ka9q_sdr_tpu_torch.models import receiver
    from ka9q_sdr_tpu_torch.ops import _kernels, agc

    assert Path(port.__file__).resolve().is_relative_to(root), port.__file__
    _kernels.load_all(["ffill", "agc"])
    smi = smoke.nvidia_smi()
    res = {"root": str(root), "smi": smi, "agc": {}, "busy": {}}
    g = torch.Generator(device="cuda").manual_seed(smoke.SEED + 1)
    p = agc.AGCParams.from_mode(-15.0, 6.0, 1.1, 1 / 48e3)
    clock = smoke.sm_clock_hz()
    res["clock_mhz"] = clock / 1e6
    res["walk_cycles"] = smoke.agc_walk_cycles(agc, p, clock, g)
    for B, T, iters in smoke.AGC_TIMED:
        lev, gain, hang = smoke._agc_case(B, T, g)
        st = agc.AGCState(gain, hang)
        warm = smoke.device_ms(lambda: agc.agc_block(st, lev, p), iters)
        cold = smoke.device_ms(lambda: agc.agc_block(st, lev, p), iters,
                               cold=True)
        res["agc"][f"{B}x{T}"] = {"warm_ms": warm, "cold_ms": cold}
        print(f"  agc ({B}, {T}): {warm:.4f} ms warm, {cold:.4f} ms cold",
              flush=True)

    serve = smoke.SERVE
    freqs = smoke.bank_freqs(serve["n_channels"])
    cfg = bank_mod.make_bank_config(serve["n_channels"], "CAM",
                                    samprate=smoke.FS, L=serve["L"],
                                    M=serve["M"])
    bank = bank_mod.ChannelBank(cfg, freqs, device="cuda")
    x = smoke.make_block(0, serve["L"], freqs, smoke.SIGNAL, (), "cuda")
    ms, _, busy = smoke.time_step(lambda: bank.process_i16_pcm(x),
                                  serve["n_channels"], serve["L"], smoke.FS,
                                  "CAM 4096 ch", 20, smi)
    res["busy"]["CAM 4096 ch"] = {"block_ms": ms, "busy_ms": busy}
    del bank

    spec = smoke.MIXED_ROWS[0]
    groups = smoke._mixed_groups(spec)
    mb = bank_mod.MultiBank(groups, samprate=smoke.FS, L=serve["L"],
                            M=serve["M"], device="cuda")
    x = smoke.make_iq(0, serve["L"], smoke.FS, smoke.SEED + 11,
                      fm=[(groups[0][1][c], False)
                          for c in smoke.MIXED_FM_SIG])
    label = "MultiBank " + " + ".join(f"{m}:{n}" for m, n in spec)
    ms, _, busy = smoke.time_step(lambda: mb.process_i16_pcm(x),
                                  sum(n for _, n in spec), serve["L"],
                                  smoke.FS, label, 20, smi)
    res["busy"][label] = {"block_ms": ms, "busy_ms": busy}
    del mb

    fs, rx_if = 192000, 48000.0
    for mode in ("AM", "USB"):
        rx = receiver.make_receiver(mode, device="cuda")
        rx.set_freq(rx_if)
        x = smoke._rx_source(mode, modulate, rx_if, fs, rx.cfg.L)(5)
        label = f"{mode} receiver, 192 kHz"
        ms, _, busy = smoke.time_step(lambda: rx.process(x), 1, rx.cfg.L, fs,
                                      label, 20, smi)
        res["busy"][label] = {"block_ms": ms, "busy_ms": busy}
    print("RESULT " + json.dumps(res), flush=True)
    return 0


def main(roots):
    if not torch.cuda.is_available():
        print("compare_trees: no CUDA device", file=sys.stderr)
        return 2
    results = []
    for root in roots + roots[::-1]:
        print(f"== {root}", flush=True)
        proc = subprocess.run([sys.executable, __file__, "--worker", root],
                              capture_output=True, text=True)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr, flush=True)
            return 1
        line = [s for s in proc.stdout.splitlines() if s.startswith("RESULT ")]
        results.append(json.loads(line[-1][len("RESULT "):]))
    for res in results:
        print(f"{res['root']}: clock {res['clock_mhz']:.0f} MHz, walk "
              f"{res['walk_cycles']:.2f} cycles/sample; agc cold "
              + ", ".join(f"{k} {v['cold_ms']:.4f}"
                          for k, v in res["agc"].items())
              + "; busy " + ", ".join(f"{k} {v['busy_ms']:.3f}"
                                     for k, v in res["busy"].items()),
              flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker(sys.argv[2]))
    sys.exit(main(sys.argv[1:]))
