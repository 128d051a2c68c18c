"""modulate — baseband audio to modulated I/Q test signal (modulate.c).

Reads s16 host-order audio at samprate/4 on stdin, writes interleaved s16
I/Q at samprate on stdout.  Pipe into iqplay's stdin mode to feed the
receiver a known signal (the reference's closed-loop test method).

Usage:
  ... audio source ... | python -m ka9q_sdr_tpu_torch.apps.modulate \\
      -m usb -f 48000 -a -20 | \\
      python -m ka9q_sdr_tpu_torch.apps.iqplay -R 239.1.1.1 -

Port of ``ka9q_sdr_tpu.apps.modulate``: the Modulator runs on the CUDA card
unless --cpu; without a card and without --cpu it exits 2.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io.modulate import Modulator, UPSAMPLE
from ..utils.runtime import configure_torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="modulate")
    p.add_argument("-m", "--mode", default="am", choices=["am", "usb", "lsb", "ame"])
    p.add_argument("-f", "--frequency", type=float, default=48000.0)
    p.add_argument("-a", "--amplitude", type=float, default=-20.0, help="dBFS")
    p.add_argument("-s", "--sweep", type=float, default=0.0, help="Hz/s")
    p.add_argument("-r", "--samprate", type=int, default=192000)
    p.add_argument("-v", "--verbose", action="store_true",
                   help="accepted for reference compatibility")
    p.add_argument("--cpu", action="store_true",
                   help="run the modulator on the host CPU instead of the "
                        "card")
    args = p.parse_args(argv)
    device = configure_torch(args.cpu, "modulate")

    m = Modulator(
        args.mode,
        frequency=args.frequency,
        amplitude_db=args.amplitude,
        sweep_hz_s=args.sweep,
        samprate=args.samprate,
        device=device,
    )
    in_len = m.L // UPSAMPLE
    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer
    while True:
        raw = stdin.read(in_len * 2)
        if not raw:
            return 0
        audio = np.frombuffer(raw, "<i2").astype(np.float32) / 32767.0
        if len(audio) < in_len:
            audio = np.pad(audio, (0, in_len - len(audio)))
        iq = m.process(audio)
        stdout.write(m.to_int16(iq))
        stdout.flush()


if __name__ == "__main__":
    sys.exit(main())
