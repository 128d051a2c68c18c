"""`python -m ka9q_sdr_tpu_torch` — list the port's daemons."""

import sys

APPS = {
    "radio": "core receiver: I/Q in, PCM + status out (main.c/radio.c)",
    "bankd": "multichannel bank on one CUDA card: N channels, one FFT",
    "frontend": "front-end daemon/simulator with frac-N LO model",
    "iqplay": "replay recordings as RTP I/Q (iqplay.c)",
    "iqrecord": "record RTP sessions with xattr metadata (iqrecord.c)",
    "modulate": "audio -> modulated I/Q test signals (modulate.c)",
    "pcmsend": "raw s16 stdin -> PCM RTP (pcmsend.c)",
    "packetd": "AFSK/AX.25 packet demodulator (packet.c)",
    "aprs": "APRS position monitor with look angles (aprs.c)",
    "aprsfeed": "APRS-IS i-gate (aprsfeed.c)",
}


def main() -> int:
    print("ka9q_sdr_tpu_torch — ka9q-radio on PyTorch/CUDA.  Daemons:")
    for name, desc in APPS.items():
        print(f"  python -m ka9q_sdr_tpu_torch.apps.{name:<9} {desc}")
    print("\nDocs: README.md, PERF.md")
    return 0


if __name__ == "__main__":
    sys.exit(main())
