"""control — network dashboard / remote control (control.c; port of
``ka9q_sdr_tpu.apps.control``).

A standalone process driven purely by the TLV status stream: it joins a
receiver's status group (output data port + 2), decodes every key into a
local mirror, and renders a textual dashboard -- proof the whole receiver
is observable through the protocol alone (control.c:212-411).  Unlike the
reference snapshot (whose command path is stubbed, control.c:51-59), the
--tune/--mode options actually transmit TLV commands.

--once prints one snapshot.  With --ssrc it polls that channel (a command
packet carrying only its OUTPUT_SSRC, which bankd answers with the
channel's status) and waits for the channel's own status: a bankd also
sends bank-wide status without one, ten times a second, and a snapshot of
that alone shows no frequency (the JAX package's control returns on it).
--once gives up after --seconds, or ONCE_SECONDS when that is 0, prints
what it has and returns 1, so an SSRC nobody serves cannot hang it.

Usage:
  python -m ka9q_sdr_tpu_torch.apps.control 239.2.1.1:5004           # watch
  python -m ka9q_sdr_tpu_torch.apps.control 239.2.1.1:5004 --tune 147m435
"""

from __future__ import annotations

import argparse
import math
import sys
import time

from ..net.multicast import setup_mcast
from ..net import status as st
from ..net.status import StatusType
from ..utils.misc import parse_frequency, power2db
from ..utils.bandplan import Bandplan, load_default

__all__ = ["main", "StatusMirror", "OPTION_COMMANDS", "ONCE_SECONDS"]

#: how long --once waits for its snapshot when --seconds is not given
ONCE_SECONDS = 3.0

_FLOAT_KEYS = {
    StatusType.KAISER_BETA,
    StatusType.LOW_EDGE,
    StatusType.HIGH_EDGE,
    StatusType.IF_POWER,
    StatusType.BASEBAND_POWER,
    StatusType.NOISE_DENSITY,
    StatusType.DEMOD_SNR,
    StatusType.DEMOD_GAIN,
    StatusType.FREQ_OFFSET,
    StatusType.PEAK_DEVIATION,
    StatusType.PL_TONE,
    StatusType.PLL_PHASE,
    StatusType.DC_I_OFFSET,
    StatusType.DC_Q_OFFSET,
    StatusType.IQ_IMBALANCE,
    StatusType.IQ_PHASE,
    StatusType.NOISE_BANDWIDTH,
    StatusType.AGC_HEADROOM,
    StatusType.AGC_RECOVERY_RATE,
    StatusType.AGC_HANGTIME,
}
_DOUBLE_KEYS = {
    StatusType.RADIO_FREQUENCY,
    StatusType.FIRST_LO_FREQUENCY,
    StatusType.SECOND_LO_FREQUENCY,
    StatusType.SHIFT_FREQUENCY,
    StatusType.DOPPLER_FREQUENCY,
    StatusType.DOPPLER_FREQUENCY_RATE,
}
_STRING_KEYS = {StatusType.RADIO_MODE}


class StatusMirror:
    """Local mirror of the receiver state, filled from TLV status packets
    (decode_status, control.c:212-411).

    ssrc: when set, packets carrying a DIFFERENT OUTPUT_SSRC are ignored --
    this is how one channel of a bankd (many channels on one status group,
    SSRC = channel + 1) is watched; packets without an OUTPUT_SSRC key
    (the bank-wide status) always apply.  `packets` counts every packet
    applied, `own` those that carried the followed OUTPUT_SSRC."""

    def __init__(self, ssrc: int | None = None):
        self.values: dict[int, object] = {}
        self.packets = 0
        self.own = 0
        self.ssrc = ssrc

    def update(self, data: bytes) -> None:
        if not data or data[0] != 0:
            return
        pairs = list(st.decode_packet(data[1:]))
        ssrcs = [st.decode_int(v) for t, v in pairs
                 if t == StatusType.OUTPUT_SSRC]
        if self.ssrc is not None and any(s != self.ssrc for s in ssrcs):
            return
        self.packets += 1
        self.own += bool(ssrcs)
        for t, v in pairs:
            if t in _DOUBLE_KEYS:
                self.values[t] = st.decode_double(v)
            elif t in _FLOAT_KEYS:
                self.values[t] = st.decode_float(v)
            elif t in _STRING_KEYS:
                self.values[t] = v.decode("ascii", "replace")
            elif t == StatusType.SPECTRUM_128:
                self.values[t] = v   # raw uint8 dB bins
            else:
                self.values[t] = st.decode_int(v)

    def get(self, key, default=None):
        return self.values.get(key, default)

    def render(self, bandplan: Bandplan | None = None) -> str:
        """One dashboard snapshot (the display.c window content, textual)."""
        g = self.get
        lines = []
        freq = g(StatusType.RADIO_FREQUENCY, float("nan"))
        mode = g(StatusType.RADIO_MODE, "?")
        lines.append(f"Freq {freq:,.3f} Hz  Mode {mode}")
        if bandplan and not math.isnan(freq):
            e = bandplan.lookup(freq)
            if e:
                lines.append(f"Band {e.name} [{' '.join(e.mode_names)}]")
        lo = g(StatusType.FIRST_LO_FREQUENCY)
        if lo is not None:
            lo2 = g(StatusType.SECOND_LO_FREQUENCY, 0.0)
            lines.append(f"LO1 {lo:,.3f} Hz  LO2 {lo2:,.3f} Hz  "
                         f"IF {-lo2:,.0f} Hz")
        sh = g(StatusType.SHIFT_FREQUENCY)
        if sh:
            lines.append(f"Shift {sh:+,.1f} Hz")
        low, high = g(StatusType.LOW_EDGE), g(StatusType.HIGH_EDGE)
        if low is not None and high is not None:
            # delta-coded status can deliver one edge before the other
            lines.append(f"Filter {low:+.0f}..{high:+.0f} Hz  "
                         f"beta {g(StatusType.KAISER_BETA, 0):.1f}")
        # option flags + AGC (the reference Options/Demodulator windows)
        flags = []
        for label, key in (("isb", StatusType.INDEPENDENT_SIDEBAND),
                           ("pll", StatusType.PLL_ENABLE),
                           ("square", StatusType.PLL_SQUARE),
                           ("flat", StatusType.FM_FLAT)):
            if g(key):
                flags.append(label)
        ch = g(StatusType.OUTPUT_CHANNELS)
        if ch:
            flags.append("stereo" if ch == 2 else "mono")
        if flags:
            lines.append("Options " + " ".join(flags))
        if g(StatusType.AGC_RECOVERY_RATE) is not None:
            lines.append(
                f"AGC headroom {g(StatusType.AGC_HEADROOM, 0):.0f} dB  "
                f"recovery {g(StatusType.AGC_RECOVERY_RATE, 0):.0f} dB/s  "
                f"hang {g(StatusType.AGC_HANGTIME, 0):.1f} s")
        # front-end hardware gains (radio_status.c:292-307 mirror)
        if g(StatusType.LNA_GAIN) is not None:
            lines.append(
                f"FE gains LNA {g(StatusType.LNA_GAIN, 0)} "
                f"mixer {g(StatusType.MIXER_GAIN, 0)} "
                f"IF {g(StatusType.IF_GAIN, 0)} dB")
        for label, key in (
            ("IF", StatusType.IF_POWER),
            ("Baseband", StatusType.BASEBAND_POWER),
            ("N0", StatusType.NOISE_DENSITY),
        ):
            v = self.get(key)
            if v is not None and v > 0:
                lines.append(f"{label} {power2db(v):6.1f} dB")
        snr = g(StatusType.DEMOD_SNR)
        if snr is not None:
            lines.append(f"SNR {power2db(max(snr, 1e-10)):.1f} dB")
        for label, key, unit in (
            ("Offset", StatusType.FREQ_OFFSET, "Hz"),
            ("Deviation", StatusType.PEAK_DEVIATION, "Hz"),
            ("PL tone", StatusType.PL_TONE, "Hz"),
        ):
            v = g(key)
            if v is not None and not math.isnan(v):
                lines.append(f"{label} {v:.1f} {unit}")
        if g(StatusType.PLL_LOCK) is not None:
            lines.append(f"PLL {'locked' if g(StatusType.PLL_LOCK) else 'unlocked'}")
        lines.append(
            f"[{g(StatusType.OUTPUT_PACKETS, 0)} pkts out, "
            f"{g(StatusType.COMMANDS, 0)} cmds, {self.packets} status]"
        )
        return "\n".join(lines)


#: option strings -> TLV command key/value (display.c:958-986 'o' key);
#: the single source shared by control's --option and display's 'o' prompt
OPTION_COMMANDS = {
    "isb": (StatusType.INDEPENDENT_SIDEBAND, 1),
    "!isb": (StatusType.INDEPENDENT_SIDEBAND, 0),
    "pll": (StatusType.PLL_ENABLE, 1),
    "!pll": (StatusType.PLL_ENABLE, 0),
    "square": (StatusType.PLL_SQUARE, 1),
    "!square": (StatusType.PLL_SQUARE, 0),
    "flat": (StatusType.FM_FLAT, 1),
    "!flat": (StatusType.FM_FLAT, 0),
    "stereo": (StatusType.OUTPUT_CHANNELS, 2),
    "!mono": (StatusType.OUTPUT_CHANNELS, 2),
    "mono": (StatusType.OUTPUT_CHANNELS, 1),
    "!stereo": (StatusType.OUTPUT_CHANNELS, 1),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="control")
    p.add_argument("group", help="receiver PCM group (status = port+2)")
    p.add_argument("--tune", help="send a retune command, e.g. 147m435")
    p.add_argument("--mode", help="set demod mode, e.g. USB")
    p.add_argument("--low", type=float, help="filter low edge, Hz")
    p.add_argument("--high", type=float, help="filter high edge, Hz")
    p.add_argument("--beta", type=float, help="Kaiser window beta")
    p.add_argument("--shift", type=float, help="post-detection shift, Hz")
    p.add_argument("--option", action="append", default=[],
                   choices=sorted(OPTION_COMMANDS),
                   help="set/clear an option flag ('!' prefix clears)")
    p.add_argument("--ssrc", type=int, default=0,
                   help="address one channel of a bankd (SSRC = channel+1): "
                        "commands carry OUTPUT_SSRC and the dashboard "
                        "follows only that channel's status")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--once", action="store_true", help="print one snapshot")
    args = p.parse_args(argv)

    # Command mode: build ONE TLV packet from whatever was requested
    pkt = bytearray([1])
    sent = []
    if args.ssrc:
        st.encode_int(pkt, StatusType.OUTPUT_SSRC, args.ssrc)
    if args.tune:
        st.encode_double(pkt, StatusType.RADIO_FREQUENCY,
                         parse_frequency(args.tune))
        sent.append(f"tune {parse_frequency(args.tune):,.0f} Hz")
    if args.mode:
        st.encode_string(pkt, StatusType.RADIO_MODE, args.mode.upper())
        sent.append(f"mode {args.mode.upper()}")
    if args.low is not None:
        st.encode_float(pkt, StatusType.LOW_EDGE, args.low)
        sent.append(f"low {args.low:+.0f}")
    if args.high is not None:
        st.encode_float(pkt, StatusType.HIGH_EDGE, args.high)
        sent.append(f"high {args.high:+.0f}")
    if args.beta is not None:
        st.encode_float(pkt, StatusType.KAISER_BETA, args.beta)
        sent.append(f"beta {args.beta:.1f}")
    if args.shift is not None:
        st.encode_double(pkt, StatusType.SHIFT_FREQUENCY, args.shift)
        sent.append(f"shift {args.shift:+.0f}")
    for opt in args.option:
        key, val = OPTION_COMMANDS[opt]
        st.encode_int(pkt, key, val)
        sent.append(opt)
    if sent:
        st.encode_eol(pkt)
        sock = setup_mcast(args.group, output=True, offset=2)
        sock.send(bytes(pkt))
        sock.close()
        print("sent", ", ".join(sent))
        return 0

    bp = load_default()
    sock = setup_mcast(args.group, output=False, offset=2)
    sock.settimeout(1.0)
    mirror = StatusMirror(args.ssrc or None)
    seconds = args.seconds or (ONCE_SECONDS if args.once else 0.0)
    if args.once and args.ssrc:
        # joined first, so the answer to the poll is not missed
        poll = bytearray([1])
        st.encode_int(poll, StatusType.OUTPUT_SSRC, args.ssrc)
        st.encode_eol(poll)
        cmd = setup_mcast(args.group, output=True, offset=2)
        cmd.send(bytes(poll))
        cmd.close()
    t0 = time.monotonic()
    try:
        while True:
            try:
                mirror.update(sock.recv(9000))
            except TimeoutError:
                pass
            done = args.once and (mirror.own if args.ssrc
                                  else mirror.packets)
            late = seconds and time.monotonic() - t0 > seconds
            if not args.once:
                print("\x1b[2J\x1b[H", end="")
            if done or late or not args.once:
                print(mirror.render(bp), flush=True)
            if done or late:
                return 1 if args.once and not done else 0
    except KeyboardInterrupt:
        return 0
    finally:
        sock.close()


if __name__ == "__main__":
    sys.exit(main())
