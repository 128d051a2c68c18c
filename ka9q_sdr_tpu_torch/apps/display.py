"""display — interactive tuning dashboard (display.c; port of
``ka9q_sdr_tpu.apps.display``).

A curses UI driven entirely by the network protocol (the reference's
display.c runs in-process with `radio`; its control.c network twin was
stubbed — here the receiver is a daemon, so the interactive UI *is* the
network UI): TLV status in on the output group's port+2, TLV tune
commands out on the same socket.

Keys (display.c:745-986 key dispatch):
  Up/Down        adjust the selected item +/- the current step
  Left/Right     move the digit cursor (powers of 10)
  Tab            cycle the adjustable item: frequency, IF (LO2), filter
                 low edge, filter high edge, shift, Kaiser beta
                 (adjust_item, display.c:128-180)
  f              enter a frequency (parse_frequency syntax: 147m435)
  m              enter a mode name (FM, AM, USB, ...)
  k              enter the Kaiser window beta (display.c:940-956)
  o              set/clear an option flag: isb pll square flat stereo
                 mono, '!' prefix disables (display.c:958-986)
  i              recenter the IF at samprate/4 (display.c:912-914)
  q / Ctrl-C     quit
Mouse (display.c:988-1060): click an item line to select it; wheel
tunes the selected item up/down.

Usage:
  python -m ka9q_sdr_tpu_torch.apps.display 239.2.1.1:5004
"""

from __future__ import annotations

import argparse
import math
import sys

from ..net.multicast import setup_mcast
from ..net import status as st
from ..net.status import StatusType
from ..utils.misc import parse_frequency
from ..utils.bandplan import load_default
from .control import OPTION_COMMANDS as OPTION_KEYS, StatusMirror

__all__ = ["main", "TuningState"]


#: Help overlay ('h'/'?', the reference ships help.txt).
HELP_TEXT = """
KA9Q radio display - keys (display.c:745-986)

  Up/Down       adjust the selected item by the current step
  Left/Right    move the digit cursor (step x10 / /10)
  Tab           next item: freq, IF, low edge, high edge, shift, beta
  mouse         click an item line to select; wheel adjusts
  f             enter frequency (forms like 147m435 accepted)
  m             enter mode (FM AM USB LSB CWU CWL IQ ISB CISB CAM DSB AME)
  k             enter Kaiser window beta
  o             option flag: isb pll square flat stereo mono ('!' clears)
  b             blocksize (receiver restarts with L, M=L+1)
  i             recenter IF at +samprate/4
  l             lock/unlock frequency tuning
  u             display update interval (ms)
  w             ask the receiver to save its state file
  h ?           this help
  q Ctrl-C      quit
"""

#: Adjustable items in Tab order (adjust_item, display.c:137-180; the
#: reference's items 0/1 merge into "freq", 2 "First LO" is the front
#: end's to move, so the network UI exposes the IF=LO2 item instead).
ITEMS = ("freq", "if", "low", "high", "shift", "beta")


class TuningState:
    """Digit-cursor + item-cursor tuning model (adjust_item,
    display.c:128-180; tune.item/tune.step semantics)."""

    def __init__(self, step_log10: int = 3):
        self.step_log10 = step_log10   # 10^n per Up/Down
        self.item = 0                  # index into ITEMS

    @property
    def step(self) -> float:
        return 10.0 ** self.step_log10

    @property
    def item_name(self) -> str:
        return ITEMS[self.item]

    def next_item(self):
        self.item = (self.item + 1) % len(ITEMS)

    def prev_item(self):
        """Shift-TAB (README 'User Interface': Shift-TAB moves to the
        previous field)."""
        self.item = (self.item - 1) % len(ITEMS)

    def cursor_left(self):
        self.step_log10 = min(self.step_log10 + 1, 9)

    def cursor_right(self):
        self.step_log10 = max(self.step_log10 - 1, 0)

    def adjust(self, freq: float, direction: int) -> float:
        return freq + direction * self.step


def send_tune(sock, freq: float) -> None:
    pkt = bytearray([1])
    st.encode_double(pkt, StatusType.RADIO_FREQUENCY, freq)
    st.encode_eol(pkt)
    sock.send(bytes(pkt))


def _send_cmd(sock, *pairs, ssrc: int = 0) -> None:
    """Send one TLV command packet of (key, kind, value) triples.  A
    nonzero ssrc stamps OUTPUT_SSRC first, addressing one channel of a
    bankd (SSRC = channel index + 1)."""
    pkt = bytearray([1])
    if ssrc:
        st.encode_int(pkt, StatusType.OUTPUT_SSRC, ssrc)
    for key, kind, value in pairs:
        if kind == "double":
            st.encode_double(pkt, key, value)
        elif kind == "float":
            st.encode_float(pkt, key, value)
        elif kind == "int":
            st.encode_int(pkt, key, int(value))
        else:
            st.encode_string(pkt, key, value)
    st.encode_eol(pkt)
    sock.send(bytes(pkt))


def adjust_command(mirror, tuning: "TuningState", direction: int):
    """Map an Up/Down on the selected item to a TLV command
    (adjust_item, display.c:137-180).  Returns a list of (key, kind,
    value) triples for ONE command packet, or None when the mirror lacks
    the needed current value."""
    g = mirror.get
    d = direction * tuning.step
    name = tuning.item_name
    if name == "freq":
        if getattr(tuning, "freq_lock", False):   # 'l' (display.c:140)
            return None
        f = g(StatusType.RADIO_FREQUENCY)
        return None if f is None else [
            (StatusType.RADIO_FREQUENCY, "double", f + d)]
    if name == "if":
        # item 3: vary RF and LO2 together to keep LO1 the same
        # (display.c:152-159: set_freq(freq + step, lo2 - step)); both
        # keys ride one packet and radio.py applies them as one set_freq
        f = g(StatusType.RADIO_FREQUENCY)
        lo2 = g(StatusType.SECOND_LO_FREQUENCY)
        return None if (f is None or lo2 is None) else [
            (StatusType.RADIO_FREQUENCY, "double", f + d),
            (StatusType.SECOND_LO_FREQUENCY, "double", lo2 - d)]
    if name == "low":
        v = g(StatusType.LOW_EDGE)
        return None if v is None else [(StatusType.LOW_EDGE, "float", v + d)]
    if name == "high":
        v = g(StatusType.HIGH_EDGE)
        return None if v is None else [(StatusType.HIGH_EDGE, "float", v + d)]
    if name == "shift":
        v = g(StatusType.SHIFT_FREQUENCY, 0.0)
        return [(StatusType.SHIFT_FREQUENCY, "double", v + d)]
    if name == "beta":
        v = g(StatusType.KAISER_BETA, 3.0)
        return [(StatusType.KAISER_BETA, "float", max(0.0, v + d))]
    return None


#: screen row of each adjustable item (mouse row -> item, display.c:988)
ITEM_ROW0 = 2


def _render(stdscr, mirror: StatusMirror, tuning: TuningState, bp, msg: str):
    import curses

    stdscr.erase()
    try:
        _render_body(stdscr, mirror, tuning, bp, msg)
    except curses.error:
        pass   # terminal too small: draw what fits (display.c tolerates it)
    stdscr.refresh()


def _render_body(stdscr, mirror: StatusMirror, tuning: TuningState, bp,
                 msg: str):
    import curses

    maxy, maxx = stdscr.getmaxyx()
    g = mirror.get
    freq = g(StatusType.RADIO_FREQUENCY, float("nan"))
    mode = g(StatusType.RADIO_MODE, "?")
    stdscr.addstr(0, 0, "KA9Q radio", curses.A_BOLD)

    def item_attr(name):
        return (curses.A_BOLD if tuning.item_name == name
                else curses.A_NORMAL)

    # Tuning window: frequency with the active digit highlighted
    stdscr.addstr(ITEM_ROW0, 2, "Freq:", item_attr("freq"))
    if not math.isnan(freq):
        digits = f"{int(abs(freq)):,d}"
        target = tuning.step_log10
        count = -1
        idx = len(digits)
        for i in range(len(digits) - 1, -1, -1):
            if digits[i].isdigit():
                count += 1
                if count == target:
                    idx = i
                    break
        pad = 16 - len(digits)
        for i, c in enumerate(digits):
            attr = (curses.A_REVERSE
                    if i == idx and tuning.item_name == "freq"
                    else curses.A_NORMAL)
            stdscr.addstr(ITEM_ROW0, 8 + pad + i, c, attr)
        stdscr.addstr(ITEM_ROW0, 8 + 16, " Hz")
    stdscr.addstr(ITEM_ROW0, 32, f"Mode: {mode}", curses.A_BOLD)
    lo2 = g(StatusType.SECOND_LO_FREQUENCY)
    stdscr.addstr(ITEM_ROW0 + 1, 2,
                  f"IF:   {-(lo2 or 0):>16,.0f} Hz", item_attr("if"))
    low, high = g(StatusType.LOW_EDGE), g(StatusType.HIGH_EDGE)
    stdscr.addstr(ITEM_ROW0 + 2, 2,
                  f"Low:  {low if low is not None else 0:>+16,.0f} Hz",
                  item_attr("low"))
    stdscr.addstr(ITEM_ROW0 + 3, 2,
                  f"High: {high if high is not None else 0:>+16,.0f} Hz",
                  item_attr("high"))
    stdscr.addstr(ITEM_ROW0 + 4, 2,
                  f"Shift:{g(StatusType.SHIFT_FREQUENCY, 0.0):>+16,.0f} Hz",
                  item_attr("shift"))
    stdscr.addstr(ITEM_ROW0 + 5, 2,
                  f"Beta: {g(StatusType.KAISER_BETA, 0.0):>16.1f}",
                  item_attr("beta"))
    # Options summary (the reference's Options window, display.c:348)
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
    stdscr.addstr(ITEM_ROW0 + 1, 32, f"Opts: {' '.join(flags) or '-'}")
    stdscr.addstr(ITEM_ROW0 + 2, 32,
                  f"Step: {tuning.step:,.0f} [{tuning.item_name}]")
    # Info window: bandplan lookup (display.c:338-363, bandplan.c:41-51)
    if bp and not math.isnan(freq):
        e = bp.lookup(freq)
        if e:
            stdscr.addstr(ITEM_ROW0 + 3, 32,
                          f"{e.name} [{' '.join(e.mode_names)}]")
    # spectrum pane: 128-bin sparkline from the status stream
    spec = g(StatusType.SPECTRUM_128)
    if spec and maxx > 70:
        import numpy as _np

        bins = _np.frombuffer(spec, _np.uint8).astype(float)
        lo_, hi_ = bins.min(), max(bins.max(), bins.min() + 1)
        glyphs = " \u2581\u2582\u2583\u2584\u2585\u2586\u2587\u2588"
        w = min(len(bins), maxx - 6)
        line = "".join(
            glyphs[int((bins[i] - lo_) / (hi_ - lo_) * 8) if bins[i] > lo_
                   else 0]
            for i in range(w)
        )
        stdscr.addstr(ITEM_ROW0 + 7, 2, line)
    row = ITEM_ROW0 + 9
    for line in mirror.render().split("\n")[1:]:
        if row >= maxy - 3:
            break
        stdscr.addstr(row, 2, line[: maxx - 3])
        row += 1
    stdscr.addstr(
        maxy - 2, 2,
        "Up/Dn adj  L/R digit  Tab item  f freq  m mode  k beta  o opt  "
        "i IF  q quit"[: maxx - 3],
    )
    if msg:
        stdscr.addstr(maxy - 1, 2, msg[: maxx - 3], curses.A_DIM)


def _prompt(stdscr, label: str) -> str:
    import curses

    maxy, _ = stdscr.getmaxyx()
    curses.echo()
    stdscr.addstr(maxy - 1, 2, label + ": " + " " * 30)
    stdscr.move(maxy - 1, 2 + len(label) + 2)
    stdscr.timeout(-1)
    s = stdscr.getstr().decode()
    stdscr.timeout(100)
    curses.noecho()
    return s.strip()


def run_ui(stdscr, args):
    import curses

    curses.curs_set(0)
    stdscr.timeout(100)
    curses.mousemask(
        curses.BUTTON1_CLICKED | curses.BUTTON4_PRESSED
        | getattr(curses, "BUTTON5_PRESSED", 0)
    )
    status_sock = setup_mcast(args.group, output=False, offset=2)
    status_sock.setblocking(False)
    cmd_sock = setup_mcast(args.group, output=True, offset=2)
    ssrc = getattr(args, "ssrc", 0)
    mirror = StatusMirror(ssrc or None)
    tuning = TuningState()

    def send_cmd(*pairs):
        _send_cmd(cmd_sock, *pairs, ssrc=ssrc)
    bp = load_default()
    msg = ""

    def adjust(direction):
        cmd = adjust_command(mirror, tuning, direction)
        if cmd is not None:
            send_cmd(*cmd)
            return f"{tuning.item_name} {'+' if direction > 0 else '-'}" \
                   f"{tuning.step:,.0f}"
        return "no value yet"

    while True:
        try:
            while True:
                mirror.update(status_sock.recv(9000))
        except (BlockingIOError, OSError):
            pass
        _render(stdscr, mirror, tuning, bp, msg)
        ch = stdscr.getch()
        if ch == -1:
            continue
        if ch in (ord("q"), 3):
            return
        elif ch == curses.KEY_UP:
            msg = adjust(+1)
        elif ch == curses.KEY_DOWN:
            msg = adjust(-1)
        elif ch == curses.KEY_LEFT:
            tuning.cursor_left()
        elif ch == curses.KEY_RIGHT:
            tuning.cursor_right()
        elif ch == ord("\t"):
            tuning.next_item()
        elif ch == curses.KEY_BTAB:     # Shift-TAB: previous field
            tuning.prev_item()
        elif ch == curses.KEY_MOUSE:
            # click selects the item row; wheel adjusts (display.c:988-1060)
            try:
                _, mx, my, _, bstate = curses.getmouse()
            except curses.error:
                continue
            if bstate & curses.BUTTON1_CLICKED:
                if ITEM_ROW0 <= my < ITEM_ROW0 + len(ITEMS):
                    tuning.item = my - ITEM_ROW0
            elif bstate & curses.BUTTON4_PRESSED:
                msg = adjust(+1)
            elif bstate & getattr(curses, "BUTTON5_PRESSED", 0):
                msg = adjust(-1)
        elif ch == ord("f"):
            s = _prompt(stdscr, "Frequency")
            f = parse_frequency(s)
            if f > 0:
                send_tune(cmd_sock, f)
                msg = f"tuned {f:,.0f} Hz"
        elif ch == ord("m"):
            s = _prompt(stdscr, "Mode").upper()
            if s:
                send_cmd((StatusType.RADIO_MODE, "string", s))
                msg = f"sent mode {s}"
        elif ch == ord("k"):
            s = _prompt(stdscr, "Kaiser beta")
            try:
                b = float(s)
            except ValueError:
                continue
            if 0 <= b < 100:
                send_cmd((StatusType.KAISER_BETA, "float", b))
                msg = f"sent beta {b:.1f}"
        elif ch == ord("o"):
            s = _prompt(
                stdscr, "Option [isb pll square flat stereo mono], ! clears"
            ).lower()
            if s in OPTION_KEYS:
                key, val = OPTION_KEYS[s]
                send_cmd((key, "int", val))
                msg = f"sent {s}"
            else:
                msg = f"unknown option {s!r}"
        elif ch == ord("i"):
            # recenter IF at +samprate/4 (display.c:912-914)
            sr = mirror.get(StatusType.INPUT_SAMPRATE)
            if sr:
                send_cmd((StatusType.SECOND_LO_FREQUENCY, "double", sr / 4))
                msg = "IF recentered"
        elif ch == ord("b"):
            # blocksize: L = entry, M = L+1 at the receiver
            # (display.c:866-886)
            s = _prompt(stdscr, "Blocksize (samples)")
            try:
                bs = int(s, 0)
            except ValueError:
                continue
            if bs > 0:
                send_cmd((StatusType.FILTER_BLOCKSIZE, "int", bs))
                msg = f"sent blocksize {bs}"
        elif ch == ord("w"):
            # save receiver state file (display.c:795-805 'w')
            send_cmd((StatusType.SAVE_STATE, "int", 1))
            msg = "state save requested"
        elif ch == ord("l"):
            # frequency lock: ignore tuning on the freq item
            # (display.c:828-832)
            tuning.freq_lock = not getattr(tuning, "freq_lock", False)
            msg = f"frequency {'locked' if tuning.freq_lock else 'unlocked'}"
        elif ch == ord("u"):
            # display update interval (display.c:920-938)
            s = _prompt(stdscr, "Update interval ms (>=50)")
            try:
                u = int(s)
            except ValueError:
                continue
            stdscr.timeout(max(50, u))
            msg = f"update every {max(50, u)} ms"
        elif ch in (ord("h"), ord("?")):
            stdscr.erase()
            try:
                maxy, maxx = stdscr.getmaxyx()
                for i, line in enumerate(HELP_TEXT.strip().split("\n")):
                    if i + 1 >= maxy - 1:
                        break
                    stdscr.addstr(i + 1, 2, line[: maxx - 3])
                stdscr.addstr(min(i + 3, maxy - 1), 2, "press any key")
            except curses.error:
                pass
            stdscr.timeout(-1)
            stdscr.getch()
            stdscr.timeout(100)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="display")
    p.add_argument("group", help="receiver PCM group (status on port+2)")
    p.add_argument("--ssrc", type=int, default=0,
                   help="follow/command one channel of a bankd "
                        "(SSRC = channel index + 1)")
    args = p.parse_args(argv)
    import curses

    try:
        curses.wrapper(run_ui, args)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
