"""monitor — multi-stream RTP audio player/mixer (monitor.c; port of
``ka9q_sdr_tpu.apps.monitor``).

Joins any number of PCM/Opus multicast groups, mixes all sessions
additively through the playout ring with per-session jitter buffering,
and writes 48 kHz stereo s16 host-order audio to stdout (pipe to aplay /
a file; the reference's portaudio output has no device in this target).
With -v it prints, at exit, the frames written, the sessions, their late
packets and the samples the s16 conversion clipped.

Usage:
  python -m ka9q_sdr_tpu_torch.apps.monitor 239.2.1.1:5004 \\
      239.2.1.2:5004 > mix.s16
"""

from __future__ import annotations

import argparse
import math
import select
import sys
import time

import numpy as np

from ..audio.playout import Mixer, SAMPRATE
from ..net.multicast import setup_mcast
from ..utils.misc import audio_device_notice


def run_mixer_ui(stdscr, mixer, stop):
    """Session mixer UI (monitor.c:530-733): Up/Down select a session,
    +/- gain, l/r pan, m mute, q quit."""
    import curses

    curses.curs_set(0)
    stdscr.timeout(200)
    sel = 0
    while not stop["quit"]:
        stdscr.erase()
        stdscr.addstr(0, 0, "monitor — sessions", curses.A_BOLD)
        rows = sorted(mixer.sessions.items())
        for i, (ssrc, sess) in enumerate(rows):
            attr = curses.A_REVERSE if i == sel else curses.A_NORMAL
            stdscr.addstr(
                2 + i, 0,
                f"ssrc {ssrc:>8x}  pkts {sess.packets:>7}  "
                f"gain {20*math.log10(max(sess.gain,1e-6)):+5.1f} dB  "
                f"pan {sess.pan:+.2f}  lates {sess.lates}"
                + ("  MUTED" if sess.muted else ""),
                attr,
            )
        stdscr.addstr(
            len(rows) + 3, 0,
            "Up/Dn select  +/- gain  l/r pan  m mute  q quit",
        )
        stdscr.refresh()
        ch = stdscr.getch()
        if ch == -1:
            continue
        if ch == ord("q"):
            stop["quit"] = True
            return
        if not rows:
            continue
        sel = max(0, min(sel, len(rows) - 1))
        sess = rows[sel][1]
        if ch == curses.KEY_UP:
            sel = max(0, sel - 1)
        elif ch == curses.KEY_DOWN:
            sel = min(len(rows) - 1, sel + 1)
        elif ch in (ord("+"), ord("=")):
            sess.gain *= 10 ** (1 / 20)
        elif ch == ord("-"):
            sess.gain /= 10 ** (1 / 20)
        elif ch == ord("l"):
            sess.pan = max(-1.0, sess.pan - 0.1)
        elif ch == ord("r"):
            sess.pan = min(1.0, sess.pan + 0.1)
        elif ch == ord("m"):
            sess.muted = not sess.muted


def _attach_tui(mixer, stop, tty_path="/dev/tty"):
    """Start the mixer UI on the CONTROLLING TERMINAL, not on stdout.

    The documented usage pipes stdout to a file/player, and ncurses writes
    its escape sequences to fd 1 -- naively starting curses would
    interleave terminal control codes into the s16 stream (the reference
    never has this problem: its audio goes to portaudio, monitor.c:360-386,
    and only the UI owns the screen, monitor.c:530-733).  So: keep the
    pipe on a duplicated fd for the PCM writer and re-point fd 1 (and a
    non-tty fd 0) at the terminal for curses.

    Returns the binary PCM stream to write to, or None if there is no
    terminal (UI skipped, PCM untouched)."""
    import curses
    import os
    import threading

    try:
        tty = os.open(tty_path, os.O_RDWR)
    except OSError as e:
        print(f"monitor: --tui needs a terminal ({e}); running without UI",
              file=sys.stderr)
        return None
    pcm_fd = os.dup(1)                  # the pipe/file the user redirected
    os.dup2(tty, 1)                     # curses owns fd 1 = the terminal
    if not os.isatty(0):
        os.dup2(tty, 0)                 # keys come from the terminal too
    os.close(tty)
    pcm_out = os.fdopen(pcm_fd, "wb")

    def run():
        try:
            curses.wrapper(run_mixer_ui, mixer, stop)
        except curses.error as e:
            print(f"monitor: TUI unavailable ({e})", file=sys.stderr)

    threading.Thread(target=run, daemon=True).start()
    return pcm_out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="monitor")
    p.add_argument("groups", nargs="*", help="PCM/Opus multicast name:port")
    p.add_argument("-I", dest="groups_opt", action="append", default=[],
                   help="add a multicast group (monitor.c -I; may repeat)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="at exit, print frames written, sessions, late "
                        "packets and clipped samples to stderr")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="accepted for reference compatibility (no UI is "
                        "already the default; --tui opts in)")
    p.add_argument("-L", "--list-audio", action="store_true",
                   help="list audio devices (monitor.c -L); this target "
                        "has no audio device — the sink is stdout")
    p.add_argument("-R", dest="audiodev", default=None,
                   help="audio output device (monitor.c -R); n/a here — "
                        "accepted for drop-in compatibility, sink is stdout")
    p.add_argument("-u", "--update-interval", type=int, default=0,
                   help="UI update interval (monitor.c -u); accepted for "
                        "drop-in compatibility")
    p.add_argument("--seconds", type=float, default=0.0, help="stop after N s")
    p.add_argument("--chunk-ms", type=float, default=20.0)
    p.add_argument("--tui", action="store_true",
                   help="interactive session mixer (gain/pan/mute) on "
                        "/dev/tty; the PCM stream keeps stdout")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if audio_device_notice("monitor", args.list_audio, args.audiodev,
                           "output", "the mixed 48 kHz stereo s16 stream "
                           "goes to stdout (pipe to aplay or a file)"):
        return 0
    groups = list(args.groups) + list(args.groups_opt)
    if not groups:
        p.error("need at least one multicast group (positional or -I)")

    socks = [setup_mcast(g, output=False) for g in groups]
    mixer = Mixer()
    stop = {"quit": False}
    out = None
    if args.tui:
        out = _attach_tui(mixer, stop)
    if out is None:
        out = sys.stdout.buffer
    chunk = int(SAMPRATE * args.chunk_ms / 1000)
    clipped = 0
    t0 = time.monotonic()
    next_due = t0
    try:
        while True:
            now = time.monotonic()
            timeout = max(0.0, next_due - now)
            ready, _, _ = select.select(socks, [], [], timeout)
            for s in ready:
                mixer.feed_packet(s.recv(9000))
            now = time.monotonic()
            if now >= next_due:
                audio = mixer.read(chunk) * 32767.0
                if args.verbose:
                    clipped += int(np.count_nonzero(
                        (audio > 32767) | (audio < -32768)))
                pcm = np.clip(audio, -32768, 32767).astype(np.int16)
                out.write(pcm.tobytes())
                out.flush()
                next_due += args.chunk_ms / 1000.0
            if args.seconds and now - t0 >= args.seconds:
                return 0
            if stop["quit"]:
                return 0
    except (KeyboardInterrupt, BrokenPipeError):
        return 0
    finally:
        if args.verbose:
            print(f"monitor: {mixer.frames_out} frames, "
                  f"{len(mixer.sessions)} sessions, "
                  f"{sum(s.lates for s in mixer.sessions.values())} lates, "
                  f"{clipped} clipped samples", file=sys.stderr, flush=True)


if __name__ == "__main__":
    sys.exit(main())
