"""Real-time Doppler steering (doppler.c).

Spawns a user-supplied ephemeris command whose stdout carries lines of
``t az azrate el elrate range rangerate rangeraterate`` (doppler.c:46-48),
sleeps until each timestamp, and programs the receiver's sweep NCO:
f = -f0 * rangerate/c, rate = -f0 * rangeraterate/c (doppler.c:63-66).
The open-loop accuracy target is the reference's 70 cm LEO CW case — a
400 Hz filter held AOS->LOS (BASELINE.md).
"""

from __future__ import annotations

import subprocess
import threading
import time

__all__ = ["DopplerSteerer", "SPEED_OF_LIGHT", "parse_ephemeris_line"]

SPEED_OF_LIGHT = 299792458.0


def parse_ephemeris_line(line: str):
    """Parse one ephemeris line; returns the 8-tuple or None."""
    parts = line.split()
    if len(parts) < 8:
        return None
    try:
        return tuple(float(p) for p in parts[:8])
    except ValueError:
        return None


class DopplerSteerer:
    """Runs the ephemeris command in a thread and steers a Receiver.

    `receiver` needs .set_doppler(freq_hz, rate_hz_s) and .tune_freq —
    the interface both Receiver and (per-channel) ChannelBank adapters
    provide."""

    def __init__(self, receiver, command: str, clock=time.time, sleep=None):
        self.receiver = receiver
        self.command = command
        self.clock = clock
        # default sleep is interruptible: stop() wakes it immediately
        # instead of letting the thread doze toward an ephemeris point
        # hours ahead and apply one more steer after waking
        self._stop = threading.Event()
        self.sleep = sleep if sleep is not None else self._stop.wait
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def steer_from_lines(self, lines) -> int:
        """Apply ephemeris lines (the inner loop of doppler.c:46-67).
        Returns the number of steering updates applied."""
        applied = 0
        for line in lines:
            if self._stop.is_set():
                break
            rec = parse_ephemeris_line(line)
            if rec is None:
                continue
            t, az, azrate, el, elrate, rng, rangerate, rrate = rec
            now = self.clock()
            if t < now:
                continue   # stale entry (doppler.c:55-58)
            if t > now:
                self.sleep(t - now)
                if self._stop.is_set():
                    break    # woken by stop(): don't apply one more steer
            f0 = self.receiver.tune_freq
            self.receiver.set_doppler(
                f0 * -rangerate / SPEED_OF_LIGHT,
                f0 * -rrate / SPEED_OF_LIGHT,
            )
            applied += 1
        return applied

    def _run(self) -> None:
        self.receiver.set_doppler(0.0, 0.0)
        while not self._stop.is_set():
            try:
                proc = subprocess.Popen(
                    self.command, shell=True, stdout=subprocess.PIPE, text=True
                )
            except OSError:
                self.sleep(1.0)
                continue
            try:
                self.steer_from_lines(proc.stdout)
            finally:
                proc.terminate()
                try:
                    proc.wait(timeout=5.0)   # reap: no zombie children
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
            self.receiver.set_doppler(0.0, 0.0)  # reset between passes
            self.sleep(1.0)
