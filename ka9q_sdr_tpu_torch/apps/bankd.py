"""bankd — the wideband multichannel receiver daemon, on one CUDA card.

Port of ``ka9q_sdr_tpu.apps.bankd``, with its CLI, TLV command plane, status
stream and RTP output.  The reference runs one `radio` process per channel;
bankd runs thousands of channels as one bank on one card (models.bank): a
shared wideband forward FFT, frequency-domain downconversion per channel,
batched IFFT + demod.  Every channel's 48 kHz PCM goes out on the same
multicast group with SSRC = channel index + 1, which the reference's own
session demuxers (monitor, opus) and the JAX package's tools understand.

Channels come from a channel file: one ``frequency [mode [low high]]`` per
line (frequencies in parse_frequency syntax; optional per-line filter edges
in Hz give that line its own response -- distinct (mode, low, high)
combinations become separate demod groups, reproducing the reference's
per-receiver filter granularity), or --channels N spread evenly.

Usage:
  python -m ka9q_sdr_tpu_torch.apps.bankd --iq-file wide.iq -r 24576000 \\
      --channels 256 -m FM -R 239.3.1.1:5004

What differs from the JAX daemon:

- The bank runs on the CUDA card unless --cpu; without a card the daemon
  exits with a message (utils.runtime.configure_torch).
- A block's outputs reach the host through one HostCopy: non_blocking
  copies into pinned memory behind one event, which the emit path waits on.
- --mesh D takes the first D CUDA cards (fewer where the machine has
  fewer, as the JAX daemon takes ``jax.devices()[:D]``; with --cpu, D CPU
  shards) and prints the mesh it got; one process drives them all
  (parallel.mesh).  Each shard replays its captured step: on 4 H100s a
  4096-channel FM block took 2.21 ms against 3.36 on one card, while
  --shard-fft (whose step stays eager) was slower than the replicated FFT
  on every geometry measured (PERF.md).
- --profile writes a torch.profiler trace.
- KA9Q_BANKD_TIMING=1 prints the loop's split per block on every input path
  (read, poll, step, copy, wait, emit, status), every 250 blocks and at the
  end of the run.
"""

from __future__ import annotations

import argparse
import os
import select
import sys
import time
from collections import deque

import numpy as np
import torch

from ..io.iqfile import IQReader
from ..io.pcm import PCMOutput, scaleclip_int16
from ..models.bank import ChannelBank, MultiBank, _complex_block, \
    make_bank_config
from ..net import status as st
from ..net.multicast import _parse_target, setup_mcast
from ..net.status import StatusCompactor, StatusType
from ..parallel.mesh import make_channel_mesh, pad_channels
from ..utils.misc import parse_frequency
from ..utils.runtime import HostCopy, configure_torch

__all__ = ["main", "BankDaemon", "MultiBankDaemon"]


def read_channel_file(path: str, default_mode: str = "FM"):
    """Channel file: one ``frequency [mode [low high]]`` per line.

    Optional per-line filter edges (Hz at the audio rate, the modes.txt
    convention) give that line's channels their own frequency response:
    every distinct (mode, low, high) becomes its own demod group, so the
    bank reproduces the reference's per-receiver filter granularity (each
    `radio` process owns its edges, main.c:113-128 + set_filter) down to
    single-channel groups.  Returns [(mode_or_ModeDef, [freqs...])] groups
    preserving first-seen order; custom-edge groups carry a ModeDef with
    the edges applied."""
    from dataclasses import replace as dc_replace

    from ..utils.modes import DEFAULT_MODES

    groups: dict[tuple, list[float]] = {}
    order: list[tuple] = []
    mdefs: dict[tuple, object] = {}
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) not in (1, 2, 4):
                raise ValueError(
                    f"{path}:{ln}: expected 'frequency [mode [low high]]', "
                    f"got {line!r}"
                )
            freq = parse_frequency(parts[0])
            mode = parts[1].upper() if len(parts) > 1 else default_mode.upper()
            key = (mode, None, None)
            mdef: object = mode
            if len(parts) == 4:
                try:
                    low, high = float(parts[2]), float(parts[3])
                except ValueError:
                    raise ValueError(
                        f"{path}:{ln}: filter edges must be numbers (Hz), "
                        f"got {parts[2]!r} {parts[3]!r}"
                    ) from None
                if not (np.isfinite(low) and np.isfinite(high)):
                    raise ValueError(
                        f"{path}:{ln}: non-finite filter edges"
                    )
                if high < low:          # modes.c:58 normalisation
                    low, high = high, low
                base = DEFAULT_MODES.get(mode)
                if base is None:
                    raise ValueError(
                        f"{path}:{ln}: unknown mode {mode!r} with custom "
                        f"edges (custom edges need a known base mode)"
                    )
                if (low, high) != (base.low, base.high):
                    key = (mode, low, high)
                    mdef = dc_replace(base, low=low, high=high)
                # explicit edges equal to the mode's defaults fold into
                # the default group (no duplicate response/demod batch)
            if key not in groups:
                groups[key] = []
                order.append(key)
                mdefs[key] = mdef
            groups[key].append(freq)
    return [(mdefs[k], groups[k]) for k in order]


def derive_geometry(samprate: float, block_ms: float = 20.0) -> tuple[int, int]:
    """Scale the reference channel geometry (M_dec = 1089-tap channel
    impulse, L_dec = 960 = 20 ms @48 kHz) up to the wideband rate
    (24.576 Msps -> N = 2^20).  block_ms trades latency for throughput:
    overlap-save redundancy is N/L = 1 + (M-1)/L, so longer blocks spend
    fewer FFT points per input sample.  N_dec stays a power of two (fast
    channel IFFTs): the achievable cadence closest to the request wins.
    Returns (L, M)."""
    decim = round(samprate / 48000)
    want = max(1, round(48000 * block_ms / 1000.0))
    n_hi = 1 << (want + 1089 - 2).bit_length()
    n_lo = max(2048, n_hi >> 1)
    l_hi, l_lo = n_hi - 1088, n_lo - 1088
    l_dec = l_lo if abs(l_lo - want) <= abs(l_hi - want) else l_hi
    return l_dec * decim, (1089 - 1) * decim + 1


def parse_command(data: bytes):
    """Parse one TLV command packet (cmd byte 1) into
    (ssrc, freq, filter_kwargs, doppler_kwargs, mode, rejected_reasons);
    None if not a command packet.  Shared by the single-mode and
    mixed-mode daemons (radio_status.c:217-318).  RADIO_MODE carries a
    preset/mode change request (radio.c:322-374 set_mode).

    Non-finite numerics are dropped at the door: a NaN/inf frequency
    would raise inside bank_tune and a NaN filter edge inside the window
    design -- a daemon must not be killable (or NaN-poisonable) by one
    crafted datagram.  Each drop is reported in `rejected_reasons` so the
    daemon can count + log it instead of letting the command counter imply
    acceptance."""
    if not data or data[0] != 1:
        return None
    ssrc = None
    freq = None
    filt: dict = {}
    dop: dict = {}
    mode = None
    bad: list[str] = []

    def _finite(x, what):
        if np.isfinite(x):
            return x
        bad.append(f"non-finite {what} {x!r}")
        return None

    def _put(d, key, x, what):
        # skip, don't insert None: a None doppler component would
        # TypeError inside bank_set_doppler's arithmetic, and a None filter
        # edge would silently reset that edge to the mode default
        if np.isfinite(x):
            d[key] = x
        else:
            bad.append(f"non-finite {what} {x!r}")

    for t, v in st.decode_packet(data[1:]):
        if t == StatusType.OUTPUT_SSRC:
            ssrc = int(st.decode_int(v))
        elif t == StatusType.RADIO_FREQUENCY:
            freq = _finite(st.decode_double(v), "frequency")
        elif t == StatusType.LOW_EDGE:
            _put(filt, "low", st.decode_float(v), "low edge")
        elif t == StatusType.HIGH_EDGE:
            _put(filt, "high", st.decode_float(v), "high edge")
        elif t == StatusType.KAISER_BETA:
            _put(filt, "kaiser_beta", st.decode_float(v), "kaiser beta")
        elif t == StatusType.DOPPLER_FREQUENCY:
            _put(dop, "doppler_hz", st.decode_double(v), "doppler")
        elif t == StatusType.DOPPLER_FREQUENCY_RATE:
            _put(dop, "rate_hz_s", st.decode_double(v), "doppler rate")
        elif t == StatusType.RADIO_MODE:
            try:
                mode = bytes(v).decode("ascii").strip().upper()
            except UnicodeDecodeError:
                bad.append(f"undecodable mode {v!r}")
    return ssrc, freq, filt, dop, mode, bad


def poll_commands(sock, handler) -> None:
    """Drain pending command packets (non-blocking) into handler."""
    if sock is None:
        return
    while True:
        ready, _, _ = select.select([sock], [], [], 0)
        if not ready:
            return
        try:
            handler(sock.recv(9000))
        except OSError:
            return


class Timing:
    """Host seconds per phase of the serving loop, summed over `n` blocks:
    read (the next block from the file or the engine), poll (commands),
    step (queuing the block on the device), copy (starting its host
    copies), wait (for the copies of the block being emitted), emit
    (packetising it and writing --pcm-raw), status."""

    KEYS = ("read", "poll", "step", "copy", "wait", "emit", "status")

    def __init__(self):
        self.t = dict.fromkeys(self.KEYS, 0.0)
        self.n = 0

    def add(self, key: str, t0: float) -> float:
        """Charge the time since t0 to `key`; returns now."""
        now = time.perf_counter()
        self.t[key] += now - t0
        return now

    def line(self) -> str:
        n = max(self.n, 1)
        total = sum(self.t.values())
        return ("bankd timing: " + "  ".join(
            f"{k} {1e3 * v / n:.3f}" for k, v in self.t.items())
            + f"  total {1e3 * total / n:.3f} ms/blk ({self.n} blocks)")

    def report(self) -> None:
        """Print the split and start a new interval."""
        print(self.line(), file=sys.stderr, flush=True)
        self.t = dict.fromkeys(self.KEYS, 0.0)
        self.n = 0


def _timing_on() -> bool:
    return bool(int(os.environ.get("KA9Q_BANKD_TIMING", "0")))


def _native_target(target: str) -> tuple[str, int]:
    """(host, port) for the native engine; link-local v6 gets its zone."""
    host, port, iface = _parse_target(target)
    if iface and ":" in host and "%" not in host:
        host = f"{host}%{iface}"
    return host, int(port)


def _fanout_unavailable(e: Exception) -> None:
    # never fall back silently: the C++ fan-out is the difference between
    # a Python loop over every channel and one call per block
    print(f"bankd: native PCM fan-out unavailable ({e!r}); "
          "falling back to the per-channel Python loop",
          file=sys.stderr, flush=True)


class _Daemon:
    """What the single-mode and mixed-mode daemons share: the PCM send
    path, the reject counter, command polling and the in-flight block."""

    def _sender(self):
        def send(datagram: bytes) -> None:
            if self.out_sock is not None:
                try:
                    self.out_sock.send(datagram)
                except OSError:
                    pass
        return send

    def _reject(self, reason: str) -> None:
        """Count + log a rejected command (COMMAND_REJECTS on status):
        the reference leaves the receiver visibly untouched; a headless
        daemon must not let the command counter imply acceptance."""
        self.rejects += 1
        print(f"bankd: rejected command: {reason}", file=sys.stderr)

    def poll_commands(self) -> None:
        """Drain pending command packets (non-blocking)."""
        poll_commands(self.cmd_sock, self.handle_command)

    def discard_pending(self) -> None:
        """Drop the in-flight block unemitted (warm-up path): the
        warm-up zeros must not become a bogus leading block in --pcm-raw
        or an RTP clock advance on the wire."""
        if self._pending is not None:
            self._pending.wait()
        self._pending = None

    def flush(self) -> None:
        if self._pending is not None:
            self._emit(self._pending)
            self._pending = None


class BankDaemon(_Daemon):
    """Single-mode daemon.  `mesh`: the channel mesh to run on, by default
    the one --mesh asks for."""

    def __init__(self, args, freqs, mesh=None):
        self.args = args
        self.device = configure_torch(getattr(args, "cpu", False), "bankd")
        samprate = float(args.samprate)
        if args.L:
            L, M = args.L, args.M
        else:
            L, M = derive_geometry(samprate, getattr(args, "block_ms", 20.0))
        # --mesh D: one logical bank spanning D devices (filter.c:22-35
        # fan-out).  The channel axis is padded to a device multiple;
        # padded channels demodulate but never emit.
        self.n_real = len(freqs)
        if mesh is None:
            mesh = _mesh(args)
        if mesh is not None:
            freqs = pad_channels(freqs, mesh.size)
            if len(freqs) != self.n_real:
                print(f"bankd: padded {self.n_real} channels to {len(freqs)} "
                      f"for the {mesh.size}-device mesh",
                      file=sys.stderr, flush=True)
        self.cfg = make_bank_config(
            len(freqs), args.mode, samprate=samprate, L=L, M=M
        )
        self.bank = ChannelBank(
            self.cfg, freqs, device=self.device if mesh is None else None,
            mesh=mesh,
            shard_fft=mesh is not None and getattr(args, "shard_fft", False))
        self.out_sock = None
        self.status_sock = None
        self.cmd_sock = None
        self.compactor = StatusCompactor()
        self.status_count = 0
        self.commands = 0
        self.rejects = 0
        # last commanded doppler (hz, rate) per channel: a TLV packet
        # carrying only ONE of the two doppler keys preserves the other
        # component instead of zeroing it
        self._dop: dict[int, tuple[float, float]] = {}
        if args.output:
            self.out_sock = setup_mcast(args.output, output=True, ttl=args.ttl)
            self.status_sock = setup_mcast(
                args.output, output=True, ttl=args.ttl, offset=2
            )
            # Command ingest on the same status group (radio.c:248-268,
            # radio_status.c:217-318): every channel of the bank is
            # remotely commandable, keyed by OUTPUT_SSRC.
            self.cmd_sock = setup_mcast(args.output, output=False, offset=2)
        self.pcm = [
            PCMOutput(send=self._sender(), ssrc=i + 1)
            for i in range(self.n_real)
        ]
        # Native fan-out: per-block C packetisation of the whole bank's
        # mono PCM (byte swap, silence suppression, markers)
        self.native_pcm = None
        if args.output and not getattr(args, "no_native", False):
            try:
                from ..native import PCMFanoutSender

                name, port = _native_target(args.output)
                self.native_pcm = PCMFanoutSender(
                    name, port, ttl=args.ttl,
                    ssrc_base=1, max_channels=self.n_real,
                )
            except Exception as e:
                _fanout_unavailable(e)
                self.native_pcm = None
        self.raw = open(args.pcm_raw, "wb") if args.pcm_raw else None
        self.blocks_done = 0
        self._ch_rr = 0
        self._pending = None
        self.timing = Timing()

    def process_block(self, iq: np.ndarray) -> None:
        """iq: (L,) complex, (L, 2) float packed, or (L, 2) int16.

        Double-buffered: block n+1 is queued on the device and its host
        copies started BEFORE block n is emitted, so the host's PCM
        packetisation overlaps the device compute."""
        t0 = time.perf_counter()
        if iq.ndim == 2 and iq.dtype == np.int16:
            audio, diag = self.bank.process_i16_pcm(iq)
        elif iq.ndim == 2:
            x = torch.as_tensor(iq, device=self.device)
            audio, diag = self.bank.process(_complex_block(x))
        else:
            audio, diag = self.bank.process(iq)
        t1 = self.timing.add("step", t0)
        copy = HostCopy([audio, diag.get("snr"), diag.get("bb_power")])
        self.timing.add("copy", t1)
        pending, self._pending = self._pending, copy
        if pending is not None:
            self._emit(pending)
        self.blocks_done += 1

    def _wait(self, copy: HostCopy):
        """The block's host arrays, and its status diag as numpy."""
        t0 = time.perf_counter()
        *outs, snr, bb = copy.wait()
        diag = {k: v for k, v in (("snr", snr), ("bb_power", bb))
                if v is not None}
        return outs, diag, self.timing.add("wait", t0)

    def _emit(self, copy: HostCopy) -> None:
        (a,), diag, t0 = self._wait(copy)
        a = a[: self.n_real]                # drop mesh-padding rows
        if a.dtype == np.int16:
            # device-side scaleclip already applied (process_i16_pcm)
            if self.native_pcm is not None and a.ndim == 2:
                self.native_pcm.send_block(a)
            else:
                for ch, out in enumerate(self.pcm):
                    out.send_mono_i16(a[ch])
            if self.raw is not None:
                self.raw.write(a.astype("<i2").tobytes())
        else:
            for ch, out in enumerate(self.pcm):
                if a.ndim == 3:
                    out.send_stereo(a[ch])
                else:
                    out.send_mono(a[ch])
            if self.raw is not None:
                self.raw.write(
                    np.clip(a * 32767, -32768, 32767).astype("<i2").tobytes()
                )
        self._last_diag = diag
        self.emit_channel_status()
        self.timing.add("emit", t0)

    def emit_active(self, copy: HostCopy, L_dec: int) -> None:
        """Emit the compacted active set of a process_active block (its
        HostCopy of pcm, idx, snr, bb_power); every other channel's RTP
        clock still advances (silence suppression, audio.c:102-113)."""
        (pcm, idx), diag, t0 = self._wait(copy)
        if self.native_pcm is not None:
            # one C call: active rows packetised, every channel's clock
            # advanced, silent rows suppressed
            self.native_pcm.send_block(pcm, idx.astype(np.int32))
        else:
            active = set()
            for row, ch in enumerate(idx):
                if 0 <= ch < self.n_real:
                    active.add(int(ch))
                    self.pcm[int(ch)].send_mono_i16(pcm[row])
            for ch, out in enumerate(self.pcm):
                if ch not in active:
                    out.advance(L_dec)
        if self.raw is not None:
            self.raw.write(pcm.astype("<i2").tobytes())
        self._last_diag = diag
        self.emit_channel_status()
        self.timing.add("emit", t0)

    def _channel_status_pkt(self, ch: int) -> bytes:
        """One channel's status packet, keyed by OUTPUT_SSRC (the
        per-receiver state of radio_status.c:33-212 at bank scale)."""
        diag = getattr(self, "_last_diag", {})
        pkt = bytearray([0])
        st.encode_int(pkt, StatusType.OUTPUT_SSRC, ch + 1)
        st.encode_int(pkt, StatusType.COMMANDS, self.commands)
        st.encode_int(pkt, StatusType.COMMAND_REJECTS, self.rejects)
        st.encode_double(pkt, StatusType.RADIO_FREQUENCY,
                         float(self.bank.freqs[ch]))
        st.encode_string(pkt, StatusType.RADIO_MODE, self.cfg.mode.name)
        st.encode_float(pkt, StatusType.LOW_EDGE, self.cfg.mode.low)
        st.encode_float(pkt, StatusType.HIGH_EDGE, self.cfg.mode.high)
        st.encode_int(pkt, StatusType.INPUT_SAMPRATE, int(self.cfg.samprate))
        st.encode_int(pkt, StatusType.OUTPUT_SAMPRATE, 48000)
        snr = diag.get("snr")
        if snr is not None:
            v = float(snr[ch])
            if np.isfinite(v):
                st.encode_float(pkt, StatusType.DEMOD_SNR, v)
        bb = diag.get("bb_power")
        if bb is not None:
            st.encode_float(pkt, StatusType.BASEBAND_POWER, float(bb[ch]))
        st.encode_eol(pkt)
        return bytes(pkt)

    def emit_channel_status(self) -> None:
        """Per-channel observability (radio_status.c per-receiver state):
        round-robin a few channels per block, keyed by OUTPUT_SSRC so a
        `control` instance can watch any one channel."""
        if self.status_sock is None or not hasattr(self, "_last_diag"):
            return
        nch = self.n_real
        start = self._ch_rr
        for i in range(min(4, nch)):
            ch = (start + i) % nch
            try:
                self.status_sock.send(self._channel_status_pkt(ch))
            except OSError:
                pass
        self._ch_rr = (start + min(4, nch)) % nch

    # ---- command plane ----

    def handle_command(self, data: bytes) -> None:
        """TLV command ingest (radio_status.c:217-318 command loop).

        OUTPUT_SSRC addresses one channel of the bank (SSRC = index + 1):
        RADIO_FREQUENCY retunes that channel phase-continuously
        (ChannelBank.tune -- the radio.c:204-242 set_freq at bank scale).
        Filter-edge / Kaiser-beta keys swap the bank's SHARED response (all
        channels of a group share one response, filter.c:22-35).  Each
        addressed command is answered with that channel's status, as the
        reference answers every command poll."""
        parsed = parse_command(data)
        if parsed is None:
            return
        self.commands += 1
        ssrc, freq, filt, dop, mode, bad = parsed
        ch = None
        if ssrc is not None and 1 <= ssrc <= self.n_real:
            ch = ssrc - 1
        # A command addressed to an out-of-range SSRC is someone else's
        # (two daemons sharing a command channel): drop it whole --
        # including its malformed-value rejects and mode mismatch -- or
        # this daemon's reject counter ticks for the other's traffic.
        mine = ssrc is None or ch is not None
        if not mine:
            return
        for reason in bad:
            self._reject(reason)
        if mode is not None and mode != self.cfg.mode.name:
            # a single-mode bank cannot respawn a different demod (the
            # mixed-mode daemon's migrate() can); reject loudly
            self._reject(
                f"ssrc {ssrc} mode {mode!r}: single-mode "
                f"{self.cfg.mode.name} bank (use a channel file with a "
                f"{mode} group and the mixed-mode daemon)"
            )
        if freq is not None and ch is None:
            self._reject(f"frequency {freq!r} without OUTPUT_SSRC")
        if dop and ch is None:
            self._reject(f"doppler {dop!r} without OUTPUT_SSRC")
        if freq is not None and ch is not None:
            try:
                self.bank.tune(ch, freq)
            except (ValueError, OverflowError):
                self._reject(f"ssrc {ssrc} frequency {freq!r}")
        if dop and ch is not None:
            # per-channel Doppler steer over the wire (the radio -d
            # equivalent, doppler.c:63-66 values as TLV keys 20/21); a
            # packet carrying only one of the two keys preserves the
            # channel's other commanded component (see self._dop)
            cur = self._dop.get(ch, (0.0, 0.0))
            hz = dop.get("doppler_hz", cur[0])
            rate = dop.get("rate_hz_s", cur[1])
            try:
                self.bank.set_doppler(ch, hz, rate)
            except (ValueError, OverflowError):
                self._reject(f"ssrc {ssrc} doppler {dop!r}")
            else:
                self._dop[ch] = (hz, rate)
        # Filter edits apply bank-wide (the response is SHARED,
        # filter.c:22-35) when unaddressed or validly addressed
        if filt and (ssrc is None or ch is not None):
            try:
                self.bank.set_filter(**filt)
            except ValueError:
                self._reject(f"filter edges {filt!r}")
            else:
                self.cfg = self.bank.cfg   # status reports the new edges
        if ch is not None and self.status_sock is not None:
            try:
                self.status_sock.send(self._channel_status_pkt(ch))
            except OSError:
                pass

    def emit_status(self) -> None:
        if self.status_sock is None:
            return
        pkt = bytearray([0])
        st.encode_int(pkt, StatusType.GPS_TIME, int(time.time_ns()))
        st.encode_int(pkt, StatusType.INPUT_SAMPRATE, int(self.cfg.samprate))
        st.encode_int(pkt, StatusType.OUTPUT_SAMPRATE, 48000)
        st.encode_int(pkt, StatusType.OUTPUT_CHANNELS, self.n_real)
        st.encode_int(pkt, StatusType.FILTER_BLOCKSIZE, self.cfg.master.L)
        st.encode_int(pkt, StatusType.FILTER_FIR_LENGTH, self.cfg.master.M)
        st.encode_string(pkt, StatusType.RADIO_MODE, self.cfg.mode.name)
        st.encode_eol(pkt)
        self.status_count += 1
        try:
            self.status_sock.send(
                self.compactor.compact(bytes(pkt),
                                       force=self.status_count % 10 == 1)
            )
        except OSError:
            pass

    def close(self) -> None:
        self.flush()
        if self.native_pcm is not None:
            self.native_pcm.close()
        if self.raw:
            self.raw.close()


class MultiBankDaemon(_Daemon):
    """Mixed-mode daemon: one shared wideband FFT, a demod group per mode
    (models.bank.MultiBank), with the SAME TLV command plane as the
    single-mode BankDaemon -- every channel of every group is remotely
    retunable by OUTPUT_SSRC, and filter-edge commands hot-swap the
    ADDRESSED CHANNEL'S GROUP response (each group is its own slave-filter
    family, filter.c:22-35).  `mesh` as BankDaemon's."""

    def __init__(self, args, groups, mesh=None):
        self.device = configure_torch(getattr(args, "cpu", False), "bankd")
        samprate = float(args.samprate)
        if args.L:
            L, M = args.L, args.M
        else:
            L, M = derive_geometry(samprate, getattr(args, "block_ms", 20.0))
        if mesh is None:
            mesh = _mesh(args)
        self.mb = MultiBank(groups, samprate=samprate, L=L, M=M,
                            device=self.device if mesh is None else None,
                            mesh=mesh)
        # SSRC numbering: sequential over REAL channels in group order;
        # ssrc_map[ssrc] = (group, idx)
        self.ssrc_map = {}
        ssrc = 1
        self.out_sock = self.status_sock = self.cmd_sock = None
        if args.output:
            self.out_sock = setup_mcast(args.output, output=True,
                                        ttl=args.ttl)
            self.status_sock = setup_mcast(args.output, output=True,
                                           ttl=args.ttl, offset=2)
            self.cmd_sock = setup_mcast(args.output, output=False, offset=2)
        # Slot model for live mode migration (radio.c:322-374 set_mode as
        # a state edit): every group's LAST --spare-slots slots start
        # free; a migrating channel leaves its slot free behind it.
        # SSRC numbers are assigned per SLOT (so the native fan-out's
        # default base+slot mapping holds) but only occupied slots are
        # addressable; a migrated channel KEEPS its SSRC via the fan's
        # per-slot override (pcm_tx_set_ssrc).
        n_spare = int(getattr(args, "spare_slots", 0) or 0)
        self.pcms = []
        self.slot_ssrc: list[list[int | None]] = []
        for g, (mode, freqs) in enumerate(groups):
            row = []
            slot_row: list[int | None] = []
            for i in range(len(freqs)):
                if i < len(freqs) - n_spare:
                    self.ssrc_map[ssrc] = (g, i)
                    slot_row.append(ssrc)
                else:
                    slot_row.append(None)        # spare: free from birth
                row.append(PCMOutput(send=self._sender(), ssrc=ssrc))
                ssrc += 1
            self.pcms.append(row)
            self.slot_ssrc.append(slot_row)
        self.ch_ids = [
            np.array([i if s is not None else -1
                      for i, s in enumerate(slot_row)], np.int32)
            for slot_row in self.slot_ssrc
        ]
        # Native per-group PCM fan-out (mirrors BankDaemon): group SSRCs
        # are sequential, so each group gets one PCMFanoutSender with its
        # first SSRC as base.  The host quantises float audio in one
        # numpy op; the C engine does byteswap/packetisation/silence
        # suppression/markers.
        self.native_fan = [None] * len(self.pcms)
        if args.output and not getattr(args, "no_native", False):
            try:
                from ..native import PCMFanoutSender

                addr, port = _native_target(args.output)
                base = 1
                for g, (row, cfg) in enumerate(zip(self.pcms, self.mb.cfgs)):
                    # FM/AM demodulate to mono regardless of the mode
                    # table's channel default; LINEAR honours it
                    nch = (cfg.mode.channels
                           if cfg.mode.demod == "LINEAR" else 1)
                    self.native_fan[g] = PCMFanoutSender(
                        addr, port, ttl=args.ttl, ssrc_base=base,
                        max_channels=len(row), channels=nch,
                    )
                    base += len(row)
            except Exception as e:
                _fanout_unavailable(e)
                self.native_fan = [None] * len(self.pcms)
        # Re-commission each group's last spare slot at build time, as the
        # JAX daemon does to compile its splice graphs before serving.
        # Here nothing compiles; the edit keeps the two daemons' states
        # equal (set_doppler(0, 0) rewrites the slot's NCO words).
        if n_spare > 0:
            for g in range(len(self.pcms)):
                spare_idx = len(self.slot_ssrc[g]) - 1
                self.mb.init_channel(
                    g, spare_idx, self.mb.group_freqs[g][spare_idx]
                )
        self.raw = open(args.pcm_raw, "wb") if args.pcm_raw else None
        self.commands = 0
        self.rejects = 0
        self.blocks_done = 0
        self._last_diags = [None] * len(self.pcms)
        self._ssrcs = sorted(self.ssrc_map)   # fixed after build
        self._pending = None
        self._ch_rr = 0
        # last commanded doppler per SSRC (see BankDaemon._dop)
        self._dop: dict[int, tuple[float, float]] = {}
        self.timing = Timing()

    def handle_command(self, data: bytes) -> None:
        """TLV command ingest (radio_status.c:217-318) for the mixed-mode
        bank: OUTPUT_SSRC addresses one channel across all groups."""
        parsed = parse_command(data)
        if parsed is None:
            return
        self.commands += 1
        ssrc, freq, filt, dop, mode, bad = parsed
        gi = self.ssrc_map.get(ssrc) if ssrc is not None else None
        if ssrc is not None and gi is None:
            return                       # someone else's command: drop whole
        for reason in bad:               # malformed values, ours: count+log
            self._reject(reason)
        if gi is None:
            # per-channel keys with no OUTPUT_SSRC: nothing would apply --
            # reject loudly (filter swaps here are per-GROUP, so they need
            # an address too)
            if mode is not None:
                self._reject(f"mode {mode!r} without OUTPUT_SSRC")
            if freq is not None:
                self._reject(f"frequency {freq!r} without OUTPUT_SSRC")
            if dop:
                self._reject(f"doppler {dop!r} without OUTPUT_SSRC")
            if filt:
                self._reject(f"filter {filt!r} without OUTPUT_SSRC")
        if mode is not None and gi is not None:
            # live mode change (radio.c:322-374): move the channel into
            # the target mode's group; any frequency/doppler keys in the
            # same packet then apply at its new home
            if self.migrate(ssrc, mode):
                gi = self.ssrc_map[ssrc]
        if freq is not None and gi is not None:
            try:
                self.mb.tune(gi[0], gi[1], freq)
            except (ValueError, OverflowError):
                self._reject(f"ssrc {ssrc} frequency {freq!r}")
        if dop and gi is not None:
            # one-key packets preserve the other commanded component
            # (keyed by SSRC so the memory follows a migrated channel)
            cur = self._dop.get(ssrc, (0.0, 0.0))
            hz = dop.get("doppler_hz", cur[0])
            rate = dop.get("rate_hz_s", cur[1])
            try:
                self.mb.set_doppler(gi[0], gi[1], hz, rate)
            except (ValueError, OverflowError):
                self._reject(f"ssrc {ssrc} doppler {dop!r}")
            else:
                self._dop[ssrc] = (hz, rate)
        if filt and gi is not None:      # group response needs an address
            try:
                self.mb.set_filter(gi[0], **filt)
            except ValueError:
                self._reject(f"filter edges {filt!r}")
        if gi is not None and self.status_sock is not None:
            try:
                self.status_sock.send(self._channel_status_pkt(ssrc))
            except OSError:
                pass

    def migrate(self, ssrc: int, mode: str) -> bool:
        """Move one channel into the group of another mode on the RUNNING
        daemon -- the reference's set_mode-respawns-demod-thread
        (radio.c:322-374) as a state edit: the target group's free slot
        gets fresh demod state + the channel's frequency
        (MultiBank.init_channel), adopts the channel's wire SSRC
        (pcm_tx_set_ssrc), and the source slot is muted and freed.  The
        output RTP stream restarts (seq/timestamp reset, marker on the
        first packet) exactly like the reference's respawned thread.
        Returns True on success; failures are counted + logged."""
        gi = self.ssrc_map.get(ssrc)
        if gi is None:
            self._reject(f"migrate: unknown ssrc {ssrc}")
            return False
        g, i = gi
        if self.mb.cfgs[g].mode.name == mode:
            return True        # same-preset set_mode is a no-op
        tg = next((k for k, c in enumerate(self.mb.cfgs)
                   if c.mode.name == mode), None)
        if tg is None:
            self._reject(f"migrate ssrc {ssrc}: no {mode} group in this "
                         f"bank (groups: "
                         f"{[c.mode.name for c in self.mb.cfgs]})")
            return False
        slot_row = self.slot_ssrc[tg]
        try:
            j = slot_row.index(None)
        except ValueError:
            self._reject(f"migrate ssrc {ssrc}: {mode} group full "
                         f"({len(slot_row)} slots; start with more "
                         f"--spare-slots)")
            return False
        # Emit the in-flight block BEFORE rebooking: it was computed with
        # the OLD slot map, and the double-buffered _pending would
        # otherwise go out with the NEW one -- transmitting the parked
        # spare's AGC-amplified floor as the migrated SSRC's first
        # (marker) packets and dropping the source channel's last block.
        self.flush()
        freq = self.mb.group_freqs[g][i]
        self.mb.init_channel(tg, j, freq)   # fresh demod row + retune
        # rebook: free + mute the source slot, bind the wire SSRC at the
        # target (the channel's SSRC follows it, like the reference's
        # persistent session across set_mode)
        self.slot_ssrc[g][i] = None
        self.slot_ssrc[tg][j] = ssrc
        self.ssrc_map[ssrc] = (tg, j)
        # init_channel cleared the device-side sweep (set_doppler(0,0));
        # drop the command memory too, or a later single-key doppler
        # command would merge with the stale pre-migration component
        self._dop.pop(ssrc, None)
        self.ch_ids[g][i] = -1
        self.ch_ids[tg][j] = j
        if self.native_fan[g] is not None:
            self.native_fan[g].set_ssrc(i, 0)      # back to default map
        if self.native_fan[tg] is not None:
            self.native_fan[tg].set_ssrc(j, ssrc)
        # Python-fallback output: a fresh RTP session for the slot
        self.pcms[tg][j] = PCMOutput(send=self._sender(), ssrc=ssrc)
        print(f"bankd: migrated ssrc {ssrc} "
              f"{self.mb.cfgs[g].mode.name}->{mode} "
              f"(group {g} slot {i} -> group {tg} slot {j})",
              file=sys.stderr, flush=True)
        return True

    def _channel_status_pkt(self, ssrc: int) -> bytes:
        g, i = self.ssrc_map[ssrc]
        cfg = self.mb.cfgs[g]
        pkt = bytearray([0])
        st.encode_int(pkt, StatusType.OUTPUT_SSRC, ssrc)
        st.encode_int(pkt, StatusType.COMMANDS, self.commands)
        st.encode_int(pkt, StatusType.COMMAND_REJECTS, self.rejects)
        st.encode_double(pkt, StatusType.RADIO_FREQUENCY,
                         float(self.mb.group_freqs[g][i]))
        st.encode_string(pkt, StatusType.RADIO_MODE, cfg.mode.name)
        st.encode_float(pkt, StatusType.LOW_EDGE, cfg.mode.low)
        st.encode_float(pkt, StatusType.HIGH_EDGE, cfg.mode.high)
        st.encode_int(pkt, StatusType.INPUT_SAMPRATE, int(cfg.samprate))
        st.encode_int(pkt, StatusType.OUTPUT_SAMPRATE, 48000)
        diag = self._last_diags[g]
        if diag is not None:
            snr = diag.get("snr")
            if snr is not None:
                v = float(snr[i])
                if np.isfinite(v):
                    st.encode_float(pkt, StatusType.DEMOD_SNR, v)
            bb = diag.get("bb_power")
            if bb is not None:
                st.encode_float(pkt, StatusType.BASEBAND_POWER, float(bb[i]))
        st.encode_eol(pkt)
        return bytes(pkt)

    def emit_status(self) -> None:
        """Bank-level status (radio_status.c send_radio_status shape):
        one packet for the whole mixed-mode bank; per-channel detail
        rides the round-robin channel packets (emit_channel_status)."""
        if self.status_sock is None:
            return
        cfg0 = self.mb.cfgs[0]
        pkt = bytearray([0])
        st.encode_int(pkt, StatusType.GPS_TIME, int(time.time_ns()))
        st.encode_int(pkt, StatusType.INPUT_SAMPRATE, int(cfg0.samprate))
        st.encode_int(pkt, StatusType.OUTPUT_SAMPRATE, 48000)
        st.encode_int(pkt, StatusType.OUTPUT_CHANNELS, len(self.ssrc_map))
        st.encode_int(pkt, StatusType.FILTER_BLOCKSIZE, cfg0.master.L)
        st.encode_int(pkt, StatusType.FILTER_FIR_LENGTH, cfg0.master.M)
        st.encode_eol(pkt)
        try:
            self.status_sock.send(bytes(pkt))
        except OSError:
            pass

    def emit_channel_status(self) -> None:
        """Round-robin per-channel status over all groups, keyed by
        OUTPUT_SSRC -- same observability as the single-mode daemon."""
        if self.status_sock is None or not self._ssrcs:
            return
        ssrcs = self._ssrcs
        start = self._ch_rr
        n = min(4, len(ssrcs))
        for i in range(n):
            ssrc = ssrcs[(start + i) % len(ssrcs)]
            try:
                self.status_sock.send(self._channel_status_pkt(ssrc))
            except OSError:
                pass
        self._ch_rr = (start + n) % len(ssrcs)

    def process_block(self, block) -> None:
        """Double-buffered like BankDaemon.process_block: block n+1 is
        queued and its host copies started before block n is emitted, so
        host packetisation overlaps device compute.  One HostCopy holds
        every group's audio and status diag."""
        t0 = time.perf_counter()
        outs = self.mb.process(block)
        t1 = self.timing.add("step", t0)
        copy = HostCopy([t for audio, diag in outs
                         for t in (audio, diag.get("snr"),
                                   diag.get("bb_power"))])
        self.timing.add("copy", t1)
        pending, self._pending = self._pending, copy
        if pending is not None:
            self._emit(pending)
        self.blocks_done += 1

    def _emit(self, copy: HostCopy) -> None:
        t0 = time.perf_counter()
        flat = copy.wait()
        t0 = self.timing.add("wait", t0)
        for g, row in enumerate(self.pcms):
            a, snr, bb = flat[3 * g: 3 * g + 3]
            a = a[: len(row)]                # drop mesh-padding rows
            fan = self.native_fan[g]
            if fan is not None:
                pcm = scaleclip_int16(a)
                # (B, L_dec[, 2]) -> (B, L_dec*nch) interleaved frames;
                # ch_ids mutes free slots (-1: spares and migrated-away)
                fan.send_block(pcm.reshape(pcm.shape[0], -1),
                               self.ch_ids[g])
            else:
                for ch, out in enumerate(row):
                    if self.slot_ssrc[g][ch] is None:
                        continue            # free slot: muted
                    if a.ndim == 3:
                        out.send_stereo(a[ch])
                    else:
                        out.send_mono(a[ch])
            if self.raw is not None:
                self.raw.write(np.clip(a * 32767, -32768, 32767)
                               .astype("<i2").tobytes())
            self._last_diags[g] = {k: v for k, v in (("snr", snr),
                                                     ("bb_power", bb))
                                   if v is not None}
        self.emit_channel_status()
        self.timing.add("emit", t0)

    def close(self) -> None:
        self.flush()
        for fan in self.native_fan:
            if fan is not None:
                fan.close()
        if self.raw:
            self.raw.close()


def _serve(d, args, next_block, step, timing: bool) -> None:
    """The serving loop shared by every input path: read a block, poll
    commands, step it, emit status at 10 Hz, report the split every 250
    blocks when `timing`; stop after --blocks or at the end of the input.
    next_block() returns a block, None on a timeout (commands and status
    are still served), or ``_END`` at the end of the input."""
    last_status = 0.0
    T = d.timing
    while True:
        t0 = time.perf_counter()
        block = next_block()
        if block is _END:
            return
        t0 = T.add("read", t0)
        d.poll_commands()
        t0 = T.add("poll", t0)
        if block is not None:
            step(block)
            T.n += 1
        t0 = time.perf_counter()
        now = time.monotonic()
        if now - last_status >= 0.1:
            d.emit_status()
            last_status = now
        T.add("status", t0)
        if timing and T.n >= 250:
            T.report()
        if args.blocks and d.blocks_done >= args.blocks:
            return


_END = object()


def _file_source(path: str, L: int):
    blocks = IQReader(path).blocks(L)
    return lambda: next(blocks, _END)


def _assembler_source(target: str, L: int):
    """-I --no-native: the Python transport.  Each call drains one
    datagram (or times out after 1 s, so commands are served while the
    stream stalls) and returns the next complete block or None."""
    from ..io.assembler import BlockAssembler

    sock = setup_mcast(target, output=False)
    sock.settimeout(1.0)
    asm = BlockAssembler(L)
    ready: deque = deque()

    def next_block():
        if not ready:
            try:
                asm.push(sock.recv(65536))
            except OSError:   # timeout: fall through to status emit
                return None
            ready.extend(asm.blocks())
        return ready.popleft() if ready else None
    return next_block


def _warm_up(d, block: np.ndarray, step=None) -> None:
    """One block of zeros, in the form the stream delivers them, before
    joining it: it builds the kernels the bank's modes launch (nvcc at
    first use), the FFT plans and, on a card, the captured graph of the
    step the stream replays (`step`, by default ``process_block``), so the
    first live packets are not dropped meanwhile.  Its output is
    discarded, not emitted."""
    (step or d.process_block)(block)
    d.discard_pending()
    d.blocks_done = 0
    d.timing = Timing()


def run_multibank(args, groups) -> int:
    """Mixed-mode path entry: one shared wideband FFT, a demod group per
    mode, full TLV command plane (MultiBankDaemon).  Input: --iq-file
    recording or -I wideband RTP -- via the native C++ engine (recvmmsg,
    resequencing, gap zero-fill; packed float blocks) when available, else
    the Python assembler path (--no-native forces it)."""
    n_spare = int(getattr(args, "spare_slots", 0) or 0)
    if n_spare:
        # spare slots park at DC until a migration commissions them
        # (init_channel respawns their demod state, so the parked
        # history never leaks into a migrated-in channel)
        groups = [(m, list(f) + [0.0] * n_spare) for m, f in groups]
    d = MultiBankDaemon(args, groups)
    L = d.mb.cfgs[0].master.L
    timing = _timing_on()
    if args.iq_file:
        _serve(d, args, _file_source(args.iq_file, L), d.process_block,
               timing)
    elif args.input:
        from .. import native

        if native.NATIVE_AVAILABLE and not args.no_native:
            # native engine: its packed (L, 2) float32 blocks go straight
            # into MultiBank.process
            _warm_up(d, np.zeros((L, 2), np.float32))
            rx = native.RTPReceiver(*_native_target(args.input), block_len=L)
            _serve(d, args, lambda: rx.get_block(1000), d.process_block,
                   timing)
            rx.close()
        else:
            _warm_up(d, np.zeros(L, np.complex64))
            _serve(d, args, _assembler_source(args.input, L),
                   d.process_block, timing)
    else:
        print("need --iq-file or -I", file=sys.stderr)
        return 1
    d.close()
    if timing and d.timing.n:
        d.timing.report()
    return 0


def _mesh(args):
    """The channel mesh of --mesh D (None without it), with the size it
    actually got printed: a machine with fewer cards gives fewer."""
    if not getattr(args, "mesh", 0):
        return None
    mesh = make_channel_mesh(args.mesh, cpu=getattr(args, "cpu", False))
    print(f"bankd: --mesh {args.mesh}: a {mesh.size}-device mesh "
          f"({', '.join(map(str, mesh.devices))})", file=sys.stderr,
          flush=True)
    return mesh


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bankd")
    p.add_argument("--iq-file", help="wideband recording to process")
    p.add_argument("-I", "--input", help="wideband I/Q multicast")
    p.add_argument("-R", "--output", help="PCM multicast for all channels")
    p.add_argument("--pcm-raw", help="write interleaved channel PCM to file")
    p.add_argument("-r", "--samprate", type=float, default=24.576e6)
    p.add_argument("-m", "--mode", default="FM")
    p.add_argument("--channels", type=int, default=0)
    p.add_argument("--channel-file",
                   help="file of 'frequency [mode [low high]]' lines; "
                        "per-line edges give that channel its own filter")
    p.add_argument("--L", type=int, default=0)
    p.add_argument("--M", type=int, default=0)
    p.add_argument("--block-ms", type=float, default=20.0,
                   help="block cadence; longer blocks = higher throughput "
                        "(overlap-save redundancy drops), 20 ms = the "
                        "reference's Opus-friendly default")
    p.add_argument("-T", "--ttl", type=int, default=1)
    p.add_argument("--blocks", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run the bank on the host CPU instead of the card")
    p.add_argument("--no-native", action="store_true",
                   help="use the Python transport instead of the C++ engine")
    p.add_argument("--spare-slots", type=int, default=0, metavar="N",
                   help="free slots per mixed-mode group for live mode "
                        "migration (RADIO_MODE command; radio.c:322-374)")
    p.add_argument("--max-active", type=int, default=0, metavar="N",
                   help="serve only the N loudest non-silent channels "
                        "(device-side squelch compaction; 0 = all)")
    p.add_argument("--mesh", type=int, default=0, metavar="D",
                   help="shard the channel axis over a D-device mesh "
                        "(one logical bank spanning devices; channels are "
                        "padded to a device multiple)")
    p.add_argument("--shard-fft", action="store_true",
                   help="with --mesh: distribute the wideband master FFT "
                        "itself (the >100 Msps sequence-scaling path); "
                        "no faster than the replicated FFT on any geometry "
                        "measured")
    p.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler trace of the run to DIR")
    return p


def _start_profile(path: str, device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    print("bankd: note: torch.profiler can drop a share of the device's "
          "events, more the older the process; time device work with CUDA "
          "events, not from this trace alone", file=sys.stderr, flush=True)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, path: str) -> None:
    prof.stop()
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"bankd-{os.getpid()}.trace.json")
    prof.export_chrome_trace(out)
    print(f"bankd: profile written to {out}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = configure_torch(args.cpu, "bankd")

    if args.channel_file:
        groups = read_channel_file(args.channel_file, args.mode)
        if not groups:
            print(f"bankd: no channels in {args.channel_file}",
                  file=sys.stderr)
            return 1
        if len(groups) > 1:
            return run_multibank(args, groups)
        args.mode = groups[0][0]
        freqs = groups[0][1]
    elif args.channels:
        usable = 0.9 * args.samprate
        freqs = list(
            np.linspace(-usable / 2, usable / 2, args.channels, endpoint=False)
        )
    else:
        print("need --channels or --channel-file", file=sys.stderr)
        return 1

    d = BankDaemon(args, freqs)
    prof = _start_profile(args.profile, device) if args.profile else None
    try:
        return _run_bank(d, args)
    finally:
        if prof is not None:
            _stop_profile(prof, args.profile)


def _run_bank(d: BankDaemon, args) -> int:
    L = d.cfg.master.L
    timing = _timing_on()
    if args.iq_file:
        _serve(d, args, _file_source(args.iq_file, L), d.process_block,
               timing)
    elif args.input:
        from .. import native

        if native.NATIVE_AVAILABLE and not args.no_native:
            # native engine: recvmmsg + resequencing, raw int16 onto the
            # card.  With --max-active, squelched channels never leave the
            # card and three blocks' host copies stay in flight.
            rx = native.RTPReceiver(*_native_target(args.input), block_len=L)
            if args.max_active:
                pending: deque = deque()
                L_dec = d.cfg.L_dec

                # mesh-padding rows never compete for a slot
                nv = d.n_real if d.n_real != d.cfg.n_channels else None

                def active(block):
                    return d.bank.process_active(block, args.max_active,
                                                 n_valid=nv)

                def step(block):
                    t0 = time.perf_counter()
                    pcm, idx, diag = active(block)
                    t0 = d.timing.add("step", t0)
                    # every leaf the emit path reads, status diag included
                    pending.append(HostCopy([pcm, idx, diag.get("snr"),
                                             diag.get("bb_power")]))
                    d.timing.add("copy", t0)
                    if len(pending) >= 3:
                        d.emit_active(pending.popleft(), L_dec)
                    d.blocks_done += 1
            else:
                active, step = None, d.process_block
            _warm_up(d, np.zeros((L, 2), np.int16), active)
            _serve(d, args, lambda: rx.get_block_i16(1000), step, timing)
            if args.max_active:
                while pending:
                    d.emit_active(pending.popleft(), L_dec)
            rx.close()
        else:
            _warm_up(d, np.zeros(L, np.complex64))
            _serve(d, args, _assembler_source(args.input, L),
                   d.process_block, timing)
    else:
        print("need --iq-file or -I", file=sys.stderr)
        return 1
    d.close()
    if timing and d.timing.n:
        d.timing.report()
    return 0


if __name__ == "__main__":
    sys.exit(main())
