"""The core receiver daemon -- `radio` (main.c / radio.c) on one CUDA card.

Port of ``ka9q_sdr_tpu.apps.radio``, with its CLI, TLV status and command
plane, RTCP and RTP output.  I/Q RTP multicast (or a recording) in; 48 kHz
PCM RTP multicast out; TLV status out at 10 Hz on the output port + 2 with
delta compression; TLV commands (retune, filter, mode, options) accepted on
the same socket; front-end TLV status ingested from the input port + 2 (LO1
changes retune LO2 to compensate).

Usage:
  python -m ka9q_sdr_tpu_torch.apps.radio -I 239.1.1.1:5004 \\
      -R 239.2.1.1:5004 -f 147m435 -m FM
  python -m ka9q_sdr_tpu_torch.apps.radio --iq-file rec.iq -f 10k -m AM \\
      --pcm-raw out.pcm --blocks 100

What differs from the JAX daemon: the receiver runs on the CUDA card unless
--cpu (without a card the daemon exits with a message); audio reaches the
host through HostCopy, six blocks in flight on the native path; the status
diag comes to the host as one stacked copy per fetch.
"""

from __future__ import annotations

import argparse
import select
import sys
import time
from collections import deque

import numpy as np
import torch

from ..io.assembler import BlockAssembler
from ..io.iqfile import IQReader
from ..io.pcm import PCMOutput
from ..models.receiver import Receiver, make_receiver_config
from ..net import status as st
from ..net.multicast import setup_mcast
from ..net.rtp import RTPHeader
from ..net.status import StatusCompactor, StatusType
from ..utils.misc import parse_frequency
from ..utils.runtime import HostCopy, configure_torch
from ..utils.state import RadioState, loadstate, savestate

__all__ = ["main", "RadioDaemon", "fetch_diag"]


def fetch_diag(diag: dict) -> dict:
    """The receiver's diag as numpy, in one device-to-host copy: every
    scalar stacked as float32 (flags become 0.0/1.0) with psd128 after
    them.  Float32 holds each scalar exactly, so the status encodes the
    values the device computed."""
    keys = [k for k in diag if k != "psd128"]
    parts = [torch.stack([diag[k].to(torch.float32).reshape(())
                          for k in keys])]
    if "psd128" in diag:
        parts.append(diag["psd128"].to(torch.float32).reshape(-1))
    (flat,) = HostCopy([torch.cat(parts)]).wait()
    out = {k: flat[i] for i, k in enumerate(keys)}
    if "psd128" in diag:
        out["psd128"] = flat[len(keys):]
    return out


class RadioDaemon:
    def __init__(self, args):
        self.args = args
        self.device = configure_torch(getattr(args, "cpu", False), "radio")
        from ..utils.misc import set_locale
        set_locale(getattr(args, "locale", None))   # main.c:150-153
        if getattr(args, "modes", None):
            from ..utils import modes as _modes

            _modes.DEFAULT_MODES.update(_modes.load_modes(args.modes))
        self.mode = args.mode.upper()
        self.rx = Receiver(
            make_receiver_config(
                self.mode,
                samprate=args.samprate,
                out_rate=48000,
                L=args.blocksize,
                M=args.impulse_len,
                kaiser_beta=args.kaiser_beta,
            ),
            device=self.device,
        )
        self.freq = parse_frequency(args.frequency) if args.frequency else 0.0
        self.commands = 0
        self.rejects = 0   # commands dropped as invalid; on the status
        #                    stream as COMMAND_REJECTS so an operator's
        #                    typo'd retune is visible, not swallowed
        # front-end analog gains, from TLV status (radio_status.c:292-307)
        self.fe_gains = {"lna": 0, "mixer": 0, "if": 0}
        self.compactor = StatusCompactor()
        self.status_count = 0

        # outputs
        self.pcm_raw = open(args.pcm_raw, "wb") if args.pcm_raw else None
        self.out_sock = None
        self.status_sock = None
        self.rtcp_sock = None
        if args.output:
            self.out_sock = setup_mcast(args.output, output=True, ttl=args.ttl)
            self.status_sock = setup_mcast(
                args.output, output=True, ttl=args.ttl, offset=2
            )
            self.status_recv = setup_mcast(args.output, output=False, offset=2)
            # RTCP on data port + 1 (main.c:442-513, audio.c:160)
            self.rtcp_sock = setup_mcast(
                args.output, output=True, ttl=args.ttl, offset=1
            )
        else:
            self.status_recv = None
        self._last_rtcp = 0.0
        # -S overrides the time-derived SSRC (main.c:193-195; default is
        # audio.c:150-153's wall-clock seed)
        ssrc = (int(args.ssrc) & 0xFFFFFFFF) if getattr(args, "ssrc", 0) \
            else int(time.time()) & 0xFFFFFFFF
        self.pcm = PCMOutput(send=self._send_pcm, ssrc=ssrc)

        self.ctl_sock = None
        if args.input and not args.iq_file:
            # command socket toward the front end (main.c:220)
            self.ctl_sock = setup_mcast(args.input, output=True, offset=2)
            self.fe_status_sock = setup_mcast(args.input, output=False, offset=2)
        else:
            self.fe_status_sock = None

        if self.freq:
            lo1 = self.rx.set_freq(self.freq)
            if lo1 is not None:
                self._send_lo1_command(lo1)
        if getattr(args, "shift", 0.0):
            # -s: post-detection shift offset at startup (main.c:175-177)
            self.rx.set_shift(float(args.shift))

        self.doppler = None
        if getattr(args, "doppler", None):
            from ..models.doppler import DopplerSteerer

            self.doppler = DopplerSteerer(self.rx, args.doppler)
            self.doppler.start()

    # ---- output paths ----

    def _send_pcm(self, datagram: bytes) -> None:
        if self.out_sock is not None:
            try:
                self.out_sock.send(datagram)
            except OSError:
                pass
        if self.pcm_raw is not None:
            try:
                hdr, off = RTPHeader.from_bytes(datagram)
            except ValueError:
                return                   # malformed datagram: drop
            self.pcm_raw.write(datagram[off:])

    def _send_lo1_command(self, lo1: float) -> None:
        """set_first_LO: TLV command to the front end (radio.c:259-266)."""
        if self.ctl_sock is None:
            return
        pkt = bytearray([1])  # command byte
        st.encode_double(pkt, StatusType.RADIO_FREQUENCY, lo1)
        st.encode_eol(pkt)
        try:
            self.ctl_sock.send(bytes(pkt))
        except OSError:
            pass

    def emit_rtcp(self) -> None:
        """SR + SDES once per second (rtcp_send, main.c:442-513)."""
        if self.rtcp_sock is None:
            return
        now = time.monotonic()
        if now - self._last_rtcp < 1.0:
            return
        self._last_rtcp = now
        from ..net.rtcp import (
            RTCPSenderReport, SDESItem, SDESType, gen_sr, gen_sdes, NTP_EPOCH,
        )
        import socket as _socket

        wall = time.time()
        ntp = (int(wall) + NTP_EPOCH) << 32 | int((wall % 1.0) * (1 << 32))
        sr = RTCPSenderReport(
            ssrc=self.pcm.ssrc,
            ntp_timestamp=ntp,
            rtp_timestamp=self.pcm.state.timestamp,
            packet_count=self.pcm.state.packets,
            byte_count=self.pcm.state.bytes,
        )
        cname = f"radio@{_socket.gethostname()}".encode()
        pkt = gen_sr(sr) + gen_sdes(
            self.pcm.ssrc, [SDESItem(SDESType.CNAME, cname)]
        )
        try:
            self.rtcp_sock.send(pkt)
        except OSError:
            pass

    # ---- status / command plane ----

    def emit_status(self, diag: dict) -> None:
        """10 Hz receiver status (radio_status.c:33-212), delta-coded with
        a full dump every 10th (radio_status.c:207-208).  `diag` holds
        numpy values (fetch_diag)."""
        if self.status_sock is None:
            return
        pkt = bytearray([0])  # status response byte
        st.encode_int(pkt, StatusType.GPS_TIME, int(time.time_ns()))
        st.encode_int(pkt, StatusType.COMMANDS, self.commands)
        st.encode_int(pkt, StatusType.COMMAND_REJECTS, self.rejects)
        st.encode_int(pkt, StatusType.INPUT_SAMPRATE, self.args.samprate)
        st.encode_int(pkt, StatusType.OUTPUT_SAMPRATE, 48000)
        st.encode_int(pkt, StatusType.OUTPUT_SSRC, self.pcm.ssrc)
        st.encode_int(pkt, StatusType.OUTPUT_PACKETS, self.pcm.state.packets)
        st.encode_double(pkt, StatusType.RADIO_FREQUENCY, self.rx.tune_freq)
        st.encode_double(pkt, StatusType.FIRST_LO_FREQUENCY, self.rx.sdr.frequency)
        st.encode_double(pkt, StatusType.SECOND_LO_FREQUENCY, self.rx.second_lo)
        st.encode_int(pkt, StatusType.FILTER_BLOCKSIZE, self.rx.cfg.master.L)
        st.encode_int(pkt, StatusType.FILTER_FIR_LENGTH, self.rx.cfg.master.M)
        st.encode_float(pkt, StatusType.KAISER_BETA, self.rx.cfg.kaiser_beta)
        st.encode_float(pkt, StatusType.LOW_EDGE, self.rx.cfg.mode.low)
        st.encode_float(pkt, StatusType.HIGH_EDGE, self.rx.cfg.mode.high)
        st.encode_string(pkt, StatusType.RADIO_MODE, self.mode)
        demod_num = {"LINEAR": 0, "AM": 1, "FM": 2}[self.rx.cfg.mode.demod]
        st.encode_int(pkt, StatusType.DEMOD_MODE, demod_num)
        st.encode_int(pkt, StatusType.OUTPUT_CHANNELS,
                      1 if self.rx.cfg.mode.demod != "LINEAR"
                      else self.rx.cfg.mode.channels)
        md = self.rx.cfg.mode
        st.encode_double(pkt, StatusType.SHIFT_FREQUENCY, md.shift)
        st.encode_int(pkt, StatusType.INDEPENDENT_SIDEBAND, int(md.isb))
        st.encode_int(pkt, StatusType.PLL_ENABLE, int(md.pll))
        st.encode_int(pkt, StatusType.PLL_SQUARE, int(md.square))
        st.encode_int(pkt, StatusType.FM_FLAT, int(md.flat))
        st.encode_float(pkt, StatusType.AGC_HEADROOM, self.rx.cfg.headroom_db)
        st.encode_float(pkt, StatusType.AGC_RECOVERY_RATE, md.recovery_rate)
        st.encode_float(pkt, StatusType.AGC_HANGTIME, md.hangtime)
        if "if_power" in diag:
            st.encode_float(pkt, StatusType.IF_POWER, float(diag["if_power"]))
        if "bb_power" in diag:
            st.encode_float(pkt, StatusType.BASEBAND_POWER, float(diag["bb_power"]))
        if "n0" in diag:
            st.encode_float(pkt, StatusType.NOISE_DENSITY, float(diag["n0"]))
        snr = diag.get("snr")
        if snr is not None and np.isfinite(float(snr)):
            st.encode_float(pkt, StatusType.DEMOD_SNR, float(snr))
        if "gain" in diag:
            st.encode_float(pkt, StatusType.DEMOD_GAIN, float(diag["gain"]))
        fo = diag.get("foffset")
        if fo is not None and np.isfinite(float(fo)):
            st.encode_float(pkt, StatusType.FREQ_OFFSET, float(fo))
        pd = diag.get("pdeviation")
        if pd is not None and np.isfinite(float(pd)):
            st.encode_float(pkt, StatusType.PEAK_DEVIATION, float(pd))
        pl = diag.get("plfreq")
        if pl is not None and np.isfinite(float(pl)):
            st.encode_float(pkt, StatusType.PL_TONE, float(pl))
        if "pll_lock" in diag:
            st.encode_int(pkt, StatusType.PLL_LOCK, int(bool(diag["pll_lock"])))
        psd = diag.get("psd128")
        if psd is not None:
            db = 10.0 * np.log10(np.maximum(np.asarray(psd), 1e-30))
            q = np.clip(db + 120.0, 0, 255).astype(np.uint8)
            st.encode_string(pkt, StatusType.SPECTRUM_128, q.tobytes())
        st.encode_eol(pkt)
        self.status_count += 1
        out = self.compactor.compact(
            bytes(pkt), force=(self.status_count % 10 == 1)
        )
        try:
            self.status_sock.send(out)
        except OSError:
            pass

    def _reject(self, reason: str) -> None:
        """Count + log a rejected command.  The reference leaves the
        receiver visibly untouched on a bad command; a headless network
        daemon additionally logs it and ticks COMMAND_REJECTS on the
        status stream so the operator sees WHY nothing changed."""
        self.rejects += 1
        print(f"radio: rejected command: {reason}", file=sys.stderr)

    def handle_command(self, data: bytes) -> None:
        """Command packet: leading byte 1 (radio_status.c:232-235).

        Every parameter the reference edits live in its in-process UI
        (display.c:128-180 adjust_item, 860-986 key dispatch) is
        commandable here over TLV: frequency, explicit LO2 (the IF item),
        filter edges, Kaiser beta, post-detection shift, mode, and the
        option flags (isb/pll/square/flat/channels) plus AGC parameters."""
        if not data or data[0] != 1:
            return
        self.commands += 1
        filt: dict = {}
        opts: dict = {}
        new_freq = None
        new_lo2 = None

        def _finite(x):
            # A crafted NaN/inf would raise inside the fixed-point NCO
            # retune; drop it at the door.
            if np.isfinite(x):
                return x
            self._reject(f"non-finite value {x!r}")
            return None

        for t, v in st.decode_packet(data[1:]):
            if t == StatusType.RADIO_FREQUENCY:
                new_freq = _finite(st.decode_double(v))
            elif t == StatusType.SECOND_LO_FREQUENCY:
                new_lo2 = _finite(st.decode_double(v))
            elif t == StatusType.RADIO_MODE:
                # runtime mode change (set_mode, radio.c:322-374)
                name = v.decode("ascii", "replace").strip().upper()
                try:
                    self.rx.set_mode(name)
                    self.mode = name
                except KeyError:
                    pass
            elif t == StatusType.LOW_EDGE:
                filt["low"] = st.decode_float(v)
            elif t == StatusType.HIGH_EDGE:
                filt["high"] = st.decode_float(v)
            elif t == StatusType.KAISER_BETA:
                filt["kaiser_beta"] = st.decode_float(v)
            elif t == StatusType.SHIFT_FREQUENCY:
                s_hz = _finite(st.decode_double(v))
                if s_hz is not None:
                    try:
                        self.rx.set_shift(s_hz)
                    except (ValueError, OverflowError):
                        self._reject(f"shift {s_hz!r}")
            elif t == StatusType.INDEPENDENT_SIDEBAND:
                opts["isb"] = bool(st.decode_int(v))
            elif t == StatusType.PLL_ENABLE:
                opts["pll"] = bool(st.decode_int(v))
            elif t == StatusType.PLL_SQUARE:
                opts["square"] = bool(st.decode_int(v))
            elif t == StatusType.FM_FLAT:
                opts["flat"] = bool(st.decode_int(v))
            elif t == StatusType.OUTPUT_CHANNELS:
                opts["channels"] = max(1, min(2, int(st.decode_int(v))))
            elif t == StatusType.AGC_HEADROOM:
                opts["headroom_db"] = st.decode_float(v)
            elif t == StatusType.AGC_RECOVERY_RATE:
                opts["recovery_rate"] = st.decode_float(v)
            elif t == StatusType.AGC_HANGTIME:
                opts["hangtime"] = st.decode_float(v)
            elif t == StatusType.FILTER_BLOCKSIZE:
                # 'b' key: L = value, M = L+1 (display.c:866-886)
                try:
                    bs = int(st.decode_int(v))
                    if not 0 < bs <= (1 << 26):
                        raise ValueError("blocksize out of range")
                    self.rx.set_blocksize(bs)
                except (ValueError, OverflowError, MemoryError):
                    pass  # incompatible/absurd geometry; keep running
            elif t == StatusType.SAVE_STATE:
                self.save_state()
        if new_freq is not None or new_lo2 is not None:
            # One set_freq per packet, exactly as display.c's adjust_item
            # issues it: RADIO_FREQUENCY alone lets the receiver pick LO2
            # (keep LO1 if it can); SECOND_LO_FREQUENCY alone keeps RF and
            # moves the IF ('i' recenter, display.c:912-914); both together
            # is the IF item -- vary RF and LO2 to keep LO1 the same
            # (display.c:152-159).
            f = self.rx.tune_freq if new_freq is None else new_freq
            try:
                lo1 = self.rx.set_freq(
                    f, np.nan if new_lo2 is None else new_lo2
                )
            except (ValueError, OverflowError):
                # rejected: leave self.freq at the ACTUAL tuned value --
                # status and the state file must not report/persist a
                # frequency the receiver never moved to
                self._reject(f"frequency {f!r}")
            else:
                self.freq = f
                if lo1 is not None:      # None = LO2 absorbed the retune
                    self._send_lo1_command(lo1)
        if filt:
            try:
                self.rx.set_filter(**filt)
            except ValueError:
                self._reject(f"filter edges {filt!r}")
        if opts:
            try:
                self.rx.set_options(**opts)
            except (ValueError, TypeError):
                self._reject(f"options {opts!r}")

    def save_state(self) -> None:
        """Write the ~/.radiostate file (savestate, main.c:368-401):
        on exit and on the SAVE_STATE command (the display 'w' key,
        display.c:795-805, delivered over TLV for a network daemon)."""
        savestate(
            RadioState(
                source=self.args.input or "",
                output=self.args.output or "",
                ttl=self.args.ttl,
                blocksize=self.rx.cfg.master.L,
                impulse_len=self.rx.cfg.master.M,
                frequency=self.freq,
                mode=self.mode,
                shift=self.rx.cfg.mode.shift,
                filter_low=self.rx.cfg.mode.low,
                filter_high=self.rx.cfg.mode.high,
                kaiser_beta=self.rx.cfg.kaiser_beta,
            ),
            self.args.state or "default",
        )

    def handle_fe_status(self, data: bytes) -> None:
        """Front-end TLV status (recv_sdr_status / decode_sdr_status,
        radio_status.c:217-318): LO1 moves retune LO2 to compensate;
        analog gain changes fold into gain_factor = 10^(-total/20)
        (radio_status.c:309-316) so the front-end AGC is transparent to
        the PCM output."""
        if not data or data[0] != 0:
            return
        gainchange = False
        for t, v in st.decode_packet(data[1:]):
            if t == StatusType.RADIO_FREQUENCY:
                self.rx.update_first_lo(st.decode_double(v))
            elif t == StatusType.INPUT_SAMPRATE:
                self.rx.sdr.samprate = int(st.decode_int(v))
            elif t == StatusType.LNA_GAIN:
                g = int(st.decode_int(v))
                gainchange |= g != self.fe_gains["lna"]
                self.fe_gains["lna"] = g
            elif t == StatusType.MIXER_GAIN:
                g = int(st.decode_int(v))
                gainchange |= g != self.fe_gains["mixer"]
                self.fe_gains["mixer"] = g
            elif t == StatusType.IF_GAIN:
                g = int(st.decode_int(v))
                gainchange |= g != self.fe_gains["if"]
                self.fe_gains["if"] = g
        if gainchange:
            total = sum(self.fe_gains.values())
            self.rx.set_gain_factor(10.0 ** (-0.05 * total))

    # ---- main loops ----

    def run_file(self) -> None:
        rd = IQReader(self.args.iq_file)
        n = 0
        last_status = 0.0
        for block in rd.blocks(self.args.blocksize):
            audio, diag = self.rx.process(block)
            self._emit_audio(HostCopy([audio]))
            n += 1
            now = time.monotonic()
            if now - last_status >= 0.1:
                self.emit_status(fetch_diag(diag))
                self.emit_rtcp()
                last_status = now
            if self.args.blocks and n >= self.args.blocks:
                break

    def run_network(self) -> None:
        # Build the kernels and FFT plans before joining the stream so the
        # first real block doesn't stall the socket reader.
        self.rx.process(np.zeros(self.args.blocksize, np.complex64))
        if self.args.verbose:
            print("radio: warmed up, joining", self.args.input,
                  file=sys.stderr, flush=True)
        use_native = not getattr(self.args, "no_native", False)
        if use_native:
            try:
                from ..native import RTPReceiver
                from ..net.multicast import _parse_target

                host, port, iface = _parse_target(self.args.input)
                if iface and ":" in host and "%" not in host:
                    host = f"{host}%{iface}"   # scope for link-local v6
                rx_native = RTPReceiver(
                    host, port, block_len=self.args.blocksize
                )
            except OSError:
                use_native = False
        if use_native:
            return self._run_native(rx_native)
        in_sock = setup_mcast(self.args.input, output=False)
        asm = BlockAssembler(self.args.blocksize)
        last_status = 0.0
        diag = {}
        socks = [in_sock]
        if self.status_recv is not None:
            socks.append(self.status_recv)
        if self.fe_status_sock is not None:
            socks.append(self.fe_status_sock)
        n = 0
        while True:
            ready, _, _ = select.select(socks, [], [], 0.1)
            for s in ready:
                data = s.recv(9000)
                if s is in_sock:
                    asm.push(data)
                elif s is self.fe_status_sock:
                    self.handle_fe_status(data)
                else:
                    self.handle_command(data)
            for block in asm.blocks():
                audio, diag = self.rx.process(block)
                self._emit_audio(HostCopy([audio]))
                n += 1
                if self.args.verbose and n % 10 == 1:
                    print(f"radio: block {n}, drops {asm.rtp_state.drops}, "
                          f"pcm pkts {self.pcm.state.packets}",
                          file=sys.stderr, flush=True)
            now = time.monotonic()
            if now - last_status >= 0.1:
                self.emit_status(fetch_diag(diag) if diag else {})
                self.emit_rtcp()
                last_status = now
            if self.args.blocks and n >= self.args.blocks:
                return

    def _run_native(self, rx_native) -> None:
        """Network loop on the C++ engine: dense float blocks from the
        native ring; control sockets polled between blocks.  Audio copies
        stay six blocks in flight, and the diag is fetched (one stacked
        copy) at 2 Hz while status goes out at 10 Hz."""
        socks = [s for s in (self.status_recv, self.fe_status_sock) if s]
        diag = {}
        diag_np = {}
        pending = deque()
        last_status = 0.0
        last_diag_fetch = 0.0
        n = 0
        while True:
            block = rx_native.get_block(200)
            if block is not None:
                iq = (block[:, 0] + 1j * block[:, 1]).astype(np.complex64)
                audio, diag = self.rx.process(iq)
                pending.append(HostCopy([audio]))
                if len(pending) >= 6:
                    self._emit_audio(pending.popleft())
                n += 1
            if socks:
                ready, _, _ = select.select(socks, [], [], 0)
                for s in ready:
                    data = s.recv(9000)
                    if s is self.fe_status_sock:
                        self.handle_fe_status(data)
                    else:
                        self.handle_command(data)
            now = time.monotonic()
            if now - last_status >= 0.1:
                if diag and now - last_diag_fetch >= 0.5:
                    diag_np = fetch_diag(diag)
                    last_diag_fetch = now
                self.emit_status(diag_np)
                self.emit_rtcp()
                last_status = now
            if self.args.blocks and n >= self.args.blocks:
                while pending:
                    self._emit_audio(pending.popleft())
                rx_native.close()
                return

    def _emit_audio(self, copy: HostCopy) -> None:
        (a,) = copy.wait()
        if a.ndim == 2:
            self.pcm.send_stereo(a)
        else:
            self.pcm.send_mono(a)

    def close(self):
        if self.doppler is not None:
            self.doppler.stop()
        if self.pcm_raw:
            self.pcm_raw.close()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="radio", description="ka9q radio receiver on one CUDA card"
    )
    p.add_argument("-I", "--input", help="input I/Q multicast (name:port)")
    p.add_argument("--iq-file", help="replay a recording instead of the network")
    p.add_argument("-R", "--output", help="output PCM multicast (name:port)")
    p.add_argument("--pcm-raw", help="also write raw big-endian s16 PCM to file")
    p.add_argument("-f", "--frequency", default="", help="e.g. 147m435")
    p.add_argument("-m", "--mode", default="FM")
    p.add_argument("-r", "--samprate", type=int, default=192000)
    p.add_argument("-L", "--blocksize", type=int, default=3840)
    p.add_argument("-M", "--impulse-len", type=int, default=4353)
    p.add_argument("-k", "--kaiser-beta", type=float, default=3.0)
    p.add_argument("-T", "--ttl", type=int, default=1)
    p.add_argument("-s", "--shift", type=float, default=0.0,
                   help="post-detection shift offset in Hz (main.c -s)")
    p.add_argument("-S", "--ssrc", type=int, default=0,
                   help="fixed output RTP SSRC (main.c -S; default: "
                        "wall-clock seed, audio.c:150-153)")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="accepted for reference-script compatibility "
                        "(no in-process display here)")
    p.add_argument("--blocks", type=int, default=0, help="stop after N blocks")
    p.add_argument("--state", help="load/save state file name")
    p.add_argument("--modes", help="modes.txt-format table to load "
                   "(readmodes, modes.c:32); default: built-in table")
    p.add_argument("-d", "--doppler",
                   help="ephemeris command for Doppler steering (doppler.c)")
    p.add_argument("--cpu", action="store_true",
                   help="run the DSP on the host CPU instead of the card")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-l", "--locale", default=None,
                   help="numeric output locale (main.c -l; best-effort)")
    p.add_argument("-t", "--fft-threads", type=int, default=0,
                   help="FFTW thread count in the reference (main.c:181); "
                        "accepted for drop-in compatibility -- cuFFT needs "
                        "none")
    p.add_argument("-u", "--update-interval", type=int, default=0,
                   help="display update interval (main.c -u; accepted for "
                        "drop-in compatibility)")
    p.add_argument("--no-native", action="store_true",
                   help="use the Python transport instead of the C++ engine")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    configure_torch(args.cpu, "radio")
    if args.state:
        try:
            rs = loadstate(args.state)
            if not args.frequency:
                args.frequency = f"{rs.frequency}"
            if args.mode == "FM" and rs.mode:
                args.mode = rs.mode
            args.input = args.input or rs.source
            args.output = args.output or rs.output
        except OSError:
            pass
    if not args.input and not args.iq_file:
        print("need -I or --iq-file", file=sys.stderr)
        return 1
    d = RadioDaemon(args)
    try:
        if args.iq_file:
            d.run_file()
        else:
            d.run_network()
    except KeyboardInterrupt:
        pass
    finally:
        if args.state:
            d.save_state()
        d.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
