"""frontend — front-end daemon / hardware simulator (funcube.c network
surface without the USB hardware).

Replays a recording (or synthesizes noise) as the A/D stream, applies the
reference's DC/gain/phase corrections, multicasts 16-bit I/Q RTP with the
legacy status header at the funcube cadence (240 samples / 1.25 ms,
funcube.c:72-75), answers TLV RADIO_FREQUENCY commands on data port + 2 —
quantising through the fractional-N model so the *actual* LO1 reported in
the 10 Hz status stream differs from the request exactly as real hardware
does (funcube.c:526-584) — and lets `radio`'s LO2 absorb the error
(radio_status.c:311-316).  Retunes shift the replayed spectrum so the
simulation stays physically consistent.

Usage:
  python -m ka9q_sdr_tpu_torch.apps.frontend -R 239.1.1.1:5004 -f 146m \\
      -r 192000 [--iq-file rec.iq] [--seconds 60]

The port's copy of ``ka9q_sdr_tpu.apps.frontend``: host numpy and sockets,
no device.
"""

from __future__ import annotations

import argparse
import select
import sys
import time

import numpy as np

from ..models.frontend import (
    FrontEndCorrector,
    FuncubeAGC,
    HackRFAGC,
    fcd_actual_frequency,
    hackrf_actual_frequency,
)
from ..net.multicast import setup_mcast
from ..net.rtp import RTPHeader, IQ_PT
from ..net.sdr_header import LegacyStatus
from ..net import status as st
from ..net.status import StatusType, StatusCompactor
from ..utils.misc import parse_frequency, UNIX_EPOCH_GPS, GPS_UTC_OFFSET

BLOCKSIZE = 240   # samples per packet (funcube.c:72)


class FrontEndDaemon:
    def __init__(self, args):
        self.args = args
        self.samprate = args.samprate
        self.requested = parse_frequency(args.frequency) if args.frequency else 146e6
        # hackrf-style wideband path: ADC rate = samprate * 2^decimate_log2,
        # +Fs/4 shift to dodge the DC spike, then the half-band cascade
        # (hackrf.c:270-318)
        self.decim_log2 = getattr(args, "decimate_log2", 0)
        self.adc_rate = self.samprate * (1 << self.decim_log2)
        # Synthesizer quantisation model: the MSi001 fractional-N for a
        # funcube (funcube.c:526-584) or the RFFC5071+MAX2837 pair for a
        # hackrf (hackrf.c:766-814,820-900).  auto follows the DSP shape.
        tuner = getattr(args, "tuner", "auto")
        if tuner == "auto":
            tuner = "hackrf" if self.decim_log2 else "msi001"
        self.tuner = tuner
        # TCXO calibration (funcube.c:51,131: ppm -> fraction; the
        # commanded RF is divided by (1+cal) before the synthesizer and
        # the quantised result multiplied back, funcube.c:751,799-808).
        self.calibration = getattr(args, "calibration", 0.0) * 1e-6
        self.cal_file = getattr(args, "cal_file", None)
        if self.cal_file:
            # funcube.c:238-252: load when no calibration given, else save
            import os

            if self.calibration == 0.0 and os.path.exists(self.cal_file):
                with open(self.cal_file) as f:
                    self.calibration = float(f.read().strip() or 0.0)
            elif self.calibration != 0.0:
                os.makedirs(os.path.dirname(self.cal_file) or ".",
                            exist_ok=True)
                with open(self.cal_file, "w") as f:
                    f.write(f"{self.calibration:.6g}\n")
        self.actual = self._tune_hw(self.requested)
        # LO1 at which the replayed recording was captured: signals in the
        # recording sit at fixed RF = center + IF, so a retune shifts the
        # replayed spectrum by (center - actual)
        self.center = self.requested
        self.cascade = None
        self.fs4_phase = 0
        if self.decim_log2:
            from ..models.frontend import HalfBandCascade

            self.cascade = HalfBandCascade(self.decim_log2)
        self.corrector = FrontEndCorrector(BLOCKSIZE, self.samprate)
        # Hardware AGC model (funcube.c:588-620 / hackrf.c:679-749): the
        # simulated analog chain applies the gain *relative to the startup
        # setting* (the source already represents the A/D level at the
        # initial gains); the receiver undoes the absolute gain with
        # gain_factor = 10^(-total/20) (radio_status.c:309-316), so gain
        # steps are transparent to the PCM output.
        agc_kind = getattr(args, "agc", None)
        if agc_kind is None or agc_kind == "auto":
            agc_kind = "hackrf" if self.decim_log2 else "funcube"
        if agc_kind == "hackrf":
            self.agc = HackRFAGC()
        else:   # "funcube", or "off" = funcube gains held fixed
            self.agc = FuncubeAGC()
        self.agc_hold = agc_kind == "off"
        self._gain0_db = self.agc.total_db
        self.data_sock = setup_mcast(args.output, output=True, ttl=args.ttl)
        self.ctl_sock = setup_mcast(args.output, output=False, offset=2)
        self.status_sock = setup_mcast(args.output, output=True,
                                       ttl=args.ttl, offset=2)
        self.compactor = StatusCompactor()
        self.seq = 0
        self.timestamp = 0
        self.ssrc = int(time.time()) & 0xFFFFFFFF
        self.commands = 0
        self.status_count = 0
        self.shift_phase = 0.0
        self._rng = np.random.default_rng(1)
        self._file = open(args.iq_file, "rb") if args.iq_file else None

    # ---- sample source ----

    def next_block(self) -> np.ndarray:
        n_adc = BLOCKSIZE * (1 << self.decim_log2)
        if self._file is not None:
            raw = self._file.read(n_adc * 4)
            if len(raw) < n_adc * 4:
                self._file.seek(0)
                raw = self._file.read(n_adc * 4)
            x = np.frombuffer(raw, "<i2").astype(np.float32) / 32767.0
            iq = (x[0::2] + 1j * x[1::2]).astype(np.complex64)
        else:
            iq = 0.01 * (
                self._rng.standard_normal(n_adc)
                + 1j * self._rng.standard_normal(n_adc)
            ).astype(np.complex64)
        if self.cascade is not None:
            from ..models.frontend import fs4_shift

            iq, self.fs4_phase = fs4_shift(iq, self.fs4_phase)
            iq = self.cascade.process(iq)
        # model retune: a signal fixed at RF moves through the IF passband
        # by (recording center - actual LO1), frac-N quantisation included
        df = self.center - self.actual
        if df != 0.0:
            k = self.shift_phase + np.arange(BLOCKSIZE) * (df / self.samprate)
            iq = iq * np.exp(2j * np.pi * k).astype(np.complex64)
            self.shift_phase = (k[-1] + df / self.samprate) % 1.0
        # simulated analog gain stages ahead of the A/D (relative to the
        # startup setting; see __init__)
        rel_db = self.agc.total_db - self._gain0_db
        if rel_db:
            iq = iq * np.float32(10.0 ** (rel_db / 20.0))
        return iq

    def _tune_hw(self, f_req: float) -> float:
        """Commanded frequency -> the quantised frequency the hardware
        actually delivers at the stream center.  The TCXO calibration
        divides the request before the synthesizer and scales the
        quantised result back (funcube.c:751,799-808; hackrf.c:605).
        hackrf mode includes the +Fs/4 offset tune (hackrf.c:601: the
        tuner sits Fs/4 high and the fs4_shift in the DSP moves the
        target back to DC), so the reported LO1 is the effective
        post-shift center."""
        intfreq = round(f_req / (1.0 + self.calibration))
        if self.tuner == "hackrf":
            off = self.adc_rate / 4 if self.decim_log2 else 0.0
            actual_hw = hackrf_actual_frequency(intfreq + off) - off
        else:
            actual_hw = fcd_actual_frequency(intfreq)
        return actual_hw * (1.0 + self.calibration)

    # ---- control plane ----

    def handle_command(self, data: bytes) -> None:
        """TLV command: leading byte 1 (funcube.c ncmd, 718-830)."""
        if not data or data[0] != 1:
            return
        self.commands += 1
        for t, v in st.decode_packet(data[1:]):
            if t == StatusType.RADIO_FREQUENCY:
                f = st.decode_double(v)
                # a daemon must not be killable by one crafted datagram:
                # round(nan)/round(inf) raise inside _tune_hw
                if np.isfinite(f) and 0.0 <= f < 10e9:
                    self.requested = f
                    self.actual = self._tune_hw(self.requested)
            elif t == StatusType.CALIBRATE:
                # funcube.c:795-799: new TCXO estimate; retune keeps the
                # commanded RF and re-quantises through the synthesizer.
                # TCXO errors are ppm-scale; a crafted cal of -1 would
                # divide by zero in _tune_hw
                c = st.decode_double(v)
                if np.isfinite(c) and abs(c) < 1e-2:
                    self.calibration = c
                    self.actual = self._tune_hw(self.requested)

    def emit_status(self) -> None:
        """10 Hz TLV status (funcube.c status thread, 836-930); also the
        AGC cadence (doagc from the status cycle, funcube.c:753-755;
        hackrf's agc thread wakes at the same 10 Hz, hackrf.c:686)."""
        if not self.agc_hold and self.corrector.in_power > 0:
            self.agc.step(10.0 * np.log10(self.corrector.in_power))
        pkt = bytearray([0])
        st.encode_int(pkt, StatusType.GPS_TIME, int(time.time_ns()))
        st.encode_int(pkt, StatusType.COMMANDS, self.commands)
        st.encode_double(pkt, StatusType.RADIO_FREQUENCY, self.actual)
        st.encode_double(pkt, StatusType.CALIBRATE, self.calibration)
        st.encode_int(pkt, StatusType.INPUT_SAMPRATE, int(self.samprate))
        st.encode_int(pkt, StatusType.OUTPUT_SSRC, self.ssrc)
        st.encode_float(pkt, StatusType.IF_POWER, self.corrector.in_power)
        st.encode_float(pkt, StatusType.DC_I_OFFSET,
                        float(np.real(self.corrector.dc)))
        st.encode_float(pkt, StatusType.DC_Q_OFFSET,
                        float(np.imag(self.corrector.dc)))
        st.encode_float(pkt, StatusType.IQ_IMBALANCE,
                        float(self.corrector.imbalance))
        st.encode_float(pkt, StatusType.IQ_PHASE, float(self.corrector.sinphi))
        st.encode_int(pkt, StatusType.LNA_GAIN, self.agc.lna_gain)
        st.encode_int(pkt, StatusType.MIXER_GAIN, self.agc.mixer_gain)
        st.encode_int(pkt, StatusType.IF_GAIN, self.agc.if_gain)
        st.encode_eol(pkt)
        self.status_count += 1
        try:
            self.status_sock.send(
                self.compactor.compact(bytes(pkt),
                                       force=self.status_count % 10 == 1)
            )
        except OSError:
            pass

    # ---- main loop ----

    def run(self, seconds: float = 0.0) -> None:
        t0 = time.monotonic()
        sent = 0              # unwrapped sample count, for pacing only
        gps_ns = int((time.time() - UNIX_EPOCH_GPS + GPS_UTC_OFFSET) * 1e9)
        last_status = 0.0
        while True:
            iq = self.corrector.process(self.next_block())
            pcm = np.empty(2 * BLOCKSIZE, np.int16)
            pcm[0::2] = np.clip(np.round(iq.real * 32767), -32768, 32767)
            pcm[1::2] = np.clip(np.round(iq.imag * 32767), -32768, 32767)
            hdr = RTPHeader(type=IQ_PT, seq=self.seq,
                            timestamp=self.timestamp, ssrc=self.ssrc)
            status = LegacyStatus(
                timestamp=gps_ns + int(self.timestamp * 1e9 / self.samprate),
                frequency=self.actual,
                samprate=int(self.samprate),
                lna_gain=self.agc.lna_gain,
                mixer_gain=self.agc.mixer_gain,
                if_gain=self.agc.if_gain,
            )
            try:
                self.data_sock.send(
                    hdr.to_bytes() + status.to_bytes() + pcm.tobytes()
                )
            except OSError:
                pass
            self.seq = (self.seq + 1) & 0xFFFF
            self.timestamp = (self.timestamp + BLOCKSIZE) & 0xFFFFFFFF
            sent += BLOCKSIZE

            # command poll + pacing against an UNWRAPPED sample counter:
            # the 32-bit RTP timestamp wraps after ~6 h at 192 ksps, which
            # would collapse `due` back to t0 and un-pace the sender
            due = t0 + sent / self.samprate
            while True:
                timeout = due - time.monotonic()
                ready, _, _ = select.select([self.ctl_sock], [],
                                            [], max(0.0, timeout))
                if ready:
                    self.handle_command(self.ctl_sock.recv(9000))
                if time.monotonic() >= due:
                    break
            now = time.monotonic()
            if now - last_status >= 0.1:
                self.emit_status()
                last_status = now
            if seconds and now - t0 >= seconds:
                return


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="frontend")
    p.add_argument("-R", "--output", required=True)
    p.add_argument("-f", "--frequency", default="146m")
    p.add_argument("-r", "--samprate", type=float, default=192000)
    p.add_argument("--iq-file", help="replay this recording as the A/D")
    p.add_argument("--decimate-log2", type=int, default=0,
                   help="hackrf-style: ADC at samprate*2^N, Fs/4 shift + "
                        "half-band cascade down to samprate")
    p.add_argument("-T", "--ttl", type=int, default=1)
    p.add_argument("--calibration", type=float, default=0.0,
                   help="TCXO offset in ppm (funcube.c:131); commanded "
                        "frequencies divide by (1+cal) before the "
                        "synthesizer, reported LO1 scales back")
    p.add_argument("--cal-file",
                   help="calibration persistence file (funcube.c:238-252: "
                        "loaded when --calibration is 0, saved otherwise); "
                        "reference path /var/local/lib/radiostate/cal-*")
    p.add_argument("--tuner", choices=["auto", "msi001", "hackrf"],
                   default="auto",
                   help="synthesizer quantisation model: msi001 "
                        "fractional-N (funcube.c:526-584) or the hackrf "
                        "RFFC5071+MAX2837 pair (hackrf.c:766-814); auto "
                        "picks hackrf when --decimate-log2 > 0")
    p.add_argument("--agc", choices=["auto", "funcube", "hackrf", "off"],
                   default="auto",
                   help="hardware AGC model: funcube gain stepping "
                        "(funcube.c:588-620), hackrf hysteresis "
                        "(hackrf.c:679-749), off = gains held; auto picks "
                        "hackrf when --decimate-log2 > 0")
    p.add_argument("--seconds", type=float, default=0.0)
    return p


def build_args(argv=None):
    return build_parser().parse_args(argv)


def main(argv=None) -> int:
    args = build_args(argv)
    try:
        FrontEndDaemon(args).run(args.seconds)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
