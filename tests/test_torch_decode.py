"""The port's packet-radio chain against the JAX package's: ``decode/{ax25,
afsk,aprs}`` (host numpy in both packages, held bit for bit), the daemons
``packetd``, ``aprs`` and ``aprsfeed`` through their ``main()``, and the
slice as a whole: an AFSK-1200 APRS frame on an NBFM carrier through the
port's FM channel bank into the port's ``PacketSession``, against the JAX
bank feeding the JAX demodulator on the same I/Q.  Inputs come from a
seeded numpy generator."""

import math
import socket
import threading
import time
import types

import numpy as np
import pytest

import ka9q_sdr_tpu.apps.aprs as aprs_app_j
import ka9q_sdr_tpu.apps.aprsfeed as feed_j
import ka9q_sdr_tpu.apps.packetd as packetd_j
import ka9q_sdr_tpu.decode.afsk as afsk_j
import ka9q_sdr_tpu.decode.aprs as aprs_j
import ka9q_sdr_tpu.decode.ax25 as ax25_j
import ka9q_sdr_tpu_torch.apps.aprs as aprs_app_t
import ka9q_sdr_tpu_torch.apps.aprsfeed as feed_t
import ka9q_sdr_tpu_torch.apps.packetd as packetd_t
import ka9q_sdr_tpu_torch.decode.afsk as afsk_t
import ka9q_sdr_tpu_torch.decode.aprs as aprs_t
import ka9q_sdr_tpu_torch.decode.ax25 as ax25_t
from ka9q_sdr_tpu.net.multicast import setup_mcast
from ka9q_sdr_tpu.net.rtp import RTPHeader, AX25_PT, PCM_MONO_PT

SEED = 20261018
#: unique to this module
GROUP = "239.96.8.{}:5720"


def ui_frame(ax25, src="KA9Q-11", dst="APRS", digis=(), info=b"hello",
             h=()):
    """A UI frame with a valid CRC, built by `ax25`'s own encoders."""
    hdr = ax25.encode_callsign(dst) + ax25.encode_callsign(
        src, last=not digis)
    for i, d in enumerate(digis):
        hdr += ax25.encode_callsign(d, last=i == len(digis) - 1, h=d in h)
    return ax25.append_crc(hdr + bytes([0x03, 0xF0]) + info)


# ---- decode/ax25 ----

FRAMES = [
    dict(),
    dict(src="N0CALL-7", digis=("WIDE1-1", "WIDE2-2"), info=b"!test"),
    dict(src="N0CALL", digis=("WIDE1-1",), info=b">status here"),
    dict(src="N0CALL", info=b"hi\r\nN0CALL-2>APRS:forged\x00\xc1!"),
    dict(src="W1AW-15", digis=("RELAY", "TCPIP*", "WIDE1-1"),
         h=("RELAY",), info=b"{third party"),
    dict(src="ka9q", dst="APZ123-3", info=b""),
]


@pytest.mark.parametrize("kw", FRAMES, ids=range(len(FRAMES)))
def test_ax25_frames(kw):
    ft, fj = ui_frame(ax25_t, **kw), ui_frame(ax25_j, **kw)
    assert ft == fj and ax25_t.crc_good(ft) and ax25_j.crc_good(fj)
    assert not ax25_t.crc_good(ft[:-1] + bytes([ft[-1] ^ 1]))
    pt, pj = ax25_t.ax25_parse(ft), ax25_j.ax25_parse(fj)
    assert vars(pt) == vars(pj)
    for q in (None, "MYGATE-10"):
        assert ax25_t.frame_to_tnc2(pt, q) == ax25_j.frame_to_tnc2(pj, q)
    for call in ("KA9Q-11", "W1AW", "N0CALL-0", "AB1CDEFG-3", "X-15"):
        for last in (False, True):
            for h in (False, True):
                e = ax25_t.encode_callsign(call, last, h)
                assert e == ax25_j.encode_callsign(call, last, h)
                assert ax25_t.get_callsign(e) == ax25_j.get_callsign(e)


def test_ax25_hostile_and_base91():
    """Seeded garbage and mangled frames parse (or are refused) alike."""
    rng = np.random.default_rng(SEED)
    good = ui_frame(ax25_j, digis=("WIDE1-1",), info=b"!x")
    for _ in range(400):
        if rng.random() < 0.5:
            data = bytes(rng.integers(0, 256, int(rng.integers(0, 90)),
                                      dtype=np.uint8))
        else:
            data = bytearray(good)
            for _ in range(int(rng.integers(1, 4))):
                data[int(rng.integers(len(data)))] = int(rng.integers(256))
            data = bytes(data[: int(rng.integers(10, len(data) + 1))])
        pt, pj = ax25_t.ax25_parse(data), ax25_j.ax25_parse(data)
        assert (pt is None) == (pj is None)
        if pt is not None:
            assert vars(pt) == vars(pj)
            assert ax25_t.frame_to_tnc2(pt) == ax25_j.frame_to_tnc2(pj)
        assert ax25_t.crc_good(data) == ax25_j.crc_good(data)
        assert ax25_t.append_crc(data) == ax25_j.append_crc(data)
    for s in ("<*e7", "!!!!", "{{{{", b"5L!!"):
        assert ax25_t.decode_base91(s) == ax25_j.decode_base91(s)
    assert ax25_t.decode_base91("<*e7") == 20427156


# ---- decode/afsk ----

def _streams():
    """PCM streams of tests/test_decode.py:106-181: clean, two frames,
    corrupt, resampled (clock slew), a runt before the frame, and flags
    sharing their zeros."""
    f = ui_frame(ax25_j, info=b"The quick brown fox 123")
    f2 = ui_frame(ax25_j, src="B2BBB", info=b"frame two")
    z = lambda n: np.zeros(n, np.float32)
    pcm = afsk_j.afsk_modulate(f)
    n = len(pcm)
    slew = np.interp(np.arange(0, n - 1, 1.002), np.arange(n),
                     pcm).astype(np.float32)
    flag = [0, 1, 1, 1, 1, 1, 1, 0]
    runt = flag * 5 + [1, 0, 1] + afsk_j.hdlc_encode(f)
    shared = [0] + [1, 1, 1, 1, 1, 1, 0] * 6 + afsk_j.hdlc_encode(f)
    bad = f[:-1] + bytes([f[-1] ^ 0xFF])
    return {
        "clean": ([f], np.concatenate([z(4000), pcm, z(8000)])),
        "two": ([f, f2], np.concatenate([z(2000), pcm, z(2000),
                                         afsk_j.afsk_modulate(f2), z(8000)])),
        "corrupt": ([], np.concatenate([afsk_j.afsk_modulate(bad), z(8000)])),
        "offset": ([f], np.concatenate([z(4000), slew, z(8000)])),
        "runt": ([f], np.concatenate([z(4000), afsk_j.modulate_bits(runt),
                                      z(8000)])),
        "shared": ([f], np.concatenate([z(4000),
                                        afsk_j.modulate_bits(shared),
                                        z(8000)])),
    }


def test_afsk_modulator():
    rng = np.random.default_rng(SEED + 1)
    frame = bytes(rng.integers(0, 256, 60, dtype=np.uint8))
    assert afsk_t.hdlc_encode(frame, 3, 2) == afsk_j.hdlc_encode(frame, 3, 2)
    for amp in (0.5, 1.0):
        np.testing.assert_array_equal(afsk_t.afsk_modulate(frame, amp),
                                      afsk_j.afsk_modulate(frame, amp))
    bits = list(rng.integers(0, 2, 500))
    np.testing.assert_array_equal(afsk_t.modulate_bits(bits),
                                  afsk_j.modulate_bits(bits))
    np.testing.assert_array_equal(afsk_t._analytic_response(),
                                  afsk_j._analytic_response())


@pytest.mark.parametrize("name", ["clean", "two", "corrupt", "offset",
                                  "runt", "shared"])
def test_afsk_demodulator(name):
    """The same frames, and the same state after every feed, with the
    stream cut into seeded ragged pieces."""
    want, pcm = _streams()[name]
    rng = np.random.default_rng(SEED + 2 + len(name))
    cuts = np.cumsum(rng.integers(1, 3000, 200))
    cuts = [0] + [int(c) for c in cuts if c < len(pcm)] + [len(pcm)]
    dt, dj = afsk_t.AFSKDemodulator(), afsk_j.AFSKDemodulator()
    got_t, got_j = [], []
    for a, b in zip(cuts[:-1], cuts[1:]):
        got_t += dt.process(pcm[a:b])
        got_j += dj.process(pcm[a:b])
        assert (dt.symphase, dt.last_val, dt.mid_val, dt.frame_bit,
                dt.ones, dt.flagsync, dt.sample_count) == \
            (dj.symphase, dj.last_val, dj.mid_val, dj.frame_bit, dj.ones,
             dj.flagsync, dj.sample_count)
        assert dt.mark_accum == dj.mark_accum
    assert got_t == got_j
    for f in want:
        assert f in got_t
    if name == "corrupt":
        assert got_t == []


# ---- decode/aprs ----

INFOS = [b"!3648.75N/04627.50E-test", b"/180205h3648.75S/04627.50WO",
         b"@092345z4903.50N/07201.75W>cmt A=001000",
         b"=4903.50N/07201.75WA=023456x", b"!!weather", b"`(_fn\"Oj/",
         b"'c.Vl )>/]", b"/092345z/5L!!<*e7>  !", b"=/YYYYXXXX>  !",
         b"!", b"", b">status", b"!12.3N", b"!9999.99N/99999.99E",
         b"@1x", b"`"]


@pytest.mark.parametrize("dst", ["APRS", "S32U6T", "T7SYWP-3"])
def test_parse_aprs(dst):
    for info in INFOS:
        ft = ax25_t.ax25_parse(ui_frame(ax25_t, dst=dst, info=info))
        fj = ax25_j.ax25_parse(ui_frame(ax25_j, dst=dst, info=info))
        got, want = aprs_t.parse_aprs(ft), aprs_j.parse_aprs(fj)
        assert got.keys() == want.keys(), info
        for k in want:
            assert got[k] == want[k] or (math.isnan(got[k])
                                         and math.isnan(want[k])), (info, k)
        text = info.decode("ascii", "replace")
        for fn in ("parse_timestamp", "parse_position"):
            a, b = getattr(aprs_t, fn)(text[1:]), getattr(aprs_j, fn)(text[1:])
            assert repr(a) == repr(b)
        assert repr(aprs_t.parse_mice_position(ft, ft.information)) == \
            repr(aprs_j.parse_mice_position(fj, fj.information))


def test_look_angles():
    rng = np.random.default_rng(SEED + 3)
    for _ in range(200):
        site = (rng.uniform(-90, 90), rng.uniform(-180, 180),
                rng.uniform(0, 3000))
        st_t, st_jj = aprs_t.Station(*site), aprs_j.Station(*site)
        assert (st_t.xyz, st_t.up, st_t.east, st_t.south) == \
            (st_jj.xyz, st_jj.up, st_jj.east, st_jj.south)
        tgt = (rng.uniform(-90, 90), rng.uniform(-180, 180),
               rng.uniform(0, 1e5))
        assert aprs_t.look_angles(st_t, *tgt) == aprs_j.look_angles(st_jj,
                                                                     *tgt)
    same = aprs_t.look_angles(aprs_t.Station(32.0, -117.0, 100.0), 32.0,
                              -117.0, 100.0)
    assert math.isnan(same[0]) and same[2] == 0.0


# ---- the daemons ----

def _pcm_packets(pcm, ssrc, pkt=480):
    """Mono PCM as bankd's fan-out sends it: PT 11, big-endian samples."""
    q = np.clip(np.round(pcm * 32767), -32768, 32767).astype(">i2")
    return [RTPHeader(type=PCM_MONO_PT, seq=i, timestamp=i * pkt,
                      ssrc=ssrc).to_bytes() + q[i * pkt:(i + 1) * pkt]
            .tobytes() for i in range(-(-len(q) // pkt))]


def test_packet_session_against_jax():
    """PacketSession of each package on the same RTP stream (ragged and
    duplicate datagrams included) sends the same AX.25 datagrams."""
    want, pcm = _streams()["two"]
    pkts = _pcm_packets(pcm, ssrc=9)
    pkts.insert(3, pkts[2])                           # a duplicate
    last = RTPHeader.from_bytes(pkts[-1])[0]
    last.seq += 1
    pkts.append(last.to_bytes() + b"\x01")            # a ragged payload
    outs = []
    for mod in (packetd_t, packetd_j):
        sent = []
        s = mod.PacketSession(9, sent.append, verbose=True)
        for p in pkts:
            hdr, off = RTPHeader.from_bytes(p)
            s.feed(hdr, p[off:])
        outs.append((sent, s.decoded, vars(s.out)))
    assert outs[0] == outs[1]
    assert [d[12:] for d in outs[0][0]] == want
    assert all(d[1] == AX25_PT for d in outs[0][0])


def test_packetd_socket_loop():
    """packetd.main's own loop ingests PCM with hostile ragged payloads
    interleaved (tests/test_decode.py:254-291) and multicasts the frame."""
    grp, out = GROUP.format(1), GROUP.format(2)
    want, pcm = _streams()["clean"]
    rx = setup_mcast(out, output=False)
    rx.settimeout(10.0)
    res = {}
    pkts = _pcm_packets(pcm, ssrc=5)
    th = threading.Thread(target=lambda: res.update(rc=packetd_t.main(
        ["-I", grp, "-R", out, "--packets", str(2 * len(pkts))])),
        daemon=True)
    th.start()
    time.sleep(0.3)
    tx = setup_mcast(grp, output=True, ttl=0)
    try:
        for i, p in enumerate(pkts):
            tx.send(p)
            tx.send(p[:12] + b"\x01")                 # ragged: tolerated
            if i % 20 == 19:
                time.sleep(0.01)
        frame = rx.recv(9000)
        th.join(timeout=10.0)
    finally:
        tx.close()
        rx.close()
    assert not th.is_alive() and res.get("rc") == 0
    assert frame[1] == AX25_PT and frame[12:] == want[0]


def _ax25_datagram(frame, seq=0):
    return RTPHeader(type=AX25_PT, seq=seq, timestamp=0,
                     ssrc=3).to_bytes() + frame


def _frozen_gmtime(monkeypatch):
    fake = types.SimpleNamespace(
        strftime=time.strftime, gmtime=lambda: time.gmtime(1.7e9),
        time=time.time)
    monkeypatch.setattr(aprs_app_t, "time", fake)
    monkeypatch.setattr(aprs_app_j, "time", fake)


def test_aprs_main(monkeypatch, capsys):
    """aprs.main of each package prints the same report for the same
    AX.25 datagrams: a position with look angles, a bad control field, a
    filtered source."""
    _frozen_gmtime(monkeypatch)
    frames = [ui_frame(ax25_j, src="N0CALL", info=b"!3648.75N/04627.50E-x"),
              ui_frame(ax25_j, src="KA9Q-9", info=b">hello"),
              ui_frame(ax25_j, src="KA9Q-9",
                       info=b"@092345z4903.50N/07201.75W>A=001000"),
              ui_frame(ax25_j, src="KA9Q-9", info=b"`(_fn\"Oj/")]
    bad = bytearray(frames[1])
    bad[14] = 0x13                                    # control field
    frames.insert(1, ax25_j.append_crc(bytes(bad[:-2])))
    printed = []
    for k, mod in enumerate((aprs_app_t, aprs_app_j)):
        grp = GROUP.format(10 + k)
        res = {}
        th = threading.Thread(target=lambda: res.update(rc=mod.main(
            ["-I", grp, "--lat", "32.88", "--lon", "-117.24", "--alt", "120",
             "-s", "ka9q-9", "--packets", "3"])), daemon=True)
        th.start()
        time.sleep(0.3)
        tx = setup_mcast(grp, output=True, ttl=0)
        try:
            for seq, f in enumerate(frames):
                tx.send(_ax25_datagram(f, seq))
                tx.send(b"\x80\x0b" + bytes(30))      # PCM: ignored
            th.join(timeout=10.0)
        finally:
            tx.close()
        assert not th.is_alive() and res.get("rc") == 0
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    assert "Watching only ka9q-9" in printed[0]
    assert "KA9Q-9: Invalid ax25 type" in printed[0]
    assert "Lat 49.058333 Long -72.029167 Alt 304.8 m; az" in printed[0]


class _FakeInput:
    """aprsfeed's multicast input: given datagrams, then ^C."""

    def __init__(self, datagrams):
        self.datagrams = list(datagrams)

    def recv(self, n):
        if not self.datagrams:
            raise KeyboardInterrupt
        return self.datagrams.pop(0)


def test_aprsfeed_main(monkeypatch):
    """aprsfeed.main of each package against a TCP listener on 127.0.0.1:
    the same login and TNC2 lines; filtered frames are not relayed."""
    frames = [ui_frame(ax25_j, src="N0CALL", digis=("WIDE1-1",),
                       info=b"!3648.75N/04627.50E-x\r\ninject"),
              ui_frame(ax25_j, src="N0CALL", digis=("TCPIP",), info=b"!x"),
              ui_frame(ax25_j, src="N0CALL", info=b"{third"),
              ui_frame(ax25_j, src="N0CALL", info=b""),
              b"\x01\x02",
              ui_frame(ax25_j, src="W1AW-7", info=b">status")]
    datagrams = [_ax25_datagram(f, i) for i, f in enumerate(frames)]
    got = []
    for mod in (feed_t, feed_j):
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        received = []

        def serve():
            conn, _ = srv.accept()
            conn.settimeout(5.0)
            with conn:
                while True:
                    try:
                        d = conn.recv(4096)
                    except OSError:
                        break
                    if not d:
                        break
                    received.append(d)
                    if b"".join(received).count(b"\r\n") == 3:
                        break       # login and the two relayed lines
        th = threading.Thread(target=serve, daemon=True)
        th.start()
        monkeypatch.setattr(mod, "setup_mcast",
                            lambda *a, **k: _FakeInput(datagrams))
        rc = mod.main(["-I", "239.96.8.20:5720", "-u", "MYGATE-10", "-h",
                       "127.0.0.1", "-P", str(srv.getsockname()[1])])
        th.join(timeout=10.0)
        srv.close()
        assert rc == 0 and not th.is_alive()
        got.append(b"".join(received))
    assert got[0] == got[1]
    lines = got[0].decode().split("\r\n")
    assert lines[0] == (f"user MYGATE-10 pass {feed_j.aprs_passcode('MYGATE')}"
                        " vers KA9Q-aprs 1.0")
    assert lines[1:] == ["N0CALL>APRS,WIDE1-1,qAO,MYGATE-10:"
                         "!3648.75N/04627.50E-xinject",
                         "W1AW-7>APRS,qAO,MYGATE-10:>status", ""]
    for call in ("KA9Q", "ka9q-15", "N0CALL", "W1AW-7", "AB1CD"):
        assert feed_t.aprs_passcode(call) == feed_j.aprs_passcode(call)
    for f in frames:
        p = ax25_j.ax25_parse(f)
        assert feed_t.should_relay(p) == feed_j.should_relay(p)


# ---- the slice on the CPU: FM bank -> packet modem ----

def test_aprs_through_the_fm_bank():
    """An AFSK-1200 APRS frame at 3 kHz deviation on one channel of an
    8-channel FM bank at 1.536 Msps, a 1 kHz FM tone on another: the port's
    bank feeds the port's PacketSession (int16 PCM as bankd sends it), the
    JAX bank feeds the JAX demodulator, and both give the modulated frame
    (the shape of tests/test_decode.py:327-376)."""
    from ka9q_sdr_tpu.models.bank import ChannelBank as BankJ
    from ka9q_sdr_tpu.models.bank import make_bank_config as cfg_j
    from ka9q_sdr_tpu_torch.io.pcm import PCMOutput
    from ka9q_sdr_tpu_torch.models.bank import ChannelBank as BankT
    from ka9q_sdr_tpu_torch.models.bank import make_bank_config as cfg_t

    frame = ui_frame(ax25_t, src="KA9Q-9",
                     info=b"!3722.50N/12200.00W-bank chain")
    audio48 = np.concatenate([np.zeros(4000, np.float32),
                              afsk_t.afsk_modulate(frame, amplitude=1.0),
                              np.zeros(8000, np.float32)])
    fs, L, n_ch = 1536000, 30720, 8
    freqs = list(np.linspace(-0.45 * fs, 0.45 * fs, n_ch, endpoint=False))
    aprs_ch, tone_ch = 3, 5
    hi = np.repeat(audio48, 32)
    n = len(hi) // L * L
    tt = np.arange(n) / fs
    ph = np.cumsum(2 * np.pi * 3000.0 * hi[:n] / fs)
    ph2 = np.cumsum(2 * np.pi * 3000.0 * np.sin(2 * np.pi * 1000.0 * tt) / fs)
    rng = np.random.default_rng(SEED + 4)
    iq = (0.5 * np.exp(1j * (2 * np.pi * freqs[aprs_ch] * tt + ph))
          + 0.5 * np.exp(1j * (2 * np.pi * freqs[tone_ch] * tt + ph2))
          + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    x16 = np.clip(np.round(np.stack([iq.real, iq.imag], -1) * 32767 / 1.2),
                  -32768, 32767).astype(np.int16)

    bank_t = BankT(cfg_t(n_ch, "FM", samprate=fs, L=L, M=2048 * 32 - L + 1),
                   freqs, device="cpu")
    bank_j = BankJ(cfg_j(n_ch, "FM", samprate=fs, L=L, M=2048 * 32 - L + 1),
                   freqs)
    ax25_out = []
    session = packetd_t.PacketSession(aprs_ch + 1, ax25_out.append)

    def to_packetd(datagram):
        hdr, off = RTPHeader.from_bytes(datagram)
        session.feed(hdr, datagram[off:])
    pcm_out = PCMOutput(send=to_packetd, ssrc=aprs_ch + 1)
    demod_j = afsk_j.AFSKDemodulator()
    got_j, tone = [], []
    for b in range(n // L):
        blk = x16[b * L:(b + 1) * L]
        pcm, _ = bank_t.process_i16_pcm(blk)
        pcm_out.send_mono_i16(pcm[aprs_ch].numpy())
        tone.append(pcm[tone_ch].numpy().astype(np.float64))
        audio, _ = bank_j.process_i16(blk)
        got_j += demod_j.process(np.asarray(audio)[aprs_ch])
    assert [d[12:] for d in ax25_out] == [frame]
    assert ax25_out[0][1] == AX25_PT
    assert got_j == [frame]
    x = np.concatenate(tone)[2000:]
    X = np.abs(np.fft.rfft(x)) ** 2
    k = int(round(1000.0 * len(x) / 48000))
    assert X[k - 2:k + 3].sum() / X.sum() > 0.5       # the neighbour's tone
