"""The port's audio layer against the JAX package's on the CPU: the libopus
binding, the PCM -> Opus transcoder (Python sessions and the native
engine), the playout mixer, the band plan, and the daemons that carry
them (``opussend``, ``opusd``, ``monitor``).

Tolerances:

- Opus packets, RTP headers, command and band-plan lookups: byte-identical
  or equal (both sides call one libopus on the same float32 PCM).
- Decoded audio, the Mixer's ring and every ``read()``: bit-equal.

Tests that need libopus skip where ``OPUS_AVAILABLE`` is false.  Every
socket wait has a timeout.
"""

import io
import json
import os
import select
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest

import ka9q_sdr_tpu.apps.opusd as opusd_j
import ka9q_sdr_tpu.apps.opussend as opussend_j
import ka9q_sdr_tpu.audio.opus_codec as codec_j
import ka9q_sdr_tpu.audio.playout as playout_j
import ka9q_sdr_tpu.audio.transcode as transcode_j
import ka9q_sdr_tpu.utils.bandplan as bandplan_j
import ka9q_sdr_tpu_torch.apps.monitor as monitor_t
import ka9q_sdr_tpu_torch.apps.opusd as opusd_t
import ka9q_sdr_tpu_torch.apps.opussend as opussend_t
import ka9q_sdr_tpu_torch.audio.opus_codec as codec_t
import ka9q_sdr_tpu_torch.audio.playout as playout_t
import ka9q_sdr_tpu_torch.audio.transcode as transcode_t
import ka9q_sdr_tpu_torch.utils.bandplan as bandplan_t
from ka9q_sdr_tpu_torch import native
from ka9q_sdr_tpu_torch.net.multicast import setup_mcast
from ka9q_sdr_tpu_torch.net.rtp import (OPUS_PT, PCM_MONO_PT, PCM_STEREO_PT,
                                        RTPHeader)

ROOT = Path(__file__).resolve().parent.parent
SEED = 20261020
#: unique to this module: PCM in on .1, Opus out on .2 (ports per test)
GROUP = "239.96.12.{}"

needs_opus = pytest.mark.skipif(not codec_t.OPUS_AVAILABLE,
                                reason="libopus absent")


def _pcm(seq, ts, ssrc, audio, stereo=False, marker=False, pad=False):
    """A PCM RTP datagram of float audio (mono, or interleaved stereo)."""
    pcm = np.clip(np.asarray(audio) * 32767, -32768, 32767).astype(">i2")
    hdr = RTPHeader(type=PCM_STEREO_PT if stereo else PCM_MONO_PT, seq=seq,
                    timestamp=ts, ssrc=ssrc, marker=marker, pad=pad)
    return hdr.to_bytes() + pcm.tobytes()


# ---- the libopus binding ----

def _frames(seed):
    """Float stereo frames of several lengths: tones, noise, silence."""
    rng = np.random.default_rng(seed)
    out = []
    for n, kind in ((960, "tone"), (960, "tone"), (480, "noise"),
                    (2880, "tone"), (960, "silence"), (960, "silence"),
                    (960, "silence"), (120, "noise"), (960, "tone")):
        t = np.arange(n) / 48000.0
        if kind == "tone":
            x = np.stack([0.4 * np.sin(2 * np.pi * 440 * t),
                          0.2 * np.sin(2 * np.pi * 1250 * t)], -1)
        elif kind == "noise":
            x = 0.1 * rng.standard_normal((n, 2))
        else:
            x = np.zeros((n, 2))
        out.append(x.astype(np.float32))
    return out


@needs_opus
@pytest.mark.parametrize("bitrate,dtx,fec", [(32000, False, 0),
                                             (64000, True, 0),
                                             (16000, False, 20)])
def test_encoder_matches_jax(bitrate, dtx, fec):
    """OpusEncoder: byte-identical packets, resets included."""
    got, want = [], []
    for mod, out in ((codec_t, got), (codec_j, want)):
        enc = mod.OpusEncoder(48000, 2, bitrate, dtx=dtx, fec=fec)
        for i, frame in enumerate(_frames(SEED) * 3):
            if i == 9:
                enc.reset()
            out.append(enc.encode(frame))
    assert got == want
    assert len(set(got)) > 5


@needs_opus
def test_dtx_needs_digital_silence():
    """opusd's encoder (32 kb/s stereo, DTX) drops to 1-2 byte frames on
    digital silence after 200 ms (a 3-byte update every 400 ms) but keeps
    every frame of noise at 1 LSB RMS, as the JAX package's binding does:
    an unmodulated FM carrier's noise is encoded in full."""
    rng = np.random.default_rng(SEED + 3)
    noise = [np.round(rng.standard_normal((960, 1)) * 1.0).repeat(2, 1)
             .astype(np.float32) / 32767 for _ in range(60)]
    for mod in (codec_t, codec_j):
        enc = mod.OpusEncoder(48000, 2, 32000, dtx=True)
        silent = [len(enc.encode(np.zeros((960, 2), np.float32)))
                  for _ in range(60)]
        noisy = [len(enc.encode(x)) for x in noise]
        assert sum(n <= 2 for n in silent[30:]) >= 27
        assert min(noisy[30:]) > 2


@needs_opus
def test_decoder_matches_jax():
    """OpusDecoder: bit-equal audio, concealment and resets included."""
    enc = codec_t.OpusEncoder(48000, 2, 48000)
    packets = [enc.encode(f) for f in _frames(SEED + 1)]
    packets[3] = None                       # a lost packet: concealment
    outs = []
    for mod in (codec_t, codec_j):
        dec = mod.OpusDecoder()
        audio = []
        for i, p in enumerate(packets):
            if i == 6:
                dec.reset()
            audio.append(dec.decode(p))
        outs.append(np.concatenate(audio))
    assert outs[0].dtype == np.float32 and outs[0].shape[1] == 2
    np.testing.assert_array_equal(outs[0], outs[1])
    with pytest.raises(codec_t.OpusError):
        codec_t.OpusDecoder().decode(b"\xff" * 7)


# ---- the transcoder: Python sessions and the native engine ----

def _stream():
    """(sender, datagram) pairs: gap fill, a stale duplicate, a marker
    restart after a long gap, DTX silence, a stereo session with a ragged
    payload, two senders sharing one SSRC, RTP padding, a foreign payload
    type (tests/test_native.py's stream, extended)."""
    t = np.arange(480) / 48000.0
    tone_a = 0.25 * np.sin(2 * np.pi * 440 * t)
    tone_b = np.stack([0.2 * np.sin(2 * np.pi * 600 * t),
                       0.2 * np.sin(2 * np.pi * 800 * t)], -1).reshape(-1)
    tone_c = 0.3 * np.sin(2 * np.pi * 1500 * t)
    silence = np.zeros(480)
    out = []
    seq, ts = 0, 0
    for i in range(12):                 # session A, mono; seq 4 lost
        if i == 4:
            seq, ts = seq + 1, ts + 480
        out.append((0, _pcm(seq, ts, 1, tone_a)))
        seq, ts = seq + 1, ts + 480
    out.append((0, _pcm(2, 960, 1, tone_a)))          # stale duplicate
    ts += 480 * 600                                     # long gap, marker
    for i in range(6):
        out.append((0, _pcm(seq, ts, 1, tone_a, marker=(i == 0))))
        seq, ts = seq + 1, ts + 480
    for i in range(40):                                 # DTX silence
        out.append((0, _pcm(seq, ts, 1, silence)))
        seq, ts = seq + 1, ts + 480
    seq_b, ts_b = 100, 5000                             # session B, stereo
    for i in range(10):
        pkt = _pcm(seq_b, ts_b, 2, tone_b, stereo=True)
        out.append((0, pkt + (b"\x7f" if i == 3 else b"")))
        seq_b, ts_b = seq_b + 1, ts_b + 480
    for i in range(10):              # sender 1 shares SSRC 1 (its own session)
        out.append((1, _pcm(7 + i, 90000 + 480 * i, 1, tone_c,
                            pad=(i == 2)) + (b"\x00\x02" if i == 2 else b"")))
    hdr = RTPHeader(type=97, seq=0, timestamp=0, ssrc=3)
    out.append((0, hdr.to_bytes() + bytes(960)))       # not PCM: ignored
    return out


SENDERS = (("10.1.2.3", 4444), ("10.1.2.3", 4445))
TRANSCODE_OPTS = [dict(bitrate=32000, frame_ms=20.0, dtx=True),
                  dict(bitrate=64000, frame_ms=10.0, dtx=False, fec=10),
                  dict(bitrate=24000, frame_ms=60.0, dtx=True)]


def _python_transcode(mod, opts, **kw):
    out = []
    tc = mod.OpusTranscoder(send=out.append, **opts, **kw)
    for s, pkt in _stream():
        tc.feed_packet(pkt, SENDERS[s])
    return out, tc


def _by_ssrc(pkts):
    """Per SSRC, the datagrams as a sorted list (two sessions may share
    one SSRC; each session's own order is checked through seq/ts)."""
    out = {}
    for p in pkts:
        out.setdefault(RTPHeader.from_bytes(p)[0].ssrc, []).append(p)
    return {k: sorted(v) for k, v in out.items()}


@needs_opus
@pytest.mark.parametrize("opts", TRANSCODE_OPTS)
def test_transcoder_matches_jax(opts):
    got, tc = _python_transcode(transcode_t, opts)
    want, _ = _python_transcode(transcode_j, opts)
    assert got == want
    assert len(tc.sessions) == 3                 # A, B and A's twin sender
    hdrs = [RTPHeader.from_bytes(p)[0] for p in got]
    assert all(h.type == OPUS_PT for h in hdrs)
    assert sum(h.marker for h in hdrs) >= 4


@needs_opus
def test_transcoder_session_cap():
    out = []
    tc = transcode_t.OpusTranscoder(send=out.append, max_sessions=2)
    for ssrc in (1, 2, 3, 3):
        tc.feed_packet(_pcm(0, 0, ssrc, np.zeros(960)))
    assert len(tc.sessions) == 2 and tc.rejected == 2
    with pytest.raises(ValueError):
        transcode_t.OpusSession(1, out.append, frame_ms=15.0)


def _drain(rx, quiet_s=1.5, limit_s=20.0):
    """Datagrams on rx until it has been quiet for quiet_s."""
    got, deadline, last = [], time.monotonic() + limit_s, time.monotonic()
    while time.monotonic() < deadline and time.monotonic() - last < quiet_s:
        r, _, _ = select.select([rx], [], [], 0.1)
        if r:
            got.append(rx.recv(9000))
            last = time.monotonic()
    return got


def _send_stream(groups):
    """Send _stream() from two sockets (the two senders)."""
    txs = [setup_mcast(groups[0], output=True, ttl=0) for _ in SENDERS]
    for s, pkt in _stream():
        txs[s].send(pkt)
        time.sleep(0.0005)
    for tx in txs:
        tx.close()


@needs_opus
@pytest.mark.parametrize("i", [0, 1])
def test_native_transcoder_matches_python(i):
    """The port's engine against the port's Python sessions over real
    multicast loopback: byte-identical Opus RTP."""
    opts = TRANSCODE_OPTS[i]
    port = 5760 + 2 * i
    groups = (f"{GROUP.format(1)}:{port}", f"{GROUP.format(2)}:{port + 1}")
    eng = native.NativeOpusTranscoder(GROUP.format(1), GROUP.format(2),
                                      port, port + 1, **opts)
    rx = setup_mcast(groups[1], output=False)
    try:
        _send_stream(groups)
        got = _drain(rx)
        stats = eng.stats()
    finally:
        eng.close()
        rx.close()
    want, _ = _python_transcode(transcode_t, opts)
    assert _by_ssrc(got) == _by_ssrc(want)
    assert stats["sessions"] == 3 and stats["packets_out"] == len(want)
    assert stats["resets"] == 1 and stats["dupes"] == 1


_SHIM = r"""
#include <dlfcn.h>
#include <errno.h>
#include <sys/socket.h>

extern "C" {
long refused = 0;

// recvmmsg as a network stack that refuses MSG_WAITFORONE answers it
int recvmmsg(int fd, struct mmsghdr* msgs, unsigned int vlen, int flags,
             struct timespec* timeout) {
  using fn_t = int (*)(int, struct mmsghdr*, unsigned int, int,
                       struct timespec*);
  static fn_t real = (fn_t)dlsym(RTLD_NEXT, "recvmmsg");
  if (flags & MSG_WAITFORONE) {
    __atomic_add_fetch(&refused, 1, __ATOMIC_RELAXED);
    errno = EINVAL;
    return -1;
  }
  return real(fd, msgs, vlen, flags, timeout);
}
}
"""

_UNDER_SHIM = r"""
import ctypes, json, select, sys, time
from ka9q_sdr_tpu_torch import native
from ka9q_sdr_tpu_torch.net.multicast import setup_mcast
port, shim = int(sys.argv[1]), sys.argv[2]
with open(sys.argv[3]) as f:
    stream, opts = json.load(f)
grp = ("239.96.12.1", "239.96.12.2")
eng = native.NativeOpusTranscoder(grp[0], grp[1], port, port + 1, **opts)
rx = setup_mcast(f"{grp[1]}:{port + 1}", output=False)
txs = [setup_mcast(f"{grp[0]}:{port}", output=True, ttl=0) for _ in range(2)]
for s, pkt in stream:
    txs[s].send(bytes.fromhex(pkt))
    time.sleep(0.0005)
got, last = [], time.monotonic()
while time.monotonic() - last < 1.5:
    if select.select([rx], [], [], 0.1)[0]:
        got.append(rx.recv(9000).hex())
        last = time.monotonic()
eng.close()
refused = ctypes.c_long.in_dll(ctypes.CDLL(shim), "refused").value
print(json.dumps([refused, got]))
"""


@needs_opus
def test_native_transcoder_without_waitforone(tmp_path):
    """Where recvmmsg refuses MSG_WAITFORONE with EINVAL (an LD_PRELOAD
    shim here), the engine's receive loop falls back to a blocking
    one-datagram call and a non-blocking drain, and transcodes the same
    bytes."""
    src = tmp_path / "shim.cc"
    src.write_text(_SHIM)
    so = tmp_path / "libshim.so"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(so),
                    str(src), "-ldl"], check=True, timeout=120)
    assert native.build()                   # built here, not under the shim
    env = dict(os.environ, LD_PRELOAD=str(so))
    stream = tmp_path / "stream.json"
    stream.write_text(json.dumps([[(s, p.hex()) for s, p in _stream()],
                                  TRANSCODE_OPTS[0]]))
    proc = subprocess.run([sys.executable, "-c", _UNDER_SHIM, "5766",
                           str(so), str(stream)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    refused, got = json.loads(proc.stdout)
    assert refused >= 1                     # the engine met the EINVAL
    want, _ = _python_transcode(transcode_t, TRANSCODE_OPTS[0])
    assert _by_ssrc([bytes.fromhex(p) for p in got]) == _by_ssrc(want)


# ---- the playout mixer ----

def _opus_packet():
    enc = codec_t.OpusEncoder()
    frame = 0.4 * np.ones((960, 2), np.float32)
    enc.encode(frame)                        # warm up the encoder
    return enc.encode(frame)


def _mixer_cases():
    """Per case, the Mixer's constructor kwargs and its operations:
    ("feed", datagram), ("read", frames) or ("set", ssrc, attr, value)
    (tests/test_audio.py's cases, and the ring's wrap, mute and pan
    delay)."""
    S = playout_t.START_DELAY
    tone = 0.25 * np.sin(2 * np.pi * 1000 * np.arange(480) / 48000)
    ones = np.ones(480)
    st = np.full(960, 0.5)
    pad = RTPHeader(type=PCM_MONO_PT, seq=0, timestamp=0, ssrc=8,
                    marker=True, pad=True).to_bytes()
    cases = {
        "playout delay": ({}, [("feed", _pcm(0, 0, 1, tone, marker=True)),
                               ("read", S), ("read", 480)]),
        "additive": ({}, [("feed", _pcm(0, 0, 1, 0.25 * ones, marker=True)),
                          ("feed", _pcm(0, 0, 2, 0.25 * ones, marker=True)),
                          ("read", S), ("read", 480)]),
        "late bump": ({}, [("feed", _pcm(0, 0, 1, 0.1 * ones, marker=True)),
                           ("read", S + 48000),
                           ("feed", _pcm(1, 480, 1, 0.1 * ones)),
                           ("feed", _pcm(2, 960, 1, 0.1 * ones)),
                           ("read", 2000)]),
        "stereo pan": ({}, [("feed", _pcm(0, 0, 3, st, True, marker=True)),
                            ("set", 3, "pan", -1.0),
                            ("feed", _pcm(1, 480, 3, st, True)),
                            ("set", 3, "pan", 0.5),
                            ("feed", _pcm(2, 960, 3, st, True)),
                            ("read", S), ("read", 1500)]),
        "malformed": ({}, [
            ("feed", RTPHeader(type=PCM_MONO_PT, ssrc=4).to_bytes() + b"\1"),
            ("feed", RTPHeader(type=PCM_STEREO_PT, ssrc=5).to_bytes()
             + b"\1\2\3\4\5\6"),
            ("feed", RTPHeader(type=OPUS_PT, ssrc=6).to_bytes()
             + b"\xff" * 7),
            ("feed", b"\x80\x0b"), ("feed", b""),
            ("feed", _pcm(1, 240, 4, 0.5 * np.ones(240), marker=True)),
            ("read", S), ("read", 240)]),
        "padding": ({}, [("feed", pad + np.full(240, 8000, ">i2").tobytes()
                          + b"\x7f\x02"), ("read", S), ("read", 242)]),
        "marker reset": ({}, [
            ("feed", _pcm(0, 0, 1, 0.1 * ones, marker=True)),
            ("read", S + 48000), ("feed", _pcm(1, 480, 1, 0.1 * ones)),
            ("feed", _pcm(2, 96000, 1, 0.1 * ones, marker=True)),
            ("read", S + 600)]),
        "pcm then opus": ({}, [
            ("feed", _pcm(0, 0, 11, 0.2 * ones, marker=True)),
            ("feed", RTPHeader(type=OPUS_PT, seq=1, timestamp=96000,
                               ssrc=11, marker=True).to_bytes()
             + _opus_packet()),
            ("read", S), ("read", 960)]),
        "ring wrap": ({}, [("read", playout_t.RING_FRAMES - S - 200),
                           ("feed", _pcm(0, 0, 9, tone, marker=True)),
                           ("feed", _pcm(1, 480, 9, tone)),
                           ("read", S + 1500)]),
        "mute": ({}, [("feed", _pcm(0, 0, 1, tone, marker=True)),
                      ("set", 1, "muted", True),
                      ("feed", _pcm(1, 480, 1, tone)),
                      ("set", 1, "gain", 2.0),
                      ("read", S), ("read", 1000)]),
        "session cap": ({"max_sessions": 2}, [
            ("feed", _pcm(0, 0, s, tone, marker=True)) for s in (1, 2, 3)]
            + [("read", S + 480)]),
    }
    if not codec_t.OPUS_AVAILABLE:
        del cases["pcm then opus"]
    return cases


MIXER_CASES = sorted(_mixer_cases())


def _run_mixer(mod, kw, ops):
    mixer = mod.Mixer(**kw)
    reads = []
    for op in ops:
        if op[0] == "feed":
            mixer.feed_packet(op[1])
        elif op[0] == "read":
            reads.append(mixer.read(op[1]))
        else:
            setattr(mixer.sessions[op[1]], op[2], op[3])
    sessions = {k: (s.type, s.playout, s.anchor_ts, s.anchor_pos, s.packets,
                    s.lates, s.decoder is None)
                for k, s in mixer.sessions.items()}
    return mixer, reads, sessions


@pytest.mark.parametrize("case", MIXER_CASES)
def test_mixer_matches_jax(case):
    kw, ops = _mixer_cases()[case]
    mt, rt, st = _run_mixer(playout_t, kw, ops)
    mj, rj, sj = _run_mixer(playout_j, kw, ops)
    assert len(rt) == len(rj)
    for a, b in zip(rt, rj):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mt.ring, mj.ring)
    assert (mt.rptr, mt.frames_out, mt.rejected) == (mj.rptr, mj.frames_out,
                                                      mj.rejected)
    assert st == sj
    assert max(float(np.abs(r).max()) for r in rt) > 0.04


# ---- the band plan ----

def test_bandplan_file_is_the_original():
    ours = ROOT / "ka9q_sdr_tpu_torch" / "data" / "bandplan.txt"
    theirs = ROOT / "ka9q_sdr_tpu" / "data" / "bandplan.txt"
    assert ours.read_bytes() == theirs.read_bytes()


def test_bandplan_lookups_match_jax():
    bp_t = bandplan_t.load_default()
    text = (ROOT / "ka9q_sdr_tpu" / "data" / "bandplan.txt").read_text()
    bp_j = bandplan_j.Bandplan.parse(text)
    assert len(bp_t.entries) == len(bp_j.entries) > 20
    edges = [x for e in bp_j.entries for x in (e.lower, e.upper)]
    grid = np.concatenate([np.arange(0.0, 3e9, 997_003.0)]
                          + [np.array(edges) * 1e6 + d
                             for d in (-1.0, -0.4, 0.0, 0.6, 1.0)])
    hits = 0
    for f in grid:
        a, b = bp_t.lookup(float(f)), bp_j.lookup(float(f))
        assert (a is None) == (b is None), f
        if a is not None:
            hits += 1
            assert (a.lower, a.upper, a.classes, a.modes, a.name,
                    a.mode_names) == (b.lower, b.upper, b.classes, b.modes,
                                      b.name, b.mode_names), f
    assert hits > 100


def test_bandplan_parse_matches_jax():
    text = ("; comment\n# another\n\n144.0 148.0 ETG CVID 2m band\n"
            "146.52 b0.02 t v simplex\nbad line\n7.0 x e c junk\n"
            "50 54 EG CV\n28.0 29.7 e cvdi 10m  extra  words\n")
    a, b = bandplan_t.Bandplan.parse(text), bandplan_j.Bandplan.parse(text)
    assert [vars(e) for e in a.entries] == [vars(e) for e in b.entries]
    for f in (146.52e6, 146.5301e6, 52e6, 29e6, 10e6):
        x, y = a.lookup(f), b.lookup(f)
        assert (x and vars(x)) == (y and vars(y))


# ---- the daemons ----

class _Sink:
    def __init__(self):
        self.sent = []

    def send(self, data):
        self.sent.append(bytes(data))


def _fake_stdio(monkeypatch, data):
    monkeypatch.setattr(sys, "stdin", types.SimpleNamespace(
        buffer=io.BytesIO(data)))


@needs_opus
@pytest.mark.parametrize("argv", [["-o", "32000", "-x"],
                                  ["-o", "48000", "-f", "20", "-B", "10"]])
def test_opussend_matches_jax(monkeypatch, argv):
    """opussend.main's Opus RTP (frozen clock for the SSRC, pacing off) is
    the JAX daemon's, byte for byte."""
    rng = np.random.default_rng(SEED + 2)
    t = np.arange(48000) / 48000.0
    audio = np.stack([0.3 * np.sin(2 * np.pi * 700 * t),
                      0.1 * rng.standard_normal(len(t))], -1)
    audio[20000:40000] = 0.0                  # silence for DTX
    raw = np.round(audio * 32767).astype("<i2").tobytes() + b"\x01\x00"
    outs = []
    for mod in (opussend_t, opussend_j):
        sink = _Sink()
        monkeypatch.setattr(mod, "setup_mcast", lambda *a, **k: sink)
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time=lambda: 1.7e9, monotonic=time.monotonic, sleep=time.sleep))
        _fake_stdio(monkeypatch, raw)
        assert mod.main(["-R", "239.96.12.9:5769", "--fast", *argv]) == 0
        outs.append(sink.sent)
    assert outs[0] == outs[1] and len(outs[0]) > 20


class _FakeIn:
    """A receive socket that returns the stream's datagrams with their
    senders, then raises KeyboardInterrupt (the daemon's Ctrl-C)."""

    def __init__(self):
        self.items = [(p, SENDERS[s]) for s, p in _stream()]

    def recvfrom(self, n):
        if not self.items:
            raise KeyboardInterrupt
        return self.items.pop(0)


@needs_opus
def test_opusd_python_loop_matches_jax(monkeypatch):
    """opusd --py: the JAX daemon's output, byte for byte."""
    outs = []
    for mod in (opusd_t, opusd_j):
        sink = _Sink()
        monkeypatch.setattr(mod, "setup_mcast", lambda t, output=False, **k:
                            sink if output else _FakeIn())
        assert mod.main(["-I", "239.96.12.1:5768", "-R", "239.96.12.2:5769",
                         "--py", "-x"]) == 0
        outs.append(sink.sent)
    assert outs[0] == outs[1] and len(outs[0]) > 10


@needs_opus
def test_opusd_native_main(capsys):
    """opusd without --py runs the native engine (-v prints its counters,
    no fallback line) and transcodes the stream as the Python sessions
    do."""
    port = 5764
    groups = (f"{GROUP.format(1)}:{port}", f"{GROUP.format(2)}:{port + 1}")
    rx = setup_mcast(groups[1], output=False)
    res = {}
    th = threading.Thread(target=lambda: res.setdefault("rc", opusd_t.main(
        ["-I", groups[0], "-R", groups[1], "-o", "32000", "-x", "-v",
         "--seconds", "4"])), daemon=True)
    th.start()
    time.sleep(0.5)
    try:
        _send_stream(groups)
        got = _drain(rx)
    finally:
        th.join(10.0)
        rx.close()
    assert not th.is_alive() and res.get("rc") == 0
    err = capsys.readouterr().err
    assert "packets_in" in err and "falling back" not in err
    want, _ = _python_transcode(transcode_t, TRANSCODE_OPTS[0])
    assert _by_ssrc(got) == _by_ssrc(want)


def test_monitor_writes_the_mix(tmp_path, monkeypatch, capsys):
    """monitor -I g1 -I g2 --seconds: 48 kHz stereo s16 for that long,
    both sessions mixed additively, and -v's summary."""
    g1, g2 = f"{GROUP.format(5)}:5767", f"{GROUP.format(6)}:5767"
    out = tmp_path / "mix.s16"
    res = {}

    def run():
        with open(out, "wb") as f:
            monkeypatch.setattr(sys, "stdout", types.SimpleNamespace(
                buffer=f))
            res["rc"] = monitor_t.main(["-v", "-I", g1, "-I", g2,
                                        "--seconds", "1.5"])

    th = threading.Thread(target=run, daemon=True)
    th.start()
    txs = [setup_mcast(g, output=True) for g in (g1, g2)]
    pay = np.full(240, 3000, ">i2").tobytes()
    seq, deadline = 0, time.monotonic() + 20.0
    while th.is_alive() and time.monotonic() < deadline:
        for i, tx in enumerate(txs):
            tx.send(RTPHeader(type=PCM_MONO_PT, seq=seq, timestamp=seq * 240,
                              ssrc=i + 1).to_bytes() + pay)
        seq += 1
        th.join(0.005)
    th.join(5.0)
    for tx in txs:
        tx.close()
    assert not th.is_alive() and res.get("rc") == 0
    a = np.frombuffer(out.read_bytes(), np.int16)
    chunks = len(a) / (2 * 960)
    assert abs(chunks - 1.5 / 0.02) <= 3
    # two sessions of 3000 at the centre pan's 0.5 each
    assert 2990 <= np.abs(a.astype(np.int32)).max() <= 3000
    err = capsys.readouterr().err
    assert "2 sessions" in err and "0 clipped samples" in err


def test_tui_keeps_pcm_stream_clean(tmp_path):
    """monitor --tui draws on the terminal, not on stdout: the s16 stream
    stays byte-clean (tests/test_audio.py's check, on the port)."""
    import pty

    os.environ.setdefault("TERM", "xterm")
    master, slave = pty.openpty()
    pcm_path = tmp_path / "mix.s16"
    saved = os.dup(1)
    fh = open(pcm_path, "wb")
    os.dup2(fh.fileno(), 1)
    stop = {"quit": False}
    payload = bytes(range(256)) * 8
    try:
        out = monitor_t._attach_tui(playout_t.Mixer(), stop,
                                    tty_path=os.ttyname(slave))
        assert out is not None
        time.sleep(0.5)
        out.write(payload)
        out.flush()
        time.sleep(0.3)
    finally:
        stop["quit"] = True
        time.sleep(0.3)
        os.dup2(saved, 1)
        os.close(saved)
        fh.close()
    assert pcm_path.read_bytes() == payload
    r, _, _ = select.select([master], [], [], 2.0)
    ui = os.read(master, 65536) if r else b""
    os.close(master)
    os.close(slave)
    assert b"\x1b" in ui


def test_tui_without_terminal(tmp_path):
    assert monitor_t._attach_tui(playout_t.Mixer(), {"quit": False},
                                 tty_path=str(tmp_path / "none")) is None
