"""The port's I/Q and PCM tools against the JAX package's, through their
``main()``: ``iqplay`` (its Python sender and its native one), ``iqrecord``,
``pcmsend``, ``modulate`` and the legacy status header.  Inputs come from a
seeded numpy generator; with the wall clock patched the packets, files and
metadata must be byte-equal, and ``modulate``'s I/Q within 1 LSB."""

import io
import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import ka9q_sdr_tpu.apps.iqplay as iqplay_j
import ka9q_sdr_tpu.apps.iqrecord as iqrecord_j
import ka9q_sdr_tpu.apps.modulate as modulate_j
import ka9q_sdr_tpu.apps.pcmsend as pcmsend_j
import ka9q_sdr_tpu.net.sdr_header as hdr_j
import ka9q_sdr_tpu_torch.apps.iqplay as iqplay_t
import ka9q_sdr_tpu_torch.apps.iqrecord as iqrecord_t
import ka9q_sdr_tpu_torch.apps.modulate as modulate_t
import ka9q_sdr_tpu_torch.apps.pcmsend as pcmsend_t
import ka9q_sdr_tpu_torch.net.sdr_header as hdr_t
from ka9q_sdr_tpu_torch import native
from ka9q_sdr_tpu_torch.io.iqfile import read_metadata, write_metadata
from ka9q_sdr_tpu_torch.net.multicast import setup_mcast
from ka9q_sdr_tpu_torch.net.rtp import RTPHeader

SEED = 20261019
#: unique to this module
GROUP = "239.96.9.{}:5730"


class _Sink:
    def __init__(self):
        self.sent = []

    def send(self, data):
        self.sent.append(bytes(data))


def _freeze(monkeypatch, *mods):
    """The modules' wall clock stands still (SSRCs, GPS timestamps)."""
    fake = types.SimpleNamespace(time=lambda: 1.7e9 + 0.5,
                                 monotonic=time.monotonic, sleep=time.sleep)
    for m in mods:
        monkeypatch.setattr(m, "time", fake)


def _recording(tmp_path, name, n_samples, seed, freq="146520000.0"):
    path = str(tmp_path / name)
    rng = np.random.default_rng(seed)
    rng.integers(-32768, 32768, (n_samples, 2), dtype=np.int16).tofile(path)
    write_metadata(path, {"samplerate": "192000", "frequency": freq})
    return path


def test_legacy_status_header():
    rng = np.random.default_rng(SEED)
    for _ in range(50):
        kw = dict(timestamp=int(rng.integers(-2**62, 2**62)),
                  frequency=float(rng.standard_normal() * 1e9),
                  samprate=int(rng.integers(0, 2**32)),
                  lna_gain=int(rng.integers(256)),
                  mixer_gain=int(rng.integers(256)),
                  if_gain=int(rng.integers(256)))
        b = hdr_t.LegacyStatus(**kw).to_bytes()
        assert b == hdr_j.LegacyStatus(**kw).to_bytes()
        assert len(b) == hdr_t.LEGACY_STATUS_SIZE == hdr_j.LEGACY_STATUS_SIZE
        assert vars(hdr_t.LegacyStatus.from_bytes(b + b"x")) == kw
    for short in (b"", bytes(23)):
        with pytest.raises(ValueError):
            hdr_t.LegacyStatus.from_bytes(short)


# ---- iqplay ----

@pytest.mark.parametrize("argv", [[], ["-b", "100", "-f", "7.1e6"],
                                  ["-b", "-1", "-r", "96000"],
                                  ["-b", "5000", "--loop"]])
def test_iqplay_main(tmp_path, monkeypatch, argv):
    """iqplay.main's packets (legacy header, pacing clock off, -b clamp,
    --loop) are the JAX daemon's, byte for byte."""
    _freeze(monkeypatch, iqplay_t, iqplay_j)
    rec = _recording(tmp_path, "play.iq", 3000, SEED + 1)
    sent = []
    for mod in (iqplay_t, iqplay_j):
        sink = _Sink()
        monkeypatch.setattr(mod, "setup_mcast", lambda *a, **k: sink)
        if "--loop" in argv:
            # stop the looping reader after a few passes
            real_open = open
            reads = [0]

            class _Limited:
                def __init__(self, path, mode):
                    self.fh = real_open(path, mode)

                def read(self, n):
                    reads[0] += 1
                    return self.fh.read(n) if reads[0] < 40 else b""

                def seek(self, pos):
                    self.fh.seek(pos)
            monkeypatch.setattr(mod, "open", _Limited, raising=False)
            reads[0] = 0
        assert mod.main(["-R", GROUP.format(1), "--fast", *argv, rec]) == 0
        sent.append(sink.sent)
    assert sent[0] == sent[1] and len(sent[0]) > 1
    hdr, off = RTPHeader.from_bytes(sent[0][0])
    st = hdr_t.LegacyStatus.from_bytes(sent[0][0][off:])
    assert st.samprate == (96000 if "96000" in argv else 192000)


def test_iqplay_native_sender(tmp_path):
    """iqplay --native on 127.0.0.1: the C++ sender's datagrams carry the
    recording and the legacy header as the Python sender lays it out."""
    if not native.NATIVE_AVAILABLE:
        pytest.skip("no C++ compiler for the native engine")
    import socket

    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(5.0)
    port = rx.getsockname()[1]
    rec = _recording(tmp_path, "native.iq", 2000, SEED + 2, freq="1.5e7")
    try:
        assert iqplay_t.main(["-R", f"127.0.0.1:{port}", "--native",
                              "--fast", "-b", "480", rec]) == 0
        pkts = [rx.recv(9000) for _ in range(-(-2000 // 480))]
    finally:
        rx.close()
    pay = b""
    for i, p in enumerate(pkts):
        hdr, off = RTPHeader.from_bytes(p)
        assert (hdr.type, hdr.seq, hdr.timestamp) == (97, i, 480 * i)
        st = hdr_t.LegacyStatus.from_bytes(p[off:])
        assert (st.samprate, st.frequency) == (192000, 1.5e7)
        pay += p[off + hdr_t.LEGACY_STATUS_SIZE:]
    assert pay == open(rec, "rb").read()


def test_play_stream_paced():
    """play_stream paces against the sample clock: 40 packets of 1.25 ms
    take 50 ms, and the GPS timestamps follow the samples."""
    rng = np.random.default_rng(SEED + 3)
    blocks = [rng.integers(0, 256, 960, dtype=np.uint8).tobytes()
              for _ in range(40)]
    outs = []
    for mod in (iqplay_t, iqplay_j):
        it = iter(blocks)
        sink = _Sink()
        t0 = time.monotonic()
        assert mod.play_stream(lambda: next(it, b""), sink, 192000,
                               1.0e6) == 40
        outs.append((sink.sent, time.monotonic() - t0))
    for sent, dt in outs:
        assert 0.045 < dt < 1.0
        st0 = hdr_t.LegacyStatus.from_bytes(sent[0][12:])
        st9 = hdr_t.LegacyStatus.from_bytes(sent[9][12:])
        assert st9.timestamp - st0.timestamp == 9 * 1_250_000
    # equal but for the SSRC and the GPS epoch, which read the wall clock
    strip = lambda p: p[:8] + p[20:]
    assert [strip(p) for p in outs[0][0]] == [strip(p) for p in outs[1][0]]


# ---- iqrecord ----

class _FakeInput:
    """A receive socket that returns the given datagrams, then ^C."""

    def __init__(self, datagrams, sender=("10.1.2.3", 5004)):
        self.datagrams, self.sender = list(datagrams), sender

    def recvfrom(self, n):
        if not self.datagrams:
            raise KeyboardInterrupt
        return self.datagrams.pop(0), self.sender


def _iq_stream(seed):
    """iqplay's packets of two sessions (SSRCs), with a lost packet, a
    duplicate, a PCM session, junk and a packet too short for its header."""
    rng = np.random.default_rng(seed)
    out = []
    for ssrc, freq, rate in ((7, 146.52e6, 192000), (8, 0.0, 96000)):
        for i in range(30):
            if i == 11:
                continue                              # lost: a hole
            h = RTPHeader(type=97, seq=i, timestamp=240 * i, ssrc=ssrc)
            st = hdr_t.LegacyStatus(timestamp=i, frequency=freq,
                                    samprate=rate if ssrc == 7 else 0)
            pay = rng.integers(0, 256, 960, dtype=np.uint8).tobytes()
            out.append(h.to_bytes() + st.to_bytes() + pay)
            if i == 5:
                out.append(out[-1])                   # duplicate
    for i in range(10):
        out.append(RTPHeader(type=11, seq=i, timestamp=480 * i,
                             ssrc=9).to_bytes() + bytes(range(200)) * 4)
    out += [b"\x00", b"\x80\x61" + bytes(10),
            RTPHeader(type=97, seq=0, timestamp=0, ssrc=10).to_bytes()
            + bytes(5)]
    return out


@pytest.mark.parametrize("argv", [[], ["-d", "0.02"], ["--packets", "25"]])
def test_iqrecord_main(tmp_path, monkeypatch, argv):
    """iqrecord.main records the same files with the same metadata as the
    JAX daemon (one per session, holes for lost packets), and stops alike
    on -d and --packets."""
    stream = _iq_stream(SEED + 4)
    files = []
    for mod in (iqrecord_t, iqrecord_j):
        d = tmp_path / mod.__name__.split(".")[0]
        d.mkdir()
        monkeypatch.setattr(mod, "setup_mcast",
                            lambda *a, **k: _FakeInput(stream))
        assert mod.main(["-I", GROUP.format(2), "-D", str(d), *argv]) == 0
        out = {}
        for name in sorted(os.listdir(d)):
            if name.endswith(".attrs"):
                continue
            meta = read_metadata(str(d / name))
            meta.pop("unixstarttime")
            out[name] = ((d / name).read_bytes(), meta)
        files.append(out)
    assert files[0] == files[1] and files[0]
    if not argv:
        assert len(files[0]) == 5         # SSRCs 7, 8, 9 (PCM), 10 and 0
        data, meta = files[0]["iqrecord-146520000.0Hz-7"]
        assert len(data) == 30 * 960 and data[11 * 960:12 * 960] == bytes(960)
        assert meta["samplerate"] == "192000"


def test_iqrecord_round_trip(tmp_path):
    """iqplay's packets over loopback multicast into iqrecord.main: the
    recording holds the sent samples, and its metadata the sender's rate
    and frequency."""
    grp = GROUP.format(3)
    rec = _recording(tmp_path, "src.iq", 240 * 60, SEED + 5)
    out_dir = tmp_path / "recs"
    out_dir.mkdir()
    res = {}
    th = threading.Thread(target=lambda: res.update(rc=iqrecord_t.main(
        ["-I", grp, "-D", str(out_dir), "--packets", "60"])), daemon=True)
    th.start()
    time.sleep(0.3)
    tx = setup_mcast(grp, output=True, ttl=0)
    try:
        with open(rec, "rb") as fh:
            iqplay_t.play_stream(lambda: fh.read(960), tx, 192000,
                                 146.52e6, realtime=False)
        th.join(timeout=10.0)
    finally:
        tx.close()
    assert not th.is_alive() and res.get("rc") == 0
    (name,) = [n for n in os.listdir(out_dir) if not n.endswith(".attrs")]
    assert name.startswith("iqrecord-146520000.0Hz-")
    assert (out_dir / name).read_bytes() == open(rec, "rb").read()
    meta = read_metadata(str(out_dir / name))
    assert (meta["samplerate"], meta["frequency"]) == ("192000",
                                                       "146520000.000")


# ---- pcmsend ----

@pytest.mark.parametrize("mono", [False, True])
def test_pcmsend_main(monkeypatch, mono):
    _freeze(monkeypatch, pcmsend_t, pcmsend_j)
    rng = np.random.default_rng(SEED + 6 + mono)
    audio = (rng.standard_normal(5000) * 8000).astype("<i2")
    audio[1000:2500] = 0                          # silence: suppressed
    sent = []
    for mod in (pcmsend_t, pcmsend_j):
        sink = _Sink()
        monkeypatch.setattr(mod, "setup_mcast", lambda *a, **k: sink)
        monkeypatch.setattr(sys, "stdin", types.SimpleNamespace(
            buffer=io.BytesIO(audio.tobytes())))
        argv = ["-R", GROUP.format(4), "--fast"] + (["-1"] if mono else [])
        assert mod.main(argv) == 0
        sent.append(sink.sent)
    assert sent[0] == sent[1] and len(sent[0]) > 3
    assert {p[1] & 0x7F for p in sent[0]} == {11 if mono else 10}


# ---- modulate ----

def _run_modulate(mod, argv, audio, monkeypatch):
    out = io.BytesIO()
    monkeypatch.setattr(sys, "stdin", types.SimpleNamespace(
        buffer=io.BytesIO(audio.tobytes())))
    monkeypatch.setattr(sys, "stdout", types.SimpleNamespace(buffer=out))
    assert mod.main(argv) == 0
    return np.frombuffer(out.getvalue(), np.int16)


@pytest.mark.parametrize("argv", [["-m", "usb"], ["-m", "am", "-a", "-6"],
                                  ["-m", "lsb", "-f", "30000", "-s", "500"],
                                  ["-m", "ame", "-r", "96000"]])
def test_modulate_main(monkeypatch, argv):
    """modulate.main --cpu writes the JAX daemon's int16 I/Q within 1 LSB
    (the tail block zero-padded alike)."""
    rng = np.random.default_rng(SEED + 7)
    tt = np.arange(240 * 6 + 100) / 48000.0
    audio = (0.6 * np.sin(2 * np.pi * 1000 * tt) * 32767
             + rng.standard_normal(len(tt)) * 300).astype("<i2")
    got = _run_modulate(modulate_t, argv + ["--cpu"], audio, monkeypatch)
    want = _run_modulate(modulate_j, argv, audio, monkeypatch)
    assert len(got) == len(want) == 7 * 960 * 2
    assert np.max(np.abs(got.astype(np.int32) - want)) <= 1
    assert np.abs(want).max() > 1000


def test_modulate_without_a_card_exits_2(monkeypatch, capsys):
    """No card and no --cpu: exit status 2 with a message, never a quiet
    CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        modulate_t.main(["-m", "usb"])
    assert e.value.code == 2
    assert "--cpu" in capsys.readouterr().err


# ---- every new daemon's command line ----

@pytest.mark.parametrize("app", ["iqplay", "iqrecord", "pcmsend", "modulate",
                                 "frontend", "packetd", "aprs", "aprsfeed"])
def test_help(app, capsys):
    import importlib

    mod_t = importlib.import_module(f"ka9q_sdr_tpu_torch.apps.{app}")
    mod_j = importlib.import_module(f"ka9q_sdr_tpu.apps.{app}")
    outs = []
    for mod in (mod_t, mod_j):
        with pytest.raises(SystemExit) as e:
            mod.main(["--help"])
        assert e.value.code == 0
        outs.append(capsys.readouterr().out)
    flags = lambda text: {w.strip(",[]") for w in text.split()
                          if w.startswith("-")}
    extra = {"--cpu"} if app == "modulate" else set()
    assert flags(outs[0]) == flags(outs[1]) | extra


def test_package_lists_the_daemons(capsys):
    from ka9q_sdr_tpu_torch import __main__ as listing

    assert listing.main() == 0
    out = capsys.readouterr().out
    for app in listing.APPS:
        assert f"ka9q_sdr_tpu_torch.apps.{app} " in out
        __import__(f"ka9q_sdr_tpu_torch.apps.{app}")
    assert set(listing.APPS) == {"radio", "bankd", "frontend", "iqplay",
                                 "iqrecord", "modulate", "pcmsend",
                                 "packetd", "aprs", "aprsfeed", "pcmcat",
                                 "opusd", "opussend", "monitor", "control",
                                 "display"}
