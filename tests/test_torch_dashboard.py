"""The port's listening and control end against the JAX package's on the
CPU: ``control`` (its status mirror, its command packets, --once),
``display`` (its tuning model and command packets), ``pcmcat``, each app's
command line, and ``control --ssrc N --tune F`` retuning the port's
``bankd`` over the wire mid-run.

Tolerances: command packets and pcmcat's output byte-identical, mirror
renders and tuning results equal; the retuned bank's other channels
bit-unchanged against a run without the command.
"""

import importlib
import io
import sys
import time
import types

import numpy as np
import pytest

import ka9q_sdr_tpu.apps.control as control_j
import ka9q_sdr_tpu.apps.display as display_j
import ka9q_sdr_tpu.apps.pcmcat as pcmcat_j
import ka9q_sdr_tpu.utils.bandplan as bandplan_j
import ka9q_sdr_tpu_torch.apps.bankd as bankd_t
import ka9q_sdr_tpu_torch.apps.control as control_t
import ka9q_sdr_tpu_torch.apps.display as display_t
import ka9q_sdr_tpu_torch.apps.pcmcat as pcmcat_t
import ka9q_sdr_tpu_torch.utils.bandplan as bandplan_t
from ka9q_sdr_tpu_torch.net import status as st
from ka9q_sdr_tpu_torch.net.rtp import (PCM_MONO_PT, PCM_STEREO_PT,
                                        RTPHeader)
from ka9q_sdr_tpu_torch.net.status import StatusType as T

SAMPRATE = 1.536e6
L, M = 3840, 4353          # N = 8192, decimate 32 -> L_dec 120
N_CH = 8
#: unique to this module
GROUP = "239.96.13.1:5780"


class _Sink:
    def __init__(self):
        self.sent = []

    def send(self, data):
        self.sent.append(bytes(data))

    def close(self):
        pass


def _freqs(n=N_CH):
    usable = 0.9 * SAMPRATE
    return list(np.linspace(-usable / 2, usable / 2, n, endpoint=False))


def _daemon(tmp_path, tag, mode="AM", output=None):
    argv = ["-r", str(SAMPRATE), "--L", str(L), "--M", str(M), "-m", mode,
            "--cpu", "--no-native", "--pcm-raw", str(tmp_path / f"{tag}.pcm")]
    if output:
        argv += ["-R", output]
    return bankd_t.BankDaemon(bankd_t.build_parser().parse_args(argv),
                              _freqs())


def _am(freq, t, tone=400.0):
    return (0.1 * (1.0 + 0.8 * np.sin(2 * np.pi * tone * t))
            * np.exp(2j * np.pi * freq * t))


def _blocks(n, extra_freq):
    """AM signals on channel 5 and on extra_freq (between channels)."""
    f = _freqs()
    return [(_am(f[5], t) + _am(extra_freq, t)).astype(np.complex64)
            for t in ((b * L + np.arange(L)) / SAMPRATE for b in range(n))]


# ---- the status mirror ----

def _radio_status():
    """A radio's status packet with every key the dashboard renders."""
    pkt = bytearray([0])
    for kind, key, v in (
            ("double", T.RADIO_FREQUENCY, 146.52e6),
            ("string", T.RADIO_MODE, "FM"),
            ("double", T.FIRST_LO_FREQUENCY, 146.568e6),
            ("double", T.SECOND_LO_FREQUENCY, 48000.0),
            ("double", T.SHIFT_FREQUENCY, -250.0),
            ("float", T.LOW_EDGE, -8000.0), ("float", T.HIGH_EDGE, 8000.0),
            ("float", T.KAISER_BETA, 3.0),
            ("int", T.PLL_ENABLE, 1), ("int", T.FM_FLAT, 1),
            ("int", T.OUTPUT_CHANNELS, 2),
            ("float", T.AGC_HEADROOM, -15.0),
            ("float", T.AGC_RECOVERY_RATE, 20.0),
            ("float", T.AGC_HANGTIME, 1.1),
            ("int", T.LNA_GAIN, 24), ("int", T.MIXER_GAIN, 19),
            ("int", T.IF_GAIN, 30),
            ("float", T.IF_POWER, 1e-3), ("float", T.BASEBAND_POWER, 1e-5),
            ("float", T.NOISE_DENSITY, 1e-12), ("float", T.DEMOD_SNR, 250.0),
            ("float", T.FREQ_OFFSET, 12.5),
            ("float", T.PEAK_DEVIATION, 2900.0),
            ("float", T.PL_TONE, float("nan")), ("int", T.PLL_LOCK, 1),
            ("int", T.OUTPUT_PACKETS, 1234), ("int", T.COMMANDS, 3)):
        getattr(st, f"encode_{kind}")(pkt, key, v)
    pkt += bytes([T.SPECTRUM_128, 128]) + bytes(range(128))
    st.encode_eol(pkt)
    return bytes(pkt)


def _bank_status(tmp_path):
    """The port's bankd status: each channel's packet after two blocks,
    then a retune's, and the bank-wide packet."""
    d = _daemon(tmp_path, "status", mode="FM")
    d.status_sock = _Sink()
    for blk in _blocks(2, 310_000.0):
        d.process_block(blk)
    d.flush()
    pkts = [d._channel_status_pkt(ch) for ch in range(N_CH)]
    d.bank.tune(3, 146.52e6 - 146.0e6)
    pkts.append(d._channel_status_pkt(3))
    d.emit_status()
    d.raw.close()
    return pkts + d.status_sock.sent[-1:]


@pytest.mark.parametrize("ssrc,plan", [(None, False), (None, True),
                                       (4, True), (99, False)])
def test_mirror_render_matches_jax(tmp_path, ssrc, plan):
    """StatusMirror over the port's bankd status (and a full radio
    status): the same values and the same dashboard text."""
    pkts = _bank_status(tmp_path) + [_radio_status(), b"\x01junk", b""]
    text = open(bandplan_t.__file__.replace("utils/bandplan.py",
                                            "data/bandplan.txt")).read()
    bps = ((bandplan_t.load_default(), bandplan_j.Bandplan.parse(text))
           if plan else (None, None))
    mirrors = (control_t.StatusMirror(ssrc), control_j.StatusMirror(ssrc))
    for pkt in pkts:
        renders = []
        for m, bp in zip(mirrors, bps):
            m.update(pkt)
            renders.append(m.render(bp))
        assert renders[0] == renders[1]
    assert repr(mirrors[0].values) == repr(mirrors[1].values)
    assert mirrors[0].packets == mirrors[1].packets > 0
    if plan and ssrc is None:
        assert "Band " in renders[0]


# ---- control's command packets ----

COMMANDS = [
    ["--tune", "147m435"],
    ["--ssrc", "4", "--tune", "310000"],
    ["--mode", "usb", "--low", "-3000", "--high", "3000"],
    ["--beta", "5.5", "--shift", "-200", "--option", "isb", "--option",
     "!pll"],
    ["--ssrc", "7", "--option", "stereo", "--option", "mono",
     "--option", "flat"],
]


@pytest.mark.parametrize("argv", COMMANDS)
def test_control_command_matches_jax(monkeypatch, capsys, argv):
    outs = []
    for mod in (control_t, control_j):
        sink = _Sink()
        monkeypatch.setattr(mod, "setup_mcast", lambda *a, **k: sink)
        assert mod.main(["239.96.13.9:5789", *argv]) == 0
        outs.append((sink.sent, capsys.readouterr().out))
    assert outs[0] == outs[1]
    assert len(outs[0][0]) == 1 and outs[0][0][0][0] == 1


class _StatusIn:
    """A status socket that returns these packets, then raises
    KeyboardInterrupt (the user's Ctrl-C)."""

    def __init__(self, pkts):
        self.pkts = list(pkts)
        self.sent = []

    def settimeout(self, t):
        pass

    def recv(self, n):
        if not self.pkts:
            raise KeyboardInterrupt
        return self.pkts.pop(0)

    def send(self, data):
        self.sent.append(bytes(data))

    def close(self):
        pass


class _Silent(_StatusIn):
    """A status group nobody sends on: every recv times out."""

    def __init__(self):
        super().__init__([])

    def recv(self, n):
        time.sleep(0.01)
        raise TimeoutError


def _chan_pkt(ssrc, freq):
    pkt = bytearray([0])
    st.encode_int(pkt, T.OUTPUT_SSRC, ssrc)
    st.encode_double(pkt, T.RADIO_FREQUENCY, freq)
    st.encode_string(pkt, T.RADIO_MODE, "FM")
    st.encode_eol(pkt)
    return bytes(pkt)


def _bank_wide():
    pkt = bytearray([0])
    st.encode_int(pkt, T.INPUT_SAMPRATE, 24576000)
    st.encode_eol(pkt)
    return bytes(pkt)


STREAMS = {
    "channel first": [_chan_pkt(4, 310000.0), _bank_wide()],
    "bank-wide first": [_bank_wide(), _bank_wide(), _chan_pkt(5, 1.0),
                        _chan_pkt(4, 310000.0)],
}


@pytest.mark.parametrize("name", sorted(STREAMS))
@pytest.mark.parametrize("argv", [["--once"], []])
def test_control_watch_matches_jax(monkeypatch, capsys, name, argv):
    """Watch mode, and --once without --ssrc: the JAX daemon's output."""
    outs = []
    for mod in (control_t, control_j):
        monkeypatch.setattr(mod, "setup_mcast",
                            lambda *a, **k: _StatusIn(STREAMS[name]))
        try:
            rc = mod.main(["239.96.13.9:5789", *argv])
        except KeyboardInterrupt:
            rc = None
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "Freq" in outs[0]


def test_control_once_waits_for_the_channel(monkeypatch, capsys):
    """--ssrc N --once prints the channel's own status; the JAX control
    returns on the bank-wide packet before it, with no frequency (ROADMAP
    section 3)."""
    outs, feeds = [], []
    for mod in (control_t, control_j):
        feeds.append(_StatusIn(STREAMS["bank-wide first"]))
        monkeypatch.setattr(mod, "setup_mcast", lambda *a, **k: feeds[-1])
        assert mod.main(["239.96.13.9:5789", "--ssrc", "4", "--once"]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0].startswith("Freq 310,000.000 Hz  Mode FM")
    assert outs[0].count("Freq") == 1
    assert outs[1].startswith("Freq nan Hz")
    # the port polls the channel first: a command carrying only its SSRC
    poll = bytearray([1])
    st.encode_int(poll, T.OUTPUT_SSRC, 4)
    st.encode_eol(poll)
    assert feeds[0].sent == [bytes(poll)] and feeds[1].sent == []


@pytest.mark.parametrize("argv", [["--ssrc", "99", "--once"], ["--once"],
                                  ["--ssrc", "99", "--once", "--seconds",
                                   "0.2"]])
def test_control_once_gives_up(monkeypatch, capsys, argv):
    """--once on a group where no status comes (or none for this SSRC)
    returns 1 after its deadline with the empty snapshot."""
    monkeypatch.setattr(control_t, "ONCE_SECONDS", 0.2)
    monkeypatch.setattr(control_t, "setup_mcast", lambda *a, **k: _Silent())
    t0 = time.monotonic()
    assert control_t.main(["239.96.13.9:5789", *argv]) == 1
    assert time.monotonic() - t0 < 2.0
    out = capsys.readouterr().out
    assert out.startswith("Freq nan Hz") and out.count("Freq") == 1


# ---- display ----

def _mirrors(pkts):
    out = (control_t.StatusMirror(), control_j.StatusMirror())
    for m in out:
        for p in pkts:
            m.update(p)
    return out


def test_tuning_state_matches_jax():
    a, b = display_t.TuningState(), display_j.TuningState()
    assert display_t.ITEMS == display_j.ITEMS
    ops = ["next_item", "cursor_left", "cursor_left", "prev_item",
           "cursor_right"] * 3 + ["cursor_left"] * 12 + ["cursor_right"] * 12
    for op in ops:
        getattr(a, op)()
        getattr(b, op)()
        assert (a.item, a.step_log10, a.step, a.item_name) == (
            b.item, b.step_log10, b.step, b.item_name)
        assert a.adjust(146.52e6, -1) == b.adjust(146.52e6, -1)


@pytest.mark.parametrize("filled", [True, False])
def test_adjust_command_matches_jax(filled):
    mt, mj = _mirrors([_radio_status()] if filled else [])
    for lock in (False, True):
        for item in range(len(display_t.ITEMS)):
            for step in (0, 3, 6):
                for d in (1, -1):
                    ts, tj = display_t.TuningState(step), \
                        display_j.TuningState(step)
                    ts.item = tj.item = item
                    if lock:
                        ts.freq_lock = tj.freq_lock = True
                    a = display_t.adjust_command(mt, ts, d)
                    b = display_j.adjust_command(mj, tj, d)
                    assert a == b, (item, step, d, lock)


def test_display_packets_match_jax():
    pairs = [(T.RADIO_MODE, "string", "USB"), (T.KAISER_BETA, "float", 4.5),
             (T.PLL_ENABLE, "int", 1),
             (T.SECOND_LO_FREQUENCY, "double", 6144000.0)]
    outs = []
    for mod in (display_t, display_j):
        sink = _Sink()
        mod.send_tune(sink, 147.435e6)
        for ssrc in (0, 12):
            mod._send_cmd(sink, *pairs, ssrc=ssrc)
            mod._send_cmd(sink, pairs[0], ssrc=ssrc)
        outs.append(sink.sent)
    assert outs[0] == outs[1] and len(outs[0]) == 5
    assert display_t.OPTION_KEYS == display_j.OPTION_KEYS


# ---- control retunes the port's bankd over the wire ----

def test_control_retunes_bankd_mid_run(tmp_path):
    """control --ssrc 4 --tune F over the multicast command group retunes
    channel 3 of the port's bankd between blocks; its PCM follows the new
    carrier while every other channel is bit-identical to an uncommanded
    run (tests/test_bankd.py's check, on the port)."""
    f_new = 310_000.0
    blocks = _blocks(12, f_new)
    a = _daemon(tmp_path, "a", output=GROUP)
    b = _daemon(tmp_path, "b")
    for blk in blocks[:4]:
        a.process_block(blk)
        b.process_block(blk)
    assert control_t.main([GROUP, "--ssrc", "4", "--tune",
                           str(int(f_new))]) == 0
    deadline = time.monotonic() + 5.0
    while a.commands == 0 and time.monotonic() < deadline:
        time.sleep(0.05)
        a.poll_commands()
    assert a.commands == 1 and a.bank.freqs[3] == f_new
    for blk in blocks[4:]:
        a.process_block(blk)
        b.process_block(blk)
    for d in (a, b):
        d.flush()
        d.raw.close()
    pa, pb = (np.frombuffer((tmp_path / f"{t}.pcm").read_bytes(),
                            "<i2").reshape(-1, N_CH, L // 32)
              for t in ("a", "b"))
    assert pa.shape == pb.shape == (12, N_CH, 120)
    others = [c for c in range(N_CH) if c != 3]
    np.testing.assert_array_equal(pa[:, others], pb[:, others])
    np.testing.assert_array_equal(pa[:4, 3], pb[:4, 3])
    tail_a = pa[8:, 3].ravel().astype(np.float32)
    tail_b = pb[8:, 3].ravel().astype(np.float32)
    assert np.sqrt(np.mean(tail_a ** 2)) > 10.0 * max(
        np.sqrt(np.mean(tail_b ** 2)), 1.0)
    spec = np.abs(np.fft.rfft(tail_a * np.hanning(len(tail_a))))
    f = np.fft.rfftfreq(len(tail_a), 1.0 / 48000.0)
    assert abs(f[np.argmax(spec[3:]) + 3] - 400.0) < 30.0


def test_control_once_polls_bankd(tmp_path, capsys):
    """control --ssrc 4 --once over the wire: its poll reaches the port's
    bankd, which answers with channel 3's status at once (no block runs
    meanwhile, so no round-robin status can answer instead)."""
    import threading

    group = "239.96.13.3:5790"
    d = _daemon(tmp_path, "poll", output=group)
    for blk in _blocks(2, 310_000.0):
        d.process_block(blk)
    d.bank.tune(3, 310_000.0)
    res = {}
    t = threading.Thread(target=lambda: res.__setitem__(
        "rc", control_t.main([group, "--ssrc", "4", "--once"])))
    t.start()
    deadline = time.monotonic() + 5.0
    while t.is_alive() and time.monotonic() < deadline:
        time.sleep(0.02)
        d.poll_commands()
    t.join(5.0)
    d.flush()
    d.raw.close()
    out = capsys.readouterr().out
    assert res.get("rc") == 0 and d.commands == 1
    assert out.startswith("Freq 310,000.000 Hz  Mode AM")


# ---- pcmcat ----

def _pcm_stream():
    """Datagrams for pcmcat: SSRC 5 first (first SSRC wins), SSRC 2 mono
    with a gap, a duplicate, a ragged tail and a long gap, SSRC 3 stereo,
    foreign and malformed datagrams."""
    rng = np.random.default_rng(20261021)

    def pkt(seq, ts, ssrc, n, stereo=False, tail=b""):
        pcm = rng.integers(-30000, 30000, n * (2 if stereo else 1),
                           dtype=np.int64).astype(">i2").tobytes()
        return RTPHeader(type=PCM_STEREO_PT if stereo else PCM_MONO_PT,
                         seq=seq, timestamp=ts, ssrc=ssrc).to_bytes() \
            + pcm + tail

    out = [pkt(0, 0, 5, 480), b"\x80", RTPHeader(type=111, ssrc=2)
           .to_bytes() + b"opus"]
    ts = 0
    for i in range(12):
        if i == 5:
            ts += 960                                   # lost packets
        if i == 9:
            ts += 96000                                 # > 1 s: capped
        out.append(pkt(i, ts, 2, 480, tail=b"\x01" if i == 3 else b""))
        out.append(pkt(i, 1000 + 240 * i, 3, 240, stereo=True))
        out.append(pkt(i + 1, 480 * (i + 1), 5, 480))
        ts += 480
    out.append(pkt(2, 960, 2, 480))                     # stale duplicate
    return out


@pytest.mark.parametrize("argv", [[], ["-s", "2"], ["-s", "0x3"],
                                  ["-s", "3", "-1"], ["-s", "2", "-2"],
                                  ["-s", "2", "--packets", "4"]])
def test_pcmcat_matches_jax(monkeypatch, argv):
    outs = []
    for mod in (pcmcat_t, pcmcat_j):
        buf = io.BytesIO()
        monkeypatch.setattr(sys, "stdout", types.SimpleNamespace(buffer=buf))
        feed = _StatusIn(_pcm_stream())
        monkeypatch.setattr(mod, "setup_mcast", lambda *a, **k: feed)
        try:
            mod.main(["239.96.13.9:5789", *argv])
        except KeyboardInterrupt:
            pass
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and len(outs[0]) > 1000


# ---- every new app's command line ----

APPS = ["opusd", "opussend", "pcmcat", "monitor", "control", "display"]


@pytest.mark.parametrize("app", APPS)
def test_help(app, capsys):
    outs = []
    for pkg in ("ka9q_sdr_tpu_torch", "ka9q_sdr_tpu"):
        mod = importlib.import_module(f"{pkg}.apps.{app}")
        with pytest.raises(SystemExit) as e:
            mod.main(["--help"])
        assert e.value.code == 0
        outs.append(capsys.readouterr().out)
    flags = lambda text: {w.strip(",[]") for w in text.split()
                          if w.startswith("-")}
    assert "usage" in outs[0].lower()
    assert flags(outs[0]) == flags(outs[1])


@pytest.mark.parametrize("app,flags", [("opusd", ["-I", "g:1", "-R", "g:2"]),
                                       ("opussend", ["-R", "g:2"])])
def test_fec_takes_loss_percentage(monkeypatch, app, flags):
    """-f is the expected packet-loss percentage (opus.c:95-96), parsed as
    the JAX daemons parse it."""
    import argparse

    captured = {}
    real = argparse.ArgumentParser.parse_args

    def spy(self, argv=None, ns=None):
        captured.update(vars(real(self, argv, ns)))
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    mod = importlib.import_module(f"ka9q_sdr_tpu_torch.apps.{app}")
    with pytest.raises(SystemExit):
        mod.main(flags + ["-f", "20"])
    assert captured["fec"] == 20
