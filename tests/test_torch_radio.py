"""The port's ``apps/radio`` against the JAX package's on the CPU, at the
reference defaults (192 kHz in, L 3840, M 4353, 48 kHz out): the same
recordings, TLV commands, state files and mode tables through both
daemons.

Tolerances, as tests/test_torch_receiver.py states them: FM PCM <= 1 LSB;
AM and linear PCM within the PARITY.md #9 bounds (<= 8 LSB, difference
RMS <= -85 dBFS) from the second block after a start or a mode change.
Status items that carry the device's diag are compared as numbers
(relative 1e-4; the frequency offset, a mean of the discriminator near
0 Hz, within 1 mHz; the 128-bin spectrum within 1 dB, its quantum); every
other status item, counter, rejection line and state file is exact.
"""

import numpy as np
import pytest
import torch

import jax

from ka9q_sdr_tpu.apps import radio as JR
from ka9q_sdr_tpu.io.iqfile import write_metadata
from ka9q_sdr_tpu.net import status as st
from ka9q_sdr_tpu.net.status import StatusType
from ka9q_sdr_tpu_torch.apps import radio as TR

torch.set_num_threads(1)

FS, L = 192000, 3840
IF = 48000.0
N_BLOCKS = 10
DIAG_ITEMS = {StatusType.IF_POWER, StatusType.BASEBAND_POWER,
              StatusType.NOISE_DENSITY, StatusType.DEMOD_SNR,
              StatusType.DEMOD_GAIN, StatusType.FREQ_OFFSET,
              StatusType.PEAK_DEVIATION, StatusType.PL_TONE}


def _recording(path, mode, n_blocks=N_BLOCKS, seed=0):
    """s16le I/Q at 192 kHz: FM (1 kHz at 3 kHz deviation), AM (400 Hz,
    80 %) or a tone 1 kHz above the IF (USB), over a little noise."""
    rng = np.random.default_rng(20261020 + seed)
    t = np.arange(n_blocks * L) / FS
    if mode == "FM":
        x = 0.3 * np.exp(1j * (2 * np.pi * IF * t
                               + 3.0 * np.sin(2 * np.pi * 1000 * t)))
    elif mode == "AM":
        x = 0.2 * (1 + 0.8 * np.sin(2 * np.pi * 400 * t)) \
            * np.exp(2j * np.pi * IF * t)
    else:
        x = 0.2 * np.exp(2j * np.pi * (IF + 1000.0) * t)
    x = x + 0.003 * (rng.standard_normal(len(t))
                     + 1j * rng.standard_normal(len(t)))
    iq = np.empty((len(t), 2), np.int16)
    iq[:, 0] = np.clip(np.round(x.real * 32767), -32768, 32767)
    iq[:, 1] = np.clip(np.round(x.imag * 32767), -32768, 32767)
    iq.tofile(path)
    write_metadata(str(path), {"samplerate": str(FS), "frequency": "0.0"})
    return str(path)


def _read_pcm(path):
    return np.frombuffer(open(path, "rb").read(), ">i2")


def assert_pcm_close(got, want, demod, skip=960):
    """got, want: big-endian s16 sample streams; AM and linear from
    sample `skip` on."""
    assert got.shape == want.shape and len(got) > 0
    d = got.astype(np.int64) - want.astype(np.int64)
    if demod == "FM":
        assert np.abs(d).max() <= 1, np.abs(d).max()
        return
    d = d[skip:]
    assert np.abs(d).max() <= 8, np.abs(d).max()
    rms = np.sqrt(np.mean(d.astype(np.float64) ** 2)) / 32768.0
    assert rms <= 10 ** (-85 / 20), rms


@pytest.fixture
def tables():
    """radio --modes updates each package's mode table in place, as the
    reference's process-global table; put both back after the test."""
    from ka9q_sdr_tpu.utils import modes as jm
    from ka9q_sdr_tpu_torch.utils import modes as tm

    saved = [(m.DEFAULT_MODES, dict(m.DEFAULT_MODES)) for m in (jm, tm)]
    yield
    for table, copy in saved:
        table.clear()
        table.update(copy)


CASES = [("FM", []), ("AM", ["-k", "5.0"]), ("USB", ["-s", "300"])]


@pytest.mark.parametrize("mode,extra", CASES)
def test_main_iq_file_pcm_raw(tmp_path, mode, extra):
    """main() --iq-file --pcm-raw in each mode: the same PCM."""
    rec = _recording(tmp_path / "in.iq", mode)
    for mod, tag in ((TR, "port"), (JR, "jax")):
        assert mod.main(["--iq-file", rec, "-f", "48k", "-m", mode,
                         "--pcm-raw", str(tmp_path / f"{tag}.pcm"), "--cpu",
                         "-S", "4242", *extra]) == 0
    got, want = _read_pcm(tmp_path / "port.pcm"), _read_pcm(tmp_path /
                                                            "jax.pcm")
    assert len(got) > (N_BLOCKS - 1) * 960     # FM: squelch opening
    assert_pcm_close(got, want, "FM" if mode == "FM" else "LINEAR")


class _Sink:
    def __init__(self):
        self.sent = []

    def send(self, b):
        self.sent.append(bytes(b))


def _items(pkt):
    return [(t, v) for t, v in st.decode_packet(pkt[1:])
            if t != StatusType.GPS_TIME]


def assert_status_close(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        gi, wi = _items(g), _items(w)
        assert [t for t, _ in gi] == [t for t, _ in wi]
        for (t, a), (_, b) in zip(gi, wi):
            if t in DIAG_ITEMS:
                x, y = st.decode_float(a), st.decode_float(b)
                atol = 1e-3 if t == StatusType.FREQ_OFFSET else 1e-6
                assert np.isclose(x, y, rtol=1e-4, atol=atol), (t, x, y)
            elif t == StatusType.SPECTRUM_128:
                d = np.frombuffer(a, np.uint8).astype(int) \
                    - np.frombuffer(b, np.uint8).astype(int)
                assert np.abs(d).max() <= 1
            else:
                assert a == b, t


def _cmd(*items):
    pkt = bytearray([1])
    for kind, t, v in items:
        getattr(st, f"encode_{kind}")(pkt, t, v)
    st.encode_eol(pkt)
    return bytes(pkt)


def _commands(mode):
    """Per block index: the commands sent before that block."""
    edges = {"FM": (-6000.0, 6000.0), "AM": (-4000.0, 4000.0),
             "USB": (200.0, 2700.0)}[mode]
    return {
        2: [_cmd(("double", StatusType.RADIO_FREQUENCY, IF + 150.0))],
        3: [_cmd(("float", StatusType.LOW_EDGE, edges[0]),
                 ("float", StatusType.HIGH_EDGE, edges[1]),
                 ("float", StatusType.KAISER_BETA, 4.0)),
            _cmd(("double", StatusType.RADIO_FREQUENCY, float("nan")))],
        4: [_cmd(("double", StatusType.SHIFT_FREQUENCY, 250.0)),
            _cmd(("float", StatusType.LOW_EDGE, float("nan")))],
        5: [_cmd(("double", StatusType.RADIO_FREQUENCY, IF))],
        6: [_cmd(("string", StatusType.RADIO_MODE, b"LSB")),
            _cmd(("string", StatusType.RADIO_MODE, b"NOSUCH"))],
        8: [_cmd(("float", StatusType.AGC_HANGTIME, 0.5)),
            _cmd(("double", StatusType.RADIO_FREQUENCY, 1e300)),
            b"\x00\x01\x02", b""],
    }


def _stream(wire, n):
    """The PCM datagrams laid out on their RTP clock: packets that silence
    suppression left out read as zeros."""
    from ka9q_sdr_tpu.net.rtp import RTPHeader

    out = np.zeros(n, ">i2")
    for dg in wire:
        hdr, off = RTPHeader.from_bytes(dg)
        p = np.frombuffer(dg[off:], ">i2")
        out[hdr.timestamp: hdr.timestamp + len(p)] = p
    return out


def _drive(mod, d, rec, cmds, capsys):
    """run_file's loop, with TLV commands between blocks and every
    status packet kept (uncompacted: the compactor's delta coding would
    turn a last-bit difference of a diag float into a different set of
    items; tests/test_torch_net.py holds the compactor itself).  Returns
    the stderr lines and the PCM datagrams sent."""
    from ka9q_sdr_tpu.io.iqfile import IQReader

    d.status_sock = _Sink()
    wire = []
    send = d.pcm.send
    d.pcm.send = lambda dg: (wire.append(dg), send(dg))
    d.compactor.compact = lambda pkt, force=False: pkt
    capsys.readouterr()
    for b, block in enumerate(IQReader(rec).blocks(L)):
        cfg = d.rx.cfg
        for c in cmds.get(b, ()):
            d.handle_command(c)
        if mod is JR and d.rx.cfg.mode.demod == "FM" and \
                (d.rx.cfg.mode.low, d.rx.cfg.mode.high) != \
                (cfg.mode.low, cfg.mode.high):
            _retrace(d.rx)
        audio, diag = d.rx.process(block)
        if mod is TR:
            d._emit_audio(TR.HostCopy([audio]))
            d.emit_status(TR.fetch_diag(diag))
        else:
            d._emit_audio(audio)
            d.emit_status(jax.device_get(diag))
    d.close()
    return capsys.readouterr().err.splitlines(), wire


def _retrace(jrx):
    """The JAX Receiver's jitted step keeps the config it was traced with,
    so its set_filter's new FM gain never reaches the audio (ROADMAP
    section 3, JAX set_filter); the port applies it, as fm.c does.  Hold
    the port to what the JAX set_filter means: retrace the JAX step."""
    from ka9q_sdr_tpu.models import receiver as JRX

    jrx._step = jax.jit(JRX.receiver_step_packed(jrx.cfg, jrx._template))


@pytest.mark.parametrize("mode", ["FM", "AM", "USB"])
def test_mid_run_commands(tmp_path, capsys, mode):
    """Retune, filter and beta, shift, a mode change, option flags and
    hostile values over TLV between blocks: the same PCM, counters,
    rejection lines, receiver state and status packets."""
    rec = _recording(tmp_path / "in.iq", mode, seed=1)
    cmds = _commands(mode)
    runs = {}
    for mod, tag in ((TR, "port"), (JR, "jax")):
        args = mod.build_parser().parse_args(
            ["--iq-file", rec, "-f", "48k", "-m", mode, "--cpu", "-S", "99",
             "--pcm-raw", str(tmp_path / f"{tag}.pcm")])
        d = mod.RadioDaemon(args)
        runs[tag] = (d, _drive(mod, d, rec, cmds, capsys))
    (dt, (et, wt)), (dj, (ej, wj)) = runs["port"], runs["jax"]
    assert et == ej and len(et) >= 2
    assert (dt.commands, dt.rejects, dt.freq, dt.mode) == \
        (dj.commands, dj.rejects, dj.freq, dj.mode)
    assert (dt.rx.tune_freq, dt.rx.second_lo) == (dj.rx.tune_freq,
                                                  dj.rx.second_lo)
    assert repr(dt.rx.cfg.mode) == repr(dj.rx.cfg.mode)
    raw = _read_pcm(tmp_path / "port.pcm")
    assert len(raw) == len(_read_pcm(tmp_path / "jax.pcm"))
    assert raw.tobytes() == b"".join(dg[12:] for dg in wt)
    assert [dg[:12] for dg in wt] == [dg[:12] for dg in wj]
    got, want = _stream(wt, N_BLOCKS * 960), _stream(wj, N_BLOCKS * 960)

    def blocks(a, i, j):
        return a[i * 960: j * 960]
    # the mode's bound up to the mode change (block 6); after it, and
    # after the option rebuild (block 8), the linear bound from the block
    # after each (each restarts the demodulator and its AGC)
    assert_pcm_close(blocks(got, 0, 6), blocks(want, 0, 6),
                     "FM" if mode == "FM" else "LINEAR")
    for i in (7, 9):
        assert_pcm_close(blocks(got, i, i + 1), blocks(want, i, i + 1),
                         "LINEAR", skip=0)
    assert_status_close(dt.status_sock.sent, dj.status_sock.sent)


def test_state_save_and_load(tmp_path):
    """--state: each daemon saves the same state file on exit, and a run
    that loads it (no -f, no -m) comes up on the same frequency and mode
    as the other's, with the same PCM and the same state saved again.
    (The saved "Frequency 47900.000 Hz" reloads through parse_frequency's
    small-number heuristic, in both packages alike.)"""
    rec = _recording(tmp_path / "in.iq", "USB", seed=2)
    for mod, tag in ((TR, "port"), (JR, "jax")):
        assert mod.main(["--iq-file", rec, "-f", "47k9", "-m", "USB",
                         "--cpu", "-S", "7", "--state",
                         str(tmp_path / f"{tag}.state")]) == 0
    text = (tmp_path / "port.state").read_text()
    assert text == (tmp_path / "jax.state").read_text()
    assert "Frequency 47900.000 Hz" in text and "Mode USB" in text
    for mod, tag in ((TR, "port"), (JR, "jax")):
        assert mod.main(["--iq-file", rec, "--cpu", "-S", "7", "--state",
                         str(tmp_path / f"{tag}.state"), "--pcm-raw",
                         str(tmp_path / f"{tag}.pcm")]) == 0
    again = (tmp_path / "port.state").read_text()
    assert again == (tmp_path / "jax.state").read_text()
    assert "Mode USB" in again
    got, want = _read_pcm(tmp_path / "port.pcm"), _read_pcm(tmp_path /
                                                            "jax.pcm")
    assert_pcm_close(got, want, "LINEAR")


def test_modes_table_and_flags(tmp_path, tables):
    """--modes loads a modes.txt into the port's own table (not the JAX
    package's); -S fixes the SSRC and -s shifts a linear mode."""
    from ka9q_sdr_tpu.utils import modes as jm
    from ka9q_sdr_tpu_torch.utils import modes as tm

    mf = tmp_path / "modes.txt"
    mf.write_text("# custom table\n"
                  "WIDEAM  AM  -9000  +9000  0  -50  +50  0.0\n"
                  "USB  LINEAR  +300  +2400  0  -50  +6  1.1  mono\n")
    rec = _recording(tmp_path / "in.iq", "AM", seed=3)
    daemons = []
    for mod, tag in ((TR, "port"), (JR, "jax")):
        args = mod.build_parser().parse_args(
            ["--iq-file", rec, "-f", "48k", "-m", "WIDEAM", "--cpu",
             "--modes", str(mf), "-S", "12345", "-s", "700"])
        jax_table = dict(jm.DEFAULT_MODES)
        d = mod.RadioDaemon(args)
        if mod is TR:
            assert jm.DEFAULT_MODES == jax_table
            assert "WIDEAM" in tm.DEFAULT_MODES
        daemons.append(d)
        d.close()
    dt, dj = daemons
    assert dt.rx.cfg.mode.high == 9000.0 and dt.rx.cfg.mode.demod == "AM"
    assert repr(dt.rx.cfg.mode) == repr(dj.rx.cfg.mode)
    assert tm.DEFAULT_MODES["USB"].low == 300.0
    assert dt.pcm.ssrc == dj.pcm.ssrc == 12345
    for mod, tag in ((TR, "port"), (JR, "jax")):
        assert mod.main(["--iq-file", rec, "-f", "48k", "-m", "WIDEAM",
                         "--cpu", "--modes", str(mf), "-S", "1",
                         "--pcm-raw", str(tmp_path / f"{tag}.pcm")]) == 0
    assert_pcm_close(_read_pcm(tmp_path / "port.pcm"),
                     _read_pcm(tmp_path / "jax.pcm"), "LINEAR")


def test_fetch_diag_is_one_copy_of_every_value():
    """fetch_diag stacks the receiver's diag into one host copy: each
    scalar exact as float32, flags 0/1, psd128 beside them."""
    from ka9q_sdr_tpu_torch.models.receiver import make_receiver

    rx = make_receiver("CAM", device="cpu")
    x = np.exp(2j * np.pi * 0.1 * np.arange(L)).astype(np.complex64)
    _, diag = rx.process(x)
    got = TR.fetch_diag(diag)
    assert set(got) == set(diag)
    for k, v in diag.items():
        want = v.to(torch.float32).numpy()
        np.testing.assert_array_equal(got[k], want)
    assert got["psd128"].shape == (128,)


def test_without_a_card_the_daemon_exits(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        TR.main(["--iq-file", "x"])
    assert e.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err


class _Recorder:
    """A receiver stand-in that records the Doppler steering it gets."""

    tune_freq = 435.0e6

    def __init__(self):
        self.calls = []

    def set_doppler(self, hz, rate):
        self.calls.append((hz, rate))


EPHEMERIS = ["# t az azrate el elrate range rangerate rangeraterate",
             "100 10 0.1 5 0.01 2000e3 -6500.5 12.25",
             "99 10 0.1 5 0.01 2000e3 -6400 12",      # stale: skipped
             "100.5 11 0.1 6 0.01 1990e3 -6300.125 11.5 extra",
             "101 bad line",
             "102 12 0.1 7 0.01 1980e3 7000 -3.75", ""]


def test_doppler_steering():
    """models/doppler against the JAX copy: the same ephemeris lines parse
    alike and steer a receiver with the same (Hz, Hz/s) pairs, waiting
    until each line's time."""
    from ka9q_sdr_tpu.models import doppler as jd
    from ka9q_sdr_tpu_torch.models import doppler as td

    for line in EPHEMERIS:
        assert td.parse_ephemeris_line(line) == jd.parse_ephemeris_line(line)
    runs = []
    for mod in (td, jd):
        rx, now, waits = _Recorder(), [100.0], []

        def sleep(dt, now=now, waits=waits):
            waits.append(dt)
            now[0] += dt
        steer = mod.DopplerSteerer(rx, "true", clock=lambda now=now: now[0],
                                   sleep=sleep)
        runs.append((steer.steer_from_lines(EPHEMERIS), rx.calls, waits))
    assert runs[0] == runs[1]
    n, calls, waits = runs[0]
    assert n == 3 and waits == [0.5, 1.5]
    assert calls[0] == (435.0e6 * 6500.5 / td.SPEED_OF_LIGHT,
                        435.0e6 * -12.25 / td.SPEED_OF_LIGHT)


@pytest.mark.parametrize("native_path", [True, False],
                         ids=["native", "no-native"])
def test_live_input_over_loopback(native_path):
    """radio -I over loopback multicast (a group unique to this file):
    blocks through the native engine or the Python assembler, 1 kHz PCM
    under -S's SSRC on -R, RTCP on -R's port + 1, status on + 2, and a
    front-end status packet on the input's port + 2 moves LO1."""
    import threading
    import time

    from ka9q_sdr_tpu_torch import native
    from ka9q_sdr_tpu_torch.net.multicast import setup_mcast
    from ka9q_sdr_tpu_torch.net.rtp import IQ_PT, RTPHeader

    if native_path and not native.NATIVE_AVAILABLE:
        pytest.skip("no C++ toolchain")
    k = 1 if native_path else 2
    port = 5650
    in_group, out = f"239.96.5.{k}", f"239.96.5.{10 + k}:{port}"
    n_blocks = 12
    argv = ["-I", f"{in_group}:{port}", "-R", out, "-f", "48k", "-m", "USB",
            "--cpu", "-S", "4321", "--blocks", str(n_blocks)]
    if not native_path:
        argv.append("--no-native")
    socks = [setup_mcast(out, output=False, offset=o) for o in (0, 1, 2)]
    for s in socks:
        s.settimeout(0.0)
    rc = {}
    th = threading.Thread(target=lambda: rc.setdefault("rc", TR.main(argv)),
                          daemon=True)
    th.start()
    fe = setup_mcast(f"{in_group}:{port}", output=True, ttl=0, offset=2)
    tx = setup_mcast(f"{in_group}:{port}", output=True, ttl=0)
    got = {0: [], 1: [], 2: []}
    b = 0
    deadline = time.time() + 60.0
    while th.is_alive() and time.time() < deadline:
        t = (b * L + np.arange(L)) / FS
        x = 0.2 * np.exp(2j * np.pi * (IF + 1000.0) * t)
        iq = np.empty(2 * L, np.int16)
        iq[0::2] = np.round(x.real * 32767)
        iq[1::2] = np.round(x.imag * 32767)
        for p in range(L // 240):
            h = RTPHeader(type=IQ_PT, seq=(b * 16 + p) & 0xFFFF,
                          timestamp=b * L + p * 240, ssrc=9)
            tx.send(h.to_bytes() + b"\x00" * 24
                    + iq[480 * p: 480 * (p + 1)].tobytes())
        if b == 3:
            pkt = bytearray([0])
            st.encode_double(pkt, StatusType.RADIO_FREQUENCY, 146.52e6)
            st.encode_eol(pkt)
            fe.send(bytes(pkt))
        time.sleep(0.02)
        b += 1
        for o, s in enumerate(socks):
            try:
                while True:
                    got[o].append(s.recv(9000))
            except OSError:
                pass
    th.join(timeout=10.0)
    for s in (*socks, fe, tx):
        s.close()
    assert not th.is_alive() and rc.get("rc") == 0
    pcm = [dg for dg in got[0] if RTPHeader.from_bytes(dg)[0].ssrc == 4321]
    assert pcm and len(pcm) == len(got[0])
    tail = _stream(pcm, n_blocks * 960)[4 * 960:]
    assert abs(np.argmax(np.abs(np.fft.rfft(tail))) * 48000 / len(tail)
               - 1000.0) < 10.0
    assert any(dg[:2] == b"\x80\xc8" for dg in got[1])       # RTCP SR
    status = [dict(_items(dg)) for dg in got[2] if dg[:1] == b"\x00"]
    assert status
    lo1 = [st.decode_double(s[StatusType.FIRST_LO_FREQUENCY])
           for s in status if StatusType.FIRST_LO_FREQUENCY in s]
    assert lo1 and lo1[-1] == 146.52e6
