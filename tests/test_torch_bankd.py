"""The port's ``apps/bankd`` against the JAX package's on the CPU, at the
JAX tests' small geometry (1.536 Msps, L 3840, M 4353, 8 channels): the
same recordings, blocks and TLV commands through both daemons.

Tolerances, as tests/test_torch_{multibank,receiver}.py state them:

- FM PCM: <= 1 LSB (audio within 1e-5 of full scale).
- AM and linear PCM: the PARITY.md #9 bounds (<= 8 LSB, difference RMS
  <= -85 dBFS), from the second block on (the AGC's cold start magnifies
  the FFT libraries' rounding in block 0).
- Host values (parsed commands, geometries, channel groups, counters,
  rejection messages, slot maps, TLV status apart from GPS_TIME and the
  two diag floats): exact.  DEMOD_SNR and BASEBAND_POWER come from the
  device diag: relative 1e-4.
"""

import threading
import time

import numpy as np
import pytest
import torch

from ka9q_sdr_tpu.apps import bankd as JD
from ka9q_sdr_tpu.net import status as st
from ka9q_sdr_tpu.net.status import StatusType
from ka9q_sdr_tpu_torch.apps import bankd as TD

torch.set_num_threads(1)

SAMPRATE = 1.536e6
L, M = 3840, 4353          # N = 8192, decimate 32 -> N_dec 256, L_dec 120
N_CH = 8
L_DEC = 120
GROUP = "239.96.3.1:5630"  # unique to this module


def _freqs(n=N_CH):
    usable = 0.9 * SAMPRATE
    return list(np.linspace(-usable / 2, usable / 2, n, endpoint=False))


def _signal(n_blocks, carriers, seed=0, b0=0):
    """(n_blocks, L) complex64 blocks from block b0 of a stream: carriers
    (freq, kind), kind 'fm' (400 Hz at 3 kHz deviation), 'am' (400 Hz AM,
    80 %) or 'tone', over a little noise."""
    rng = np.random.default_rng(20261018 + seed)
    out = []
    for b in range(b0, b0 + n_blocks):
        t = (b * L + np.arange(L)) / SAMPRATE
        x = 0.003 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
        for f, kind in carriers:
            if kind == "fm":
                x = x + 0.3 * np.exp(1j * (2 * np.pi * f * t + 7.5
                                           * np.sin(2 * np.pi * 400 * t)))
            elif kind == "am":
                x = x + 0.1 * (1 + 0.8 * np.sin(2 * np.pi * 400 * t)) \
                    * np.exp(2j * np.pi * f * t)
            else:
                x = x + 0.2 * np.exp(2j * np.pi * f * t)
        out.append(x.astype(np.complex64))
    return out


def _carriers(mode):
    f = _freqs()
    if mode == "FM":
        return [(f[1], "fm"), (f[5], "fm")]
    if mode == "AM":
        return [(f[2], "am"), (f[6], "am")]
    return [(f[3] + 1000.0, "tone"), (f[7] + 700.0, "tone")]


def _write_iq(path, blocks):
    x = np.concatenate(blocks)
    iq = np.empty((len(x), 2), np.int16)
    iq[:, 0] = np.clip(np.round(x.real * 32767), -32768, 32767)
    iq[:, 1] = np.clip(np.round(x.imag * 32767), -32768, 32767)
    iq.tofile(path)


def _read_pcm(path, rows=N_CH, width=L_DEC):
    a = np.frombuffer(open(path, "rb").read(), "<i2")
    return a.reshape(-1, rows, width)


def assert_pcm_close(got, want, fm):
    """got, want: (blocks, ...) int16 PCM."""
    assert got.shape == want.shape
    d = got.astype(np.int64) - want.astype(np.int64)
    if fm:
        assert np.abs(d).max() <= 1, np.abs(d).max()
        return
    d = d[1:]
    assert np.abs(d).max() <= 8, np.abs(d).max()
    rms = np.sqrt(np.mean(d.astype(np.float64) ** 2)) / 32768.0
    assert rms <= 10 ** (-85 / 20), rms


def _argv(tmp_path, tag, *extra):
    return ["-r", str(SAMPRATE), "--L", str(L), "--M", str(M), "--cpu",
            "--no-native", "--pcm-raw", str(tmp_path / f"{tag}.pcm"),
            *extra]


# ---- host functions ----

CHANNEL_FILES = [
    "100k FM\n200k FM\n300k FM -4000 4000\n400k USB\n500k USB 100 3000\n"
    "250k FM 4000 -4000\n",
    "# comment only\n\n146m52 FM\n146.94m\n-200000 AM # inline\n",
    "100k\n200k CAM\n300k ISB -3000 3000\n",
]
BAD_FILES = ["100k FM -4000\n", "100k FM low high\n", "100k FM -inf 4000\n",
             "100k NOSUCH -4000 4000\n"]


@pytest.mark.parametrize("i", range(len(CHANNEL_FILES)))
def test_read_channel_file(tmp_path, i):
    p = tmp_path / "ch.txt"
    p.write_text(CHANNEL_FILES[i])
    got = TD.read_channel_file(str(p), "FM")
    want = JD.read_channel_file(str(p), "FM")
    assert [(repr(m), f) for m, f in got] == [(repr(m), f) for m, f in want]


@pytest.mark.parametrize("text", BAD_FILES)
def test_read_channel_file_rejects(tmp_path, text):
    p = tmp_path / "bad.txt"
    p.write_text(text)
    msgs = []
    for mod in (TD, JD):
        with pytest.raises(ValueError) as e:
            mod.read_channel_file(str(p))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("rate,ms", [(1.536e6, 20.0), (24.576e6, 20.0),
                                     (393.216e6, 20.0), (393.216e6, 148.0),
                                     (24.576e6, 5.0), (6.144e6, 100.0),
                                     (192000.0, 20.0)])
def test_derive_geometry(rate, ms):
    assert TD.derive_geometry(rate, ms) == JD.derive_geometry(rate, ms)


def _cmd(*items):
    pkt = bytearray([1])
    for kind, t, v in items:
        getattr(st, f"encode_{kind}")(pkt, t, v)
    st.encode_eol(pkt)
    return bytes(pkt)


COMMANDS = [
    _cmd(("int", StatusType.OUTPUT_SSRC, 3),
         ("double", StatusType.RADIO_FREQUENCY, 123456.0)),
    _cmd(("double", StatusType.RADIO_FREQUENCY, float("nan")),
         ("float", StatusType.LOW_EDGE, float("inf")),
         ("float", StatusType.HIGH_EDGE, 3000.0)),
    _cmd(("int", StatusType.OUTPUT_SSRC, 1),
         ("double", StatusType.DOPPLER_FREQUENCY, 500.0),
         ("double", StatusType.DOPPLER_FREQUENCY_RATE, float("-inf")),
         ("float", StatusType.KAISER_BETA, 5.0)),
    _cmd(("int", StatusType.OUTPUT_SSRC, 2),
         ("string", StatusType.RADIO_MODE, b" usb ")),
    _cmd(("string", StatusType.RADIO_MODE, b"\xff\xfe")),
    b"\x00\x01\x02",
    b"",
    b"\x01",
    b"\x01\x12\x08\xff",
]


@pytest.mark.parametrize("i", range(len(COMMANDS)))
def test_parse_command(i):
    got, want = TD.parse_command(COMMANDS[i]), JD.parse_command(COMMANDS[i])
    assert repr(got) == repr(want)


# ---- the single-mode daemon ----

@pytest.mark.parametrize("mode", ["FM", "AM", "USB"])
def test_iq_file_pcm_raw(tmp_path, mode):
    """main() --iq-file --pcm-raw: the whole file path (reader, double
    buffer, final flush) of both daemons on the same recording."""
    path = tmp_path / "in.iq"
    _write_iq(path, _signal(8, _carriers(mode), seed=1))
    for mod, tag in ((TD, "port"), (JD, "jax")):
        rc = mod.main(["--iq-file", str(path), "--channels", str(N_CH),
                       "-m", mode, *_argv(tmp_path, tag)])
        assert rc == 0
    got, want = _read_pcm(tmp_path / "port.pcm"), _read_pcm(tmp_path /
                                                            "jax.pcm")
    assert got.shape == (8, N_CH, L_DEC)
    assert_pcm_close(got, want, mode == "FM")
    sig = [1, 5] if mode == "FM" else [2, 6] if mode == "AM" else [3, 7]
    assert np.abs(got[4:, sig]).max() > 1000


class _Sink:
    """Stands in for a status socket: keeps what is sent."""

    def __init__(self):
        self.sent = []

    def send(self, b):
        self.sent.append(bytes(b))


def _items(pkt):
    """A status packet's TLV items, GPS_TIME left out."""
    return [(t, v) for t, v in st.decode_packet(pkt[1:])
            if t != StatusType.GPS_TIME]


def _assert_status_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        gi, wi = _items(g), _items(w)
        assert [t for t, _ in gi] == [t for t, _ in wi]
        for (t, a), (_, b) in zip(gi, wi):
            if t in (StatusType.DEMOD_SNR, StatusType.BASEBAND_POWER):
                x, y = st.decode_float(a), st.decode_float(b)
                assert x == pytest.approx(y, rel=1e-4), t
            else:
                assert a == b, t


def _dop(ssrc, hz=None, rate=None):
    items = [("int", StatusType.OUTPUT_SSRC, ssrc)]
    if hz is not None:
        items.append(("double", StatusType.DOPPLER_FREQUENCY, hz))
    if rate is not None:
        items.append(("double", StatusType.DOPPLER_FREQUENCY_RATE, rate))
    return _cmd(*items)


def _live_commands(freqs):
    """Per block index, the TLV commands sent before that block: a
    retune onto a carrier, Doppler with both keys and with one, a filter
    swap, and hostile or foreign ones."""
    return {
        3: [_cmd(("int", StatusType.OUTPUT_SSRC, 4),
                 ("double", StatusType.RADIO_FREQUENCY, freqs[1] + 2e4))],
        4: [_dop(2, hz=300.0, rate=-20.0),
            _cmd(("int", StatusType.OUTPUT_SSRC, 99),
                 ("double", StatusType.RADIO_FREQUENCY, float("nan")))],
        5: [_dop(2, rate=15.0),
            _cmd(("float", StatusType.LOW_EDGE, -6000.0),
                 ("float", StatusType.HIGH_EDGE, 6000.0))],
        6: [_cmd(("int", StatusType.OUTPUT_SSRC, 1),
                 ("double", StatusType.RADIO_FREQUENCY, 10 * SAMPRATE)),
            _cmd(("double", StatusType.DOPPLER_FREQUENCY, 5.0)),
            _cmd(("int", StatusType.OUTPUT_SSRC, 2),
                 ("string", StatusType.RADIO_MODE, b"USB"))],
        7: [_dop(2, hz=float("inf")),
            _cmd(("int", StatusType.OUTPUT_SSRC, 3),
                 ("float", StatusType.KAISER_BETA, 1e10))],
    }


def _run_bank(mod, tmp_path, tag, mode, blocks, cmds, capsys):
    args = mod.build_parser().parse_args(_argv(tmp_path, tag, "-m", mode))
    d = mod.BankDaemon(args, _freqs())
    d.status_sock = _Sink()
    capsys.readouterr()
    for b, blk in enumerate(blocks):
        cfg = d.bank.cfg
        for c in cmds.get(b, ()):
            d.handle_command(c)
        if mod is JD and d.bank.cfg is not cfg:
            _retrace(d.bank)
        d.process_block(blk)
        d.emit_status()
    d.flush()
    d.raw.close()
    err = capsys.readouterr().err.splitlines()
    return d, err


def _retrace(jbank):
    """The JAX ChannelBank's jitted steps keep the config they were traced
    with, so its set_filter's new FM gain never reaches the audio (ROADMAP
    section 3, JAX set_filter); the port applies it, as fm.c does.  To hold
    the port to what the JAX set_filter means, retrace the JAX steps."""
    import jax

    from ka9q_sdr_tpu.models import bank as JB

    jbank._step = jax.jit(JB.bank_step_packed(jbank.cfg, jbank._template))
    for name in ("_step_i16", "_step_i16_pcm"):
        jbank.__dict__.pop(name, None)


@pytest.mark.parametrize("mode,kind", [("FM", "complex"), ("AM", "i16")])
def test_live_commands_pcm_and_status(tmp_path, capsys, mode, kind):
    """TLV retune, Doppler (two keys, then one), a filter swap and
    hostile/foreign commands between blocks: the same PCM, the same
    counters, rejection lines, Doppler memory and status packets."""
    freqs = _freqs()
    blocks = _signal(10, _carriers(mode) + [(freqs[1] + 2e4, "fm" if mode
                                             == "FM" else "am")], seed=2)
    if kind == "i16":
        blocks = [np.stack([np.clip(np.round(b.real * 32767), -32768, 32767),
                            np.clip(np.round(b.imag * 32767), -32768, 32767)],
                           -1).astype(np.int16) for b in blocks]
    cmds = _live_commands(freqs)
    dt, err_t = _run_bank(TD, tmp_path, "port", mode, blocks, cmds, capsys)
    dj, err_j = _run_bank(JD, tmp_path, "jax", mode, blocks, cmds, capsys)
    assert (dt.commands, dt.rejects) == (dj.commands, dj.rejects)
    assert dt.rejects >= 5
    assert err_t == err_j
    assert dt._dop == dj._dop and dt.bank.freqs == dj.bank.freqs
    assert (dt.cfg.mode.low, dt.cfg.mode.high) == (-6000.0, 6000.0) == \
        (dj.cfg.mode.low, dj.cfg.mode.high)
    got, want = _read_pcm(tmp_path / "port.pcm"), _read_pcm(tmp_path /
                                                            "jax.pcm")
    assert got.shape == (10, N_CH, L_DEC)
    assert_pcm_close(got, want, mode == "FM")
    _assert_status_equal(dt.status_sock.sent, dj.status_sock.sent)
    assert len(dt.status_sock.sent) > 20
    for ch in range(N_CH):
        _assert_status_equal([dt._channel_status_pkt(ch)],
                             [dj._channel_status_pkt(ch)])


# ---- the mixed-mode daemon ----

class TestMigration:
    """FM -> USB migration of a running mixed-mode daemon with spare
    slots, the port's against the JAX package's (tests/test_bankd.py's
    TestLiveModeMigration case)."""

    F_FM0, F_FM1, F_USB0 = -300e3, 150e3, 400e3
    NBLK, AT = 10, 5

    def _daemon(self, mod, tmp_path, tag):
        args = mod.build_parser().parse_args(
            _argv(tmp_path, tag, "--spare-slots", "1"))
        groups = [("FM", [self.F_FM0, self.F_FM1, 0.0]),
                  ("USB", [self.F_USB0, 0.0])]
        return mod.MultiBankDaemon(args, groups)

    def _blocks(self):
        """The JAX test's carriers over a little noise (a noiseless FM
        channel's SNR is the cancellation of two equal float32 powers)."""
        rng = np.random.default_rng(20261019)
        out = []
        for b in range(self.NBLK):
            t = (b * L + np.arange(L)) / SAMPRATE
            x = (0.003 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
                 + 0.3 * np.exp(1j * (2 * np.pi * self.F_FM0 * t
                                    + 3.0 * np.sin(2 * np.pi * 400.0 * t)))
                 + 0.3 * np.exp(2j * np.pi * (self.F_FM1 + 1e3) * t)
                 + 0.3 * np.exp(2j * np.pi * (self.F_USB0 + 700.0) * t))
            out.append(x.astype(np.complex64))
        return out

    def test_migration_pcm_slots_and_status(self, tmp_path, capsys):
        mode_cmd = _cmd(("int", StatusType.OUTPUT_SSRC, 2),
                        ("string", StatusType.RADIO_MODE, b"USB"))
        runs = {}
        for mod, tag in ((TD, "port"), (JD, "jax")):
            d = self._daemon(mod, tmp_path, tag)
            d.status_sock = _Sink()
            capsys.readouterr()
            for b, blk in enumerate(self._blocks()):
                if b == self.AT:
                    d.handle_command(mode_cmd)
                    # hostile and foreign commands, and a full group
                    d.handle_command(_cmd(
                        ("int", StatusType.OUTPUT_SSRC, 1),
                        ("string", StatusType.RADIO_MODE, b"USB")))
                    d.handle_command(_cmd(
                        ("int", StatusType.OUTPUT_SSRC, 1),
                        ("string", StatusType.RADIO_MODE, b"CW")))
                    d.handle_command(_cmd(
                        ("int", StatusType.OUTPUT_SSRC, 77),
                        ("string", StatusType.RADIO_MODE, b"AM")))
                    d.handle_command(_dop(4, rate=2.0))
                d.process_block(blk)
                d.emit_status()
            d.close()
            runs[tag] = (d, capsys.readouterr().err.splitlines())
        (dt, et), (dj, ej) = runs["port"], runs["jax"]
        assert et == ej and any("migrated ssrc 2 FM->USB" in x for x in et)
        assert dt.ssrc_map == dj.ssrc_map == {1: (0, 0), 2: (1, 1),
                                              4: (1, 0)}
        assert dt.slot_ssrc == dj.slot_ssrc
        assert [list(c) for c in dt.ch_ids] == [list(c) for c in dj.ch_ids]
        assert (dt.commands, dt.rejects) == (dj.commands, dj.rejects) == (5, 2)
        assert dt.mb.group_freqs == dj.mb.group_freqs
        got = _read_pcm(tmp_path / "port.pcm", rows=5)
        want = _read_pcm(tmp_path / "jax.pcm", rows=5)
        assert got.shape == (self.NBLK, 5, L_DEC)
        assert_pcm_close(got[:, :3], want[:, :3], fm=True)
        assert_pcm_close(got[:, 3:], want[:, 3:], fm=False)
        # the migrated channel carries its 1 kHz USB tone after the move
        tail = got[self.AT + 2:, 4].ravel().astype(np.float64)
        assert np.sqrt(np.mean(tail ** 2)) > 200
        _assert_status_equal(dt.status_sock.sent, dj.status_sock.sent)
        for ssrc in (1, 2, 4):
            _assert_status_equal([dt._channel_status_pkt(ssrc)],
                                 [dj._channel_status_pkt(ssrc)])


def test_channel_file_runs_the_mixed_daemon(tmp_path):
    """main() --channel-file with two modes: run_multibank on a recording,
    the same PCM from both daemons."""
    f = _freqs(6)
    chf = tmp_path / "ch.txt"
    chf.write_text(f"{f[0]} FM\n{f[1]} FM\n{f[2]} AM\n{f[3]} USB 200 2800\n"
                   f"{f[4]} USB\n{f[5]} AM\n")
    path = tmp_path / "in.iq"
    _write_iq(path, _signal(6, [(f[1], "fm"), (f[2], "am"),
                                (f[4] + 900.0, "tone")], seed=3))
    for mod, tag in ((TD, "port"), (JD, "jax")):
        assert mod.main(["--iq-file", str(path), "--channel-file", str(chf),
                         *_argv(tmp_path, tag)]) == 0
    got = _read_pcm(tmp_path / "port.pcm", rows=6)
    want = _read_pcm(tmp_path / "jax.pcm", rows=6)
    assert got.shape == (6, 6, L_DEC)
    # row order: the FM group, the AM group, the custom USB, the USB group
    assert_pcm_close(got[:, :2], want[:, :2], fm=True)
    assert_pcm_close(got[:, 2:], want[:, 2:], fm=False)


# ---- the live path ----

@pytest.mark.parametrize("path", ["native", "native-max-active",
                                  "no-native", "native-max-active-mesh"])
def test_live_input_over_loopback(tmp_path, capsys, monkeypatch, path):
    """bankd -I over loopback multicast, paced by the port's RTPSender:
    blocks arrive through the native engine (int16 blocks; with
    --max-active, compacted PCM three blocks deep and the timing split
    printed) or the Python assembler, and PCM goes out on -R.  With --mesh
    3 the 8 channels pad to 9 and all 9 slots are asked for: the padding
    row never takes one."""
    from ka9q_sdr_tpu_torch import native
    from ka9q_sdr_tpu_torch.net.multicast import setup_mcast
    from ka9q_sdr_tpu_torch.net.rtp import RTPHeader

    if path != "no-native" and not native.NATIVE_AVAILABLE:
        pytest.skip("no C++ toolchain")
    k = ["native", "native-max-active", "no-native",
         "native-max-active-mesh"].index(path)
    in_group, out_group = f"239.96.3.{10 + k}", f"239.96.3.{20 + k}:5630"
    n_blocks = 12
    argv = ["-I", f"{in_group}:5630", "-R", out_group, "-m", "AM",
            "--channels", str(N_CH), "-r", str(SAMPRATE), "--L", str(L),
            "--M", str(M), "--cpu", "--pcm-raw", str(tmp_path / "live.pcm"),
            "--blocks", str(n_blocks)]
    if path == "no-native":
        argv.append("--no-native")
    if path == "native-max-active":
        argv += ["--max-active", "3"]
        monkeypatch.setenv("KA9Q_BANKD_TIMING", "1")
    emitted = []
    if path == "native-max-active-mesh":
        argv += ["--max-active", "9", "--mesh", "3"]
        emit = TD.BankDaemon.emit_active

        def emit_active(self, copy, L_dec):
            emitted.append(copy.wait()[1])
            emit(self, copy, L_dec)
        monkeypatch.setattr(TD.BankDaemon, "emit_active", emit_active)
    pcm_rx = setup_mcast(out_group, output=False)
    pcm_rx.settimeout(0.0)
    rc = {}
    th = threading.Thread(target=lambda: rc.setdefault("rc", TD.main(argv)),
                          daemon=True)
    th.start()
    freqs = _freqs()
    tx = native.RTPSender(in_group, 5630, samprate=int(SAMPRATE), ttl=0) \
        if native.NATIVE_AVAILABLE else None
    ssrcs = set()
    b = 0
    deadline = time.time() + 60.0
    while th.is_alive() and time.time() < deadline:
        (x,) = _signal(1, [(freqs[2], "am")], seed=100 + b, b0=b)
        iq = np.empty(2 * L, np.int16)
        iq[0::2] = np.clip(np.round(x.real * 32767), -32768, 32767)
        iq[1::2] = np.clip(np.round(x.imag * 32767), -32768, 32767)
        if tx is not None:
            tx.send(iq, pkt_samples=240, realtime=True)
        else:
            from ka9q_sdr_tpu_torch.net.rtp import IQ_PT
            sock = setup_mcast(f"{in_group}:5630", output=True, ttl=0)
            for p in range(L // 240):
                h = RTPHeader(type=IQ_PT, seq=(b * 16 + p) & 0xFFFF,
                              timestamp=(b * L + p * 240), ssrc=3)
                sock.send(h.to_bytes() + b"\x00" * 24
                          + iq[480 * p: 480 * (p + 1)].tobytes())
            sock.close()
            time.sleep(0.02)
        b += 1
        try:
            while True:
                h, _ = RTPHeader.from_bytes(pcm_rx.recv(9000))
                ssrcs.add(h.ssrc)
        except OSError:
            pass
    th.join(timeout=10.0)
    if tx is not None:
        tx.close()
    pcm_rx.close()
    assert not th.is_alive() and rc.get("rc") == 0
    rows = {"native-max-active": 3, "native-max-active-mesh": 9}.get(path,
                                                                      N_CH)
    pcm = _read_pcm(tmp_path / "live.pcm", rows=rows)
    assert pcm.shape[0] == n_blocks
    assert 3 in ssrcs, ssrcs                  # channel 2 on the wire
    if path == "native-max-active-mesh":
        idx = np.stack(emitted)
        assert idx.shape == (n_blocks, 9) and idx.max() < N_CH
        assert (idx == -1).sum(axis=1).min() >= 1   # the padding row's slot
        assert max(ssrcs) <= N_CH
    elif path == "native-max-active":
        assert "bankd timing: read" in capsys.readouterr().err
    else:
        tail = pcm[2:, 2].ravel().astype(np.float64)
        tail -= tail.mean()
        spec = np.abs(np.fft.rfft(tail * np.hanning(len(tail))))
        f = np.fft.rfftfreq(len(tail), 1 / 48000.0)
        assert abs(f[np.argmax(spec[5:]) + 5] - 400.0) < 30.0


def test_without_a_card_the_daemon_exits(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        TD.main(["--iq-file", "x", "--channels", "2"])
    assert e.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("flag", [["--mesh", "two"], ["--shard-fft", "x"]])
def test_mesh_flags_rejected(flag, capsys):
    """--mesh takes a device count and --shard-fft no value: malformed
    flags are refused as the JAX daemon's parser refuses them (the flags
    themselves run: tests/test_torch_parallel.py)."""
    msgs = []
    for mod in (TD, JD):
        with pytest.raises(SystemExit) as e:
            mod.build_parser().parse_args(["--cpu", *flag])
        assert e.value.code == 2
        msgs.append(capsys.readouterr().err.splitlines()[-1])
    assert msgs[0] == msgs[1]
    args = TD.build_parser().parse_args(["--cpu", "--mesh", "2",
                                         "--shard-fft"])
    assert args.mesh == 2 and args.shard_fft
