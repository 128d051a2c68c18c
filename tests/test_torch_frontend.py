"""The port's front end against the JAX package's, bit for bit: the
hardware model ``models/frontend`` (host numpy in both packages) and the
``frontend`` daemon (``apps/frontend``).  Inputs come from a seeded numpy
generator; arrays, estimator states, tuned frequencies, AGC gains and the
daemon's packets (with the wall clock patched) must be equal."""

import math
import types
import time as _time

import numpy as np
import pytest

import ka9q_sdr_tpu.apps.frontend as fe_app_j
import ka9q_sdr_tpu.models.frontend as fe_j
import ka9q_sdr_tpu.net.status as st_j
import ka9q_sdr_tpu_torch.apps.frontend as fe_app_t
import ka9q_sdr_tpu_torch.models.frontend as fe_t
from ka9q_sdr_tpu.io.iqfile import write_metadata

SEED = 20261017
#: unique to this module; the port's daemons and the JAX ones on their own
GROUP_T, GROUP_J = "239.96.7.1:5710", "239.96.7.2:5710"


# ---- models/frontend ----

def _impaired_blocks(rng, n_blocks, n=240):
    """Complex blocks with a DC offset, an I/Q gain imbalance and a phase
    error, as an uncorrected A/D delivers them."""
    out = []
    for _ in range(n_blocks):
        i = rng.standard_normal(n) * 0.1 + 0.02
        q = rng.standard_normal(n) * 0.13 - 0.01
        q = q + 0.2 * i                                   # phase error
        out.append((i + 1j * q).astype(np.complex64))
    return out


def test_corrector_blocks():
    rng = np.random.default_rng(SEED)
    ct, cj = fe_t.FrontEndCorrector(240, 192000), fe_j.FrontEndCorrector(240,
                                                                         192000)
    for blk in _impaired_blocks(rng, 20):
        np.testing.assert_array_equal(ct.process(blk), cj.process(blk))
        assert vars(ct).keys() == vars(cj).keys()
        for k, v in vars(cj).items():
            assert np.array_equal(vars(ct)[k], v), k


def test_fs4_shift_across_blocks():
    rng = np.random.default_rng(SEED + 1)
    pt = pj = 0
    for n in (240, 7, 1, 64, 1021, 240):
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
            np.complex64)
        yt, pt = fe_t.fs4_shift(x, pt)
        yj, pj = fe_j.fs4_shift(x, pj)
        np.testing.assert_array_equal(yt, yj)
        assert yt.dtype == yj.dtype and pt == pj


@pytest.mark.parametrize("log2", [2, 6])
def test_halfband_cascade(log2):
    rng = np.random.default_rng(SEED + log2)
    ht, hj = fe_t.HalfBandCascade(log2), fe_j.HalfBandCascade(log2)
    n = 240 << log2
    for _ in range(5):
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
            np.complex64)
        yt, yj = ht.process(x), hj.process(x)
        assert yt.dtype == yj.dtype == np.complex64 and len(yt) == 240
        np.testing.assert_array_equal(yt, yj)
    for st_t, st_jj in zip(ht.stages, hj.stages):
        np.testing.assert_array_equal(st_t["state"], st_jj["state"])


def _freqs(kind, rng, n=300):
    if kind == "msi001":        # every MSi001 band, integer and fractional
        edges = [0, 4e6, 8e6, 16e6, 32e6, 75e6, 125e6, 142e6, 148e6, 300e6,
                 430e6, 440e6, 875e6, 2.0e9]
        lo = rng.integers(0, len(edges) - 1, n)
        f = [edges[k] + rng.random() * (edges[k + 1] - edges[k]) for k in lo]
        return f + [-5.0, 0.0, 146.52e6, 4e6, 875e6]
    ranges = {"hackrf_low": (1e6, 2150e6), "hackrf_bypass": (2150e6, 2750e6),
              "hackrf_high": (2750e6, 7250e6),
              "hackrf_out": (7250e6 + 1e6, 9e9)}
    a, b = ranges[kind]
    f = list(a + rng.random(n) * (b - a))
    return f + [np.floor(x) for x in f[:20]] + [a, b - 1.0]


@pytest.mark.parametrize("kind", ["msi001", "hackrf_low", "hackrf_bypass",
                                  "hackrf_high", "hackrf_out"])
def test_synthesizer_models(kind):
    rng = np.random.default_rng(SEED + 10 + len(kind))
    fn = "fcd_actual_frequency" if kind == "msi001" \
        else "hackrf_actual_frequency"
    for f in _freqs(kind, rng):
        got, want = getattr(fe_t, fn)(f), getattr(fe_j, fn)(f)
        assert got == want and type(got) is type(want), f
    for mhz in rng.integers(1, 5400, 200):
        assert fe_t.rffc5071_freq(int(mhz)) == fe_j.rffc5071_freq(int(mhz))
    for hz in rng.integers(0, 3_000_000_000, 200):
        assert fe_t.max2837_freq(int(hz)) == fe_j.max2837_freq(int(hz))


@pytest.mark.parametrize("agc", ["FuncubeAGC", "HackRFAGC"])
def test_hardware_agc_steps(agc):
    rng = np.random.default_rng(SEED + 20 + len(agc))
    at, aj = getattr(fe_t, agc)(), getattr(fe_j, agc)()
    # a wandering A/D power: long climbs and falls through both limits
    power = np.cumsum(rng.standard_normal(600) * 4.0) % 90.0 - 80.0
    for p in list(power) + [0.0, -200.0, 40.0, -15.0, -25.0, -50.0]:
        assert at.step(float(p)) == aj.step(float(p))
        assert (at.lna_gain, at.mixer_gain, at.if_gain) == \
            (aj.lna_gain, aj.mixer_gain, aj.if_gain)
        assert at.total_db == aj.total_db
        assert at.voltage_gain == aj.voltage_gain


# ---- apps/frontend ----

class _Sink:
    def __init__(self):
        self.sent = []

    def send(self, data):
        self.sent.append(bytes(data))


def _fixed_time(monkeypatch):
    """Both daemon modules read a frozen wall clock (SSRC, GPS time)."""
    fake = types.SimpleNamespace(time=lambda: 1.7e9 + 0.25,
                                 time_ns=lambda: 1_700_000_000_250_000_000,
                                 monotonic=_time.monotonic,
                                 sleep=_time.sleep)
    monkeypatch.setattr(fe_app_t, "time", fake)
    monkeypatch.setattr(fe_app_j, "time", fake)


def _recording(tmp_path, n_samples, seed):
    rng = np.random.default_rng(seed)
    path = str(tmp_path / f"fe-{seed}.iq")
    rng.integers(-9000, 9000, (n_samples, 2), dtype=np.int16).tofile(path)
    write_metadata(path, {"samplerate": "192000", "frequency": "146000000"})
    return path


def _daemons(argv):
    """The port's and the JAX daemon on their own groups, with their data
    and status sockets replaced by sinks."""
    out = []
    for mod, group in ((fe_app_t, GROUP_T), (fe_app_j, GROUP_J)):
        d = mod.FrontEndDaemon(mod.build_args(["-R", group] + argv))
        d.data_sock, d.status_sock = _Sink(), _Sink()
        out.append(d)
    return out


def _close(*daemons):
    for d in daemons:
        d.ctl_sock.close()
        if d._file is not None:
            d._file.close()


def _retune(d, f):
    pkt = bytearray([1])
    st_j.encode_double(pkt, st_j.StatusType.RADIO_FREQUENCY, f)
    st_j.encode_eol(pkt)
    d.handle_command(bytes(pkt))


@pytest.mark.parametrize("source,argv", [
    ("file", []),
    ("file", ["--decimate-log2", "2"]),
    ("noise", []),
    ("noise", ["--decimate-log2", "3", "--tuner", "hackrf"]),
])
def test_next_block(tmp_path, monkeypatch, source, argv):
    """Blocks from a recording (looped at its end) and from noise, through
    the half-band path and across a retune that shifts the spectrum."""
    _fixed_time(monkeypatch)
    if source == "file":
        argv = argv + ["--iq-file", _recording(tmp_path, 4000, SEED + 30)]
    dt, dj = _daemons(argv + ["-f", "146m"])
    try:
        assert dt.actual == dj.actual and dt.ssrc == dj.ssrc
        for b in range(12):
            if b == 5:
                for d in (dt, dj):
                    _retune(d, 146.0123e6)
            if b == 8:
                dt.agc.if_gain = dj.agc.if_gain = 10        # a gain step
            xt, xj = dt.next_block(), dj.next_block()
            assert xt.dtype == xj.dtype and len(xt) == 240
            np.testing.assert_array_equal(xt, xj)
        assert dt.shift_phase == dj.shift_phase != 0.0
        assert (dt.actual, dt.commands) == (dj.actual, dj.commands)
    finally:
        _close(dt, dj)


def test_handle_command_hostile():
    """Crafted TLV commands (tests/test_apps.py:931) leave both daemons
    alike and alive; good ones retune and recalibrate them alike."""
    dt, dj = _daemons([])
    try:
        T = st_j.StatusType
        cases = [(T.RADIO_FREQUENCY, math.nan), (T.RADIO_FREQUENCY, math.inf),
                 (T.RADIO_FREQUENCY, -1e12), (T.RADIO_FREQUENCY, 11e9),
                 (T.CALIBRATE, math.nan), (T.CALIBRATE, -1.0),
                 (T.CALIBRATE, 2.5e-6), (T.RADIO_FREQUENCY, 435.1234567e6),
                 (T.CALIBRATE, 0.0), (T.RADIO_FREQUENCY, 0.0)]
        for key, value in cases:
            pkt = bytearray([1])
            st_j.encode_double(pkt, key, value)
            st_j.encode_eol(pkt)
            for d in (dt, dj):
                d.handle_command(bytes(pkt))
            assert (dt.requested, dt.actual, dt.calibration, dt.commands) == \
                (dj.requested, dj.actual, dj.calibration, dj.commands)
        for junk in (b"", b"\x00\x01", b"\x01", b"\x01\xff\xff\xff",
                     bytes(range(40))):
            dt.handle_command(junk)
            dj.handle_command(junk)
        assert dt.commands == dj.commands == len(cases) + 2
    finally:
        _close(dt, dj)


def test_emit_status_and_run_packets(tmp_path, monkeypatch):
    """The 10 Hz status (AGC step included) after the same blocks, and the
    I/Q packets of a short paced run, byte-equal with the clock frozen."""
    _fixed_time(monkeypatch)
    rec = _recording(tmp_path, 2400, SEED + 40)
    dt, dj = _daemons(["--iq-file", rec, "-f", "145.5m"])
    try:
        for _ in range(6):
            for d in (dt, dj):
                d.corrector.process(d.next_block())
                d.emit_status()
        assert len(dt.status_sock.sent) == 6
        assert dt.status_sock.sent == dj.status_sock.sent
        dt.run(0.03)
        dj.run(0.03)
        n = min(len(dt.data_sock.sent), len(dj.data_sock.sent))
        assert n >= 10
        assert dt.data_sock.sent[:n] == dj.data_sock.sent[:n]
        assert dt.status_sock.sent[6] == dj.status_sock.sent[6]
    finally:
        _close(dt, dj)


def test_cli_flags():
    argv = ["-R", GROUP_T, "-f", "10m", "-r", "96000", "--decimate-log2",
            "4", "-T", "3", "--calibration", "1.5", "--tuner", "msi001",
            "--agc", "off", "--seconds", "2"]
    assert vars(fe_app_t.build_args(argv)) == vars(fe_app_j.build_args(argv))
