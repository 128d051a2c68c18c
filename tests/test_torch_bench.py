"""The port's benchmark runner (``ka9q_sdr_tpu_torch.bench``) against
``bench.py`` on the CPU.

Inputs: ``bench.py`` (loaded from the root of the repo with importlib) runs
its ``_measure`` and ``_measure_mixed`` with the JAX package's
``ChannelBank`` and ``MultiBank`` replaced by recorders, and the port's
runner runs its own with recorders over the port's banks on the CPU; each
recorder keeps the config, the frequencies, the block of every call and the
audio of the first blocks.  A JAX recorder runs its first REAL_BLOCKS
blocks through the real bank and hands back the last of them after that,
so the JAX side compiles one step per row.  The blocks (int16 and float32,
the scan's broadcast chunk too), the frequencies and the configs'
geometry must be equal.

Geometry: tests/test_torch_bank.py's, 8 channels at fs = 1.536 Msps,
L = 30720, M = 34817 (N = 65536, decimate 32, L_dec 960), warm-up 1 and 3
timed calls, 2 blocks a scan.

Outputs, both banks from their own fresh state on the same block:

- FM+PL audio: within 1e-5 x max(peak, 1), the bound
  tests/test_torch_bank.py holds the float state to (the FFTs differ at
  the float32 rounding level);
- CAM, and the mixed row's USB and CAM groups: the PARITY.md #9 bounds on
  int16 PCM (<= 8 LSB, difference RMS <= -85 dBFS) from the second block
  on; the first block from a cold start lets the AGC magnify the filter's
  rising edge, as tests/test_torch_bank_modes.py notes.

The runner itself under ``--cpu`` with tiny ``BENCH_*`` knobs: one stdout
JSON line with bench.py's four keys plus ``device`` and
``power_limit_w``, a stderr row for each enabled row, none with
``BENCH_CHANNELS=0``, exit 2 without a card, and the slope's guard against
too few timed calls.
"""

import importlib.util
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on its CPU backend, as conftest sets)

from ka9q_sdr_tpu.models import bank as JB
from ka9q_sdr_tpu_torch import bench as PB
from ka9q_sdr_tpu_torch.models import bank as TB

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FS, LW, M, B = 1.536e6, 30720, 34817, 8
WARMUP, ITERS, CHUNK = 1, 3, 2
REAL_BLOCKS = 3
MIXED = [("FM", 4), ("USB", 2), ("CAM", 2)]
CPU = torch.device("cpu")

#: bank rows: (mode, use_scan, config keywords), as bench.py's headline /
#: serving, CAM wide and CAM rows call _measure
ROWS = {
    "fm_k1": ("FM", False, {"enable_pl": True}),
    "fm_scan": ("FM", True, {"enable_pl": True}),
    "cam_k1": ("CAM", False, {}),
    "cam_scan": ("CAM", True, {}),
}


def _load_bench_py():
    spec = importlib.util.spec_from_file_location("bench_root",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Record:
    """One bank's config, frequencies, block and first outputs."""

    def __init__(self, cfg, freqs):
        self.cfg, self.freqs = cfg, list(freqs)
        self.block = self.scan_block = None
        self.outs = []            # audio (per group for a MultiBank)
        self.same = True          # every call got the first block

    def block_seen(self, x: np.ndarray) -> None:
        if self.block is None:
            self.block = x.copy()
        else:
            self.same = self.same and np.array_equal(x, self.block)

    def scan_seen(self, xs: np.ndarray) -> None:
        if self.scan_block is None:
            self.scan_block = xs.copy()
        else:
            self.same = self.same and np.array_equal(xs, self.scan_block)


def _jax_recorders(records):
    class Bank(JB.ChannelBank):
        def __init__(self, cfg, freqs, **kw):
            super().__init__(cfg, freqs, **kw)
            self.rec = _Record(cfg, freqs)
            records.append(self.rec)
            self.last = None

        def process_i16(self, x_i16):
            self.rec.block_seen(np.asarray(x_i16))
            if len(self.rec.outs) < REAL_BLOCKS:
                audio, diag = super().process_i16(x_i16)
                self.rec.outs.append(np.asarray(audio))
                self.last = (np.asarray(audio), diag)
            else:
                time.sleep(1e-3)          # keeps the slope's t_hi > t_lo
            return self.last

        def process_scan_i16(self, x_i16_blocks, pcm_out=False):
            xs = np.asarray(x_i16_blocks)
            self.rec.scan_seen(xs)
            time.sleep(1e-3)
            return np.broadcast_to(self.last[0],
                                   (len(xs),) + self.last[0].shape)

    class Multi(JB.MultiBank):
        def __init__(self, groups, **kw):
            super().__init__(groups, **kw)
            self.rec = _Record(self.cfgs, [list(f) for _, f in groups])
            self.rec.modes = [m for m, _ in groups]
            records.append(self.rec)
            real = self._step
            self.last = None

            def step(states, x):
                self.rec.block_seen(np.asarray(x))
                if len(self.rec.outs) < REAL_BLOCKS:
                    states, outs = real(states, x)
                    self.rec.outs.append([np.asarray(a) for a, _ in outs])
                    self.last = outs
                else:
                    time.sleep(1e-3)
                return states, self.last

            self._step = step

    return Bank, Multi


def _port_recorders(records):
    class Bank(TB.ChannelBank):
        def __init__(self, cfg, freqs, **kw):
            super().__init__(cfg, freqs, **kw)
            self.rec = _Record(cfg, freqs)
            records.append(self.rec)

        def process_i16(self, x_i16):
            self.rec.block_seen(x_i16.numpy())
            out = super().process_i16(x_i16)
            if len(self.rec.outs) < REAL_BLOCKS:
                self.rec.outs.append(out[0].numpy())
            return out

        def process_scan_i16(self, x_i16_blocks, pcm_out=False):
            self.rec.scan_seen(x_i16_blocks.numpy())
            return super().process_scan_i16(x_i16_blocks, pcm_out)

    class Multi(TB.MultiBank):
        def __init__(self, groups, **kw):
            super().__init__(groups, **kw)
            self.rec = _Record(self.cfgs, [list(f) for _, f in groups])
            self.rec.modes = [m for m, _ in groups]
            records.append(self.rec)

        def process(self, iq_block):
            self.rec.block_seen(iq_block.numpy())
            outs = super().process(iq_block)
            if len(self.rec.outs) < REAL_BLOCKS:
                self.rec.outs.append([a.numpy() for a, _ in outs])
            return outs

    return Bank, Multi


@pytest.fixture(scope="module")
def recorded():
    """{row: (JAX record, port record)} for every bank row and "mixed"."""
    jbench = _load_bench_py()
    jrec, prec = [], []
    jbank, jmulti = _jax_recorders(jrec)
    pbank, pmulti = _port_recorders(prec)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BENCH_CHUNK", str(CHUNK))
        # bench.py's persistent compile cache lives in the home directory
        mp.setattr("ka9q_sdr_tpu.utils.runtime.configure_jax",
                   lambda *a, **k: None)
        mp.setattr(JB, "ChannelBank", jbank)
        mp.setattr(JB, "MultiBank", jmulti)
        mp.setattr(PB, "ChannelBank", pbank)
        mp.setattr(PB, "MultiBank", pmulti)
        for row, (mode, use_scan, kw) in ROWS.items():
            jbench._measure(mode, B, FS, LW, M, WARMUP, ITERS,
                            use_scan=use_scan, **kw)
            PB._measure(CPU, mode, B, FS, LW, M, WARMUP, ITERS,
                        use_scan=use_scan, **kw)
            out[row] = (jrec.pop(), prec.pop())
        sps_j, tot_j = jbench._measure_mixed(MIXED, FS, LW, M, WARMUP, ITERS)
        sps_p, tot_p = PB._measure_mixed(CPU, MIXED, FS, LW, M, WARMUP,
                                         ITERS)
        assert tot_j == tot_p == B and sps_p > 0
        out["mixed"] = (jrec.pop(), prec.pop())
    assert not jrec and not prec
    return out


def _geometry(cfg):
    return (cfg.samprate, cfg.master.L, cfg.master.M, cfg.N, cfg.decimate,
            cfg.N_dec, cfg.L_dec, cfg.n_channels, cfg.mode.name,
            cfg.mode.demod, cfg.kaiser_beta,
            getattr(cfg.demod_cfg, "pl_slave", None) is None)


def _assert_same_config(jc, tc):
    assert _geometry(tc) == _geometry(jc)
    np.testing.assert_array_equal(tc.response, np.asarray(jc.response))
    np.testing.assert_array_equal(np.asarray(tc.base_idx),
                                  np.asarray(jc.base_idx))


@pytest.mark.parametrize("row", list(ROWS) + ["mixed"])
def test_inputs_equal_bench_py(recorded, row):
    """The port's block, frequencies and config are bench.py's, bit for
    bit; every call of the row got the same block."""
    j, p = recorded[row]
    assert j.same and p.same
    assert p.block.dtype == j.block.dtype
    assert p.block.dtype == (np.float32 if row == "mixed" else np.int16)
    np.testing.assert_array_equal(p.block, j.block)
    assert p.freqs == j.freqs
    if row == "mixed":
        assert p.modes == j.modes == [m for m, _ in MIXED]
        for jc, tc in zip(j.cfg, p.cfg):
            _assert_same_config(jc, tc)
    else:
        _assert_same_config(j.cfg, p.cfg)
    if ROWS.get(row, (None, False))[1]:
        assert p.scan_block.shape == (CHUNK, LW, 2)
        np.testing.assert_array_equal(p.scan_block, j.scan_block)
        np.testing.assert_array_equal(p.scan_block[1], p.block)


def test_input_functions_are_the_runner_blocks(recorded):
    """bench_inputs / mixed_inputs, called alone, give what the rows ran."""
    _, p = recorded["fm_k1"]
    freqs, x = PB.bench_inputs(B, FS, LW)
    assert freqs == p.freqs
    np.testing.assert_array_equal(x, p.block)
    _, p = recorded["mixed"]
    groups, x = PB.mixed_inputs(MIXED, FS, LW)
    assert [f for _, f in groups] == p.freqs
    np.testing.assert_array_equal(x, p.block)


def _fm_close(t, j):
    assert t.shape == j.shape and t.dtype == j.dtype == np.float32
    np.testing.assert_allclose(t, j, rtol=0,
                               atol=1e-5 * max(np.abs(j).max(), 1))


def _pcm(a):
    return np.clip(np.asarray(a) * 32767.0, -32768, 32767).astype(np.int16)


def _pcm_close(t, j):
    """PARITY.md #9 on int16 PCM: <= 8 LSB, difference RMS <= -85 dBFS."""
    assert t.shape == j.shape
    d = _pcm(t).astype(np.int64) - _pcm(j).astype(np.int64)
    assert np.abs(d).max() <= 8, np.abs(d).max()
    rms = np.sqrt(np.mean(d.astype(np.float64) ** 2)) / 32768.0
    assert rms <= 10 ** (-85 / 20), rms


@pytest.mark.parametrize("row", ["fm_k1", "fm_scan"])
def test_fm_first_block_matches_jax(recorded, row):
    j, p = recorded[row]
    _fm_close(p.outs[0], j.outs[0])
    assert np.abs(j.outs[0]).max() > 0.01       # the carriers demodulate


def test_fm_blocks_match_jax(recorded):
    """Stepping one block after another (the headline's calls)."""
    j, p = recorded["fm_k1"]
    assert len(j.outs) == len(p.outs) == REAL_BLOCKS
    for t, a in zip(p.outs, j.outs):
        _fm_close(t, a)


def test_cam_matches_jax_from_second_block(recorded):
    j, p = recorded["cam_k1"]
    assert len(j.outs) == len(p.outs) == REAL_BLOCKS
    assert p.outs[0].shape == j.outs[0].shape == (B, 960)
    for t, a in zip(p.outs[1:], j.outs[1:]):
        _pcm_close(t, a)


def test_mixed_groups_match_jax(recorded):
    """FM group within the FM bound from the first block; USB and CAM
    groups within PARITY.md #9 from the second."""
    j, p = recorded["mixed"]
    assert len(j.outs) == len(p.outs) == REAL_BLOCKS
    for b, (tg, jg) in enumerate(zip(p.outs, j.outs)):
        _fm_close(tg[0], jg[0])
        for t, a in zip(tg[1:], jg[1:]):
            assert t.shape == a.shape
            if b > 0:
                _pcm_close(t, a)


#: tiny knobs that enable every row the CPU runs in seconds (the scaling
#: row's 2048 channels and the wide CAM row's 393 Msps geometry are fixed
#: by bench.py, so they are switched off)
TINY = {
    "BENCH_CHANNELS": "8", "BENCH_SAMPRATE": "1536000", "BENCH_L": "227328",
    "BENCH_M": "34817", "BENCH_WARMUP": "1", "BENCH_ITERS": "3",
    "BENCH_REF_L": "30720", "BENCH_SERVE_CHANNELS": "8,4", "BENCH_CHUNK": "2",
    "BENCH_FRONTIER": "1", "BENCH_SCALING": "0", "BENCH_MIXED": "FM:4,USB:2,CAM:2",
    "BENCH_PLL_CHANNELS": "8", "BENCH_PLL_SAMPRATE": "1536000",
    "BENCH_PLL_L": "30720", "BENCH_PLL_M": "34817",
    "BENCH_PLL_WIDE_CHANNELS": "0", "BENCH_DEADLINE_S": "600",
}


def _run_main(monkeypatch, capsys, argv=("--cpu",), **env):
    for k, v in {**TINY, **env}.items():
        monkeypatch.setenv(k, v)
    rc = PB.main(list(argv))
    out, err = capsys.readouterr()
    return rc, out, err


def test_runner_prints_one_result_line(monkeypatch, capsys):
    rc, out, err = _run_main(monkeypatch, capsys)
    assert rc == 0
    lines = out.splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert set(res) == {"metric", "value", "unit", "vs_baseline", "device",
                        "power_limit_w"}
    assert res["metric"] == "channels_x_Msps_demodulated_per_chip"
    assert res["unit"] == "ch*Msps" and res["value"] > 0
    assert res["vs_baseline"] == round(res["value"] / 0.192, 1)
    assert res["device"] == "cpu" and res["power_limit_w"] is None
    rows = [ln for ln in err.splitlines() if not ln.startswith("#  ")
            and not ln.startswith("# measuring")]
    want = ["# FM+PL 8 ch x 1.536 Msps bank (long blocks, L=227328): ",
            "# FM+PL 8 ch x 1.536 Msps bank (20 ms blocks, serving cadence)",
            "# FM+PL 4 ch x 1.536 Msps bank (20 ms blocks, serving cadence)",
            "# frontier 20 ms k=1 (no scan chunking): ",
            "# frontier 62.7 ms (L_dec=3008): ",
            "# MultiBank FM 4+USB 2+CAM 2 x 1.536 Msps (20 ms blocks, ",
            "# CAM(PLL) 8 ch x 1.536 Msps bank: "]
    assert len(rows) == len(want), err
    for ln, w in zip(rows, want):
        assert ln.startswith(w), (ln, w)
    assert "round-trip p50" in rows[0] and "round-trip p50" in rows[-1]
    measuring = [ln for ln in err.splitlines() if ln.startswith("# measuring")]
    extras = [ln for ln in err.splitlines() if ln.startswith("#   row: slope ")]
    assert len(measuring) == len(extras) == len(want)
    for ln in extras:
        assert "CUDA events not measured (cpu)" in ln
        assert "launches ffill +0 agc +0" in ln       # plain versions on CPU


def test_runner_without_headline_prints_no_line(monkeypatch, capsys):
    rc, out, err = _run_main(monkeypatch, capsys, BENCH_CHANNELS="0",
                             BENCH_SERVE_CHANNELS="4", BENCH_MIXED="0",
                             BENCH_PLL_CHANNELS="0")
    assert rc == 0 and out == ""
    assert "# FM+PL 4 ch x 1.536 Msps bank (20 ms blocks" in err
    assert "long blocks" not in err and "frontier" not in err


def test_runner_needs_a_card_without_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        _run_main(monkeypatch, capsys, argv=())
    assert e.value.code == 2
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA device" in err


@pytest.mark.parametrize("iters", [0, 1, 2])
def test_runner_rejects_too_few_timed_calls(monkeypatch, capsys, iters):
    with pytest.raises(ValueError):
        PB.slope_lo_iters(iters)
    rc, out, err = _run_main(monkeypatch, capsys, BENCH_ITERS=str(iters))
    assert rc == 2 and out == ""
    assert f"BENCH_ITERS={iters}" in err and "# measuring" not in err


def test_slope_short_run_is_bench_py_s():
    for iters in range(3, 200):
        lo = PB.slope_lo_iters(iters)
        assert lo == max(2, iters // 8) and iters - lo > 0


def test_watchdog_starts_and_is_cancelled(monkeypatch):
    monkeypatch.setenv("BENCH_DEADLINE_S", "0")
    assert PB._watchdog() is None
    monkeypatch.setenv("BENCH_DEADLINE_S", "1000")
    t = PB._watchdog()
    assert isinstance(t, threading.Timer) and t.daemon and t.is_alive()
    t.cancel()
    t.join(5)
    assert not t.is_alive()
