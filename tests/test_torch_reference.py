"""The runner's rows against reference outputs made by the JAX package, and
the script that makes them.

``ka9q_sdr_tpu_torch/tools/reference.py`` defines the rows (R1-R9, the
rows of ``python -m ka9q_sdr_tpu_torch.bench`` at its defaults; M1, R2
with its carriers FM-modulated; E1, every bank mode the runner never runs
in one MultiBank; S1, README's 4-shard ``shard_fft`` deployment), what a
reference file holds and the bounds a run of the port is held to; its
module docstring states them.  This file holds the JAX side:

- run as a script it writes the files, one process a row so that each
  row's peak memory is its own::

    JAX_PLATFORMS=cpu python tests/test_torch_reference.py --write R5

  (each row through the JAX package's ``ChannelBank.process_i16_pcm`` or
  ``MultiBank.process`` on its CPU backend, K blocks of the row's one
  input block from a fresh bank; a mesh row on a mesh of JAX's CPU
  devices, which the script makes 4 before JAX is imported, and its
  active call's K blocks from a second fresh bank; a modulated row's
  measured PL tones, and a row's carriers' audio tones where they carry a
  mode's signal, are checked against what the input was built to give
  before its file is written);
- as tests: the files exist and their geometry is the runner's rows (the
  runner's own ``_run`` with its row functions recorded), M1's is R2's
  and its measured tones are its PL tones, E1's tones are its modes'
  and S1's active sets hold no padding row; M1's input is R2's noise with
  carriers that do not step at the block's end, E1's every frequency on
  the 50 Hz grid; the input hashes of R2, R4-R7, R9, M1, E1 and S1 match
  inputs made here (R1's and R8's long blocks take 17-19 s each, so only
  ``slow`` and the card check them); R5 through the port on the CPU
  within the bounds; small geometries (N = 8192, 16 channels, as
  tests/test_torch_bankd.py; a modulated FM+PL row at N = 16384 whose PL
  FFT fires; a MultiBank of five modes with stereo groups at N = 65536;
  14 FM channels on a 4-shard ``shard_fft`` mesh, padded to 16) through
  this generator with JAX and the comparator with the port, so the
  machinery and the PL tone's, the audio tone's and the active set's
  bounds are held against JAX on every run; and, marked ``slow``, R1-R4,
  R6-R9, M1, E1 and S1 through the port on the CPU.
"""

from __future__ import annotations

import functools
import os
import resource
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    # S1's 4-shard mesh: JAX's CPU backend as 4 devices, as
    # tests/conftest.py makes 8 for the tests
    if "xla_force_host_platform_device_count" not in os.environ.get(
            "XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla"
                                   "_force_host_platform_device_count=4"
                                   ).strip()
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ka9q_sdr_tpu.models import bank as JB  # noqa: E402
from ka9q_sdr_tpu_torch import bench as PB  # noqa: E402
from ka9q_sdr_tpu_torch.tools import reference as R  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
#: the small geometry of tests/test_torch_bankd.py: N = 8192, L_dec 120
SMALL = dict(samprate=1.536e6, L=3840, M=4353)
SMALL_ROWS = {r.name: r for r in (
    R.Row("S-FM", "FM+PL 16 ch", **SMALL, K=40, mode="FM", n_channels=16,
          cfg=(("enable_pl", True),), calls=("step", "scan")),
    R.Row("S-CAM", "CAM 16 ch", **SMALL, K=40, mode="CAM", n_channels=16,
          calls=("step", "scan")),
    R.Row("S-MIX", "MultiBank FM:8 + USB:4 + CAM:4", **SMALL, K=12,
          groups=(("FM", 8), ("USB", 4), ("CAM", 4))),
    # M1's tones at N = 16384 (L_dec 960, as at 20 ms): the PL FFT fires
    # after block 17
    R.Row("S-FMM", "FM+PL 16 ch, carriers FM-modulated", samprate=384e3,
          L=7680, M=8705, K=20, mode="FM", n_channels=16,
          cfg=(("enable_pl", True),), calls=("step", "scan"),
          tones=R.M1_TONES),
    # E1's machinery: five modes, two of them stereo, each carrier its
    # mode's signal, at N = 65536 (a 20 ms block: the 50 Hz grid), the
    # carriers' PCM in 4 of the 10 blocks
    R.Row("S-MODES", "MultiBank AM:2 + DSB:2 + ISB:2 + IQ:2 + FMF:2",
          samprate=1.536e6, L=30720, M=34817, K=10,
          groups=(("AM", 2), ("DSB", 2), ("ISB", 2), ("IQ", 2), ("FMF", 2)),
          signals=True, kept="carriers", pcm_blocks=(0, 1, 8, 9)),
    # S1's: 14 FM channels padded to 16 on 4 shard_fft shards, all 16
    # slots active so that the padding rows reach the top-k
    R.Row("S-MESH", "FM 14 ch on a 4-shard shard_fft mesh", **SMALL, K=12,
          mode="FM", n_channels=14, calls=("step", "scan", "active"),
          mesh=(4, True), max_active=16),
)}
#: the runner's rows (a row with tones, mode signals or a mesh is none)
RUNNER_ROWS = [n for n, r in R.ROWS.items()
               if not (r.tones or r.signals or r.mesh)]


def generate(row: R.Row, freqs=None, x=None) -> dict:
    """The row through the JAX package on its CPU backend: K blocks of the
    row's input, one a call, from a fresh bank (a row with an active call:
    a second fresh bank's K ``process_active`` calls too, as the keys
    ``active.*``).  Returns the record's arrays (``reference.Record``)."""
    if x is None:
        freqs, x = R.row_input(row)
    if row.groups:
        rec = R.Record(row)
        mb = JB.MultiBank(list(freqs), samprate=row.samprate, L=row.L,
                          M=row.M, **dict(row.cfg))
        for _ in range(row.K):
            rec.add_groups(mb.process(x))
        arrays = rec.arrays(mb.states)
    else:
        arrays = _bank_run(row, freqs, x, "step")
        if "active" in row.calls:
            arrays.update({f"active.{k}": v for k, v in
                           _bank_run(row, freqs, x, "active").items()})
    if row.tones:       # the input exercises the PL chain, or no file
        print(f"{row.name}: measured PL tones "
              f"{R.check_pl_tones(row, arrays)}", flush=True)
    if row.signals:     # each carrier gives its mode's tone, or no file
        print(f"{row.name}: carriers' audio tones "
              f"{R.check_tones(row, arrays)}", flush=True)
    return arrays


def _bank_run(row: R.Row, freqs, x, call: str) -> dict:
    """K blocks through a fresh JAX ChannelBank (a mesh row: on the first
    of JAX's CPU devices, its frequencies padded as bankd pads them):
    ``process_i16_pcm``, or ``process_active`` for the call "active"."""
    mesh, shard_fft, n_valid = None, False, None
    if row.mesh:
        from ka9q_sdr_tpu.parallel.mesh import make_channel_mesh, \
            pad_channels

        n, shard_fft = row.mesh
        if len(jax.devices()) < n:
            raise RuntimeError(f"{row.name} needs {n} JAX devices: set "
                               "XLA_FLAGS=--xla_force_host_platform_device_"
                               f"count={n} before JAX is imported")
        mesh = make_channel_mesh(n)
        freqs = pad_channels(freqs, n)
        if len(freqs) != row.total:
            n_valid = row.total
    cfg = JB.make_bank_config(len(freqs), row.mode, samprate=row.samprate,
                              L=row.L, M=row.M, **dict(row.cfg))
    bank = JB.ChannelBank(cfg, freqs, mesh=mesh, shard_fft=shard_fft)
    rec = R.Record(row)
    for _ in range(row.K):
        if call == "active":
            rec.add_active(*bank.process_active(x, row.max_active,
                                                n_valid=n_valid))
        else:
            rec.add_diag(*bank.process_i16_pcm(x))
    return rec.arrays([bank.state])


def write(name: str) -> None:
    """Make one row's reference file and print its wall time and the
    process's peak memory."""
    row = R.ROWS[name]
    t0 = time.perf_counter()
    freqs, x = R.row_input(row)
    sha = R.input_sha256(x)
    t_in = time.perf_counter() - t0
    arrays = generate(row, freqs, x)
    wall = time.perf_counter() - t0
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    R.REF_DIR.mkdir(parents=True, exist_ok=True)
    path = R.REF_DIR / f"{name}.npz"
    R.save(path, arrays, sha, {
        "row": name, "label": row.label, "geometry": row.geometry(),
        "K": row.K, "jax": jax.__version__, "numpy": np.__version__,
        "command": f"JAX_PLATFORMS=cpu python tests/test_torch_reference.py"
                   f" --write {name}"})
    print(f"{name}: {path.stat().st_size} B, input {t_in:.1f} s, wall "
          f"{wall:.1f} s, peak RSS {peak:.2f} GiB", flush=True)


# --- tests ------------------------------------------------------------------

def _runner_rows(monkeypatch) -> list:
    """The rows the runner's ``_run`` measures at its defaults, as
    (mode or groups, channels, samprate, L, M, config keywords)."""
    for k in list(os.environ):
        if k.startswith("BENCH_"):
            monkeypatch.delenv(k)
    seen = []

    def measure(dev, mode, n, fs, L, M, warmup, iters, use_scan=True,
                measure_latency=True, **kw):
        seen.append((mode, n, fs, L, M, kw))
        return 1.0, float("nan"), float("nan")

    def measure_mixed(dev, spec, fs, L, M, warmup, iters):
        seen.append((tuple(tuple(s) for s in spec),
                     sum(n for _, n in spec), fs, L, M, {}))
        return 1.0, sum(n for _, n in spec)

    monkeypatch.setattr(PB, "_measure", measure)
    monkeypatch.setattr(PB, "_measure_mixed", measure_mixed)
    monkeypatch.setattr(PB, "_device_facts", lambda dev: ("cpu", None))
    assert PB._run(CPU) == 0
    return seen


@pytest.mark.parametrize("name", RUNNER_ROWS)
def test_reference_file_is_a_runner_row(name, monkeypatch):
    """The file exists, was made from the row's geometry and K by the JAX
    package, and the row is one the runner measures at its defaults."""
    row = R.ROWS[name]
    ref = R.load(name)
    meta = ref["meta"]
    assert meta["geometry"] == row.geometry() and meta["K"] == row.K
    assert meta["jax"] and "--write" in meta["command"]
    want = (row.groups or row.mode, row.total, row.samprate, row.L, row.M,
            dict(row.cfg))
    assert want in _runner_rows(monkeypatch)
    K, B = row.K, row.total
    assert ref["rms"].shape == (K, B) and ref["flags"].shape == (K, B)
    assert ref["flagged"].all()
    assert np.array_equal(ref["kept"], R.kept_channels(row))
    first = R.first_bound(row)
    assert np.array_equal(ref["first_pcm"], first[0])
    assert np.array_equal(ref["first_rms"], first[1])
    assert set(R.carrier_channels(row)) <= set(ref["kept"].tolist())
    assert ref["pcm"].shape[:2] == (K, len(ref["kept"]))
    assert ref["pcm"].dtype == np.int16
    _pl_recorded(row, ref)


def _pl_recorded(row, ref):
    """Where the bank measures PL tones the file records them (R1 and R2
    were made before the record held them), at the row's bin width."""
    pl = dict(row.cfg).get("enable_pl", False) and row.name not in (
        "R1", "R2")
    assert ("plfreq_end" in ref) == pl
    if pl:
        assert ref["plfreq"].shape == (row.K, len(ref["kept"]))
        assert ref["plfreq_end"].shape == (len(ref["kept"]),)
        assert float(ref["pl_bin"]) == R.pl_bin(row) == 1500.0 / 16384


def test_modulated_reference_file():
    """M1's file: made by the JAX package from M1's geometry and K, and in
    it each carrier's measured PL tone is within 1 Hz of the tone that
    modulates it after both firings (blocks 17 and 35) and at the end."""
    row = R.ROWS["M1"]
    ref = R.load("M1")
    assert ref["meta"]["geometry"] == row.geometry()
    assert ref["meta"]["K"] == row.K == 36
    assert "--write M1" in ref["meta"]["command"]
    assert ref["flagged"].all() and ref["rms"].shape == (36, 4096)
    assert np.array_equal(ref["kept"], R.kept_channels(row))
    assert np.array_equal(ref["first_pcm"], R.first_bound(row)[0])
    _pl_recorded(row, ref)
    assert R.pl_firings(row) == [17, 35]
    R.check_pl_tones(row, ref)
    car = [list(ref["kept"]).index(c) for c in ref["carriers"]]
    assert np.all(np.abs(ref["plfreq_end"][car] - [100, 150, 200]) <= 1.0)
    assert np.isnan(ref["plfreq"][:17, car]).all()


@pytest.mark.parametrize("name,lag", [("R1", 1), ("R2", 2), ("R3", 2),
                                      ("R4", 2), ("R5", 2), ("R6", 2),
                                      ("R7", 2), ("R8", 1), ("R9", 2),
                                      ("M1", 2), ("E1", 2), ("S1", 2)])
def test_first_bound_follows_the_audio_filter(name, lag):
    """An FM carrier's audio is bound from block 0, an AGC carrier's PCM
    from block 1 and its RMS from block 0, a noise channel's from block 1,
    an FM noise channel's lag = ceil((M_dec - 1) / L_dec) blocks later
    (FM: every mode of the FM demodulator, FMF too)."""
    row = R.ROWS[name]
    pcm, rms = R.first_bound(row)
    modes = [m for m, n in row.groups for _ in range(n)] or \
        [row.mode] * row.n_channels
    car = set(R.carrier_channels(row))
    for c in sorted(car) + [0, row.total - 1]:
        fm = modes[c] in ("FM", "FMF")
        want = ((0 if fm else 1), 0) if c in car else \
            ((1 + lag, 1 + lag) if fm else (1, 1))
        assert (pcm[c], rms[c]) == want, c


def test_first_bound_holds_fmf_as_fm():
    """FMF (FM without de-emphasis) is the FM demodulator: its carrier's
    audio is bound from block 0 and its noise channels' 1 + lag blocks
    on, as FM's, where an AGC mode's carrier PCM waits for block 1."""
    row = R.Row("F", "FMF and USB", 393.216e6, 7864320, 8912897, 4,
                groups=(("FMF", 8), ("USB", 8), ("FM", 8)))
    pcm, rms = R.first_bound(row)
    assert (pcm[4], rms[4], pcm[0], rms[0]) == (0, 0, 3, 3)
    assert (pcm[12], rms[12], pcm[8], rms[8]) == (1, 0, 1, 1)
    assert np.array_equal(pcm[:8], pcm[16:]) and np.array_equal(rms[:8],
                                                                rms[16:])



def test_mode_reference_file():
    """E1's file: made by the JAX package from E1's groups and K; every
    carrier's audio tone in each ear within one bin of its mode's (the
    writer's gate, held again here), the PCM of the carriers alone in
    blocks 0-3 and 32-35, both ears of the stereo modes (CISB, ISB, IQ),
    a flag a block for every channel, and the PLL groups' integer state
    past the first acquisition."""
    row = R.ROWS["E1"]
    ref = R.load("E1")
    assert ref["meta"]["geometry"] == row.geometry()
    assert ref["meta"]["K"] == row.K == 36 and row.total == 3328
    assert "--write E1" in ref["meta"]["command"]
    assert ref["flagged"].all() and ref["rms"].shape == (36, 3328)
    assert np.array_equal(ref["kept"], R.carrier_channels(row))
    assert ref["pcm_blocks"].tolist() == [0, 1, 2, 3, 32, 33, 34, 35]
    stereo = [m in ("CISB", "ISB", "IQ") for m, _ in row.groups]
    assert ref["ears"].tolist() == [2 if s else 1 for s in stereo]
    assert ref["pcm"].shape == (8, 13, 960) and ref["pcm"].dtype == np.int16
    assert float(ref["tone_bin"]) == R.tone_bin(row) == 6.25
    R.check_tones(row, ref)
    assert np.array_equal(ref["first_pcm"], R.first_bound(row)[0])
    assert np.array_equal(ref["last_bound"], R.last_bound(row))
    # the PLL groups (AME, DSB, CISB: groups 1-3) searched inside the row
    for g in (1, 2, 3):
        assert (ref[f"state.g{g}.demod.fft_samples"] < 36 * 60).all()


def test_mesh_reference_file():
    """S1's file: made by the JAX package on a 4-device mesh with the
    distributed master FFT, 4094 channels (README's bankd line), the
    state of all 4096 rows with the padding; its active run's sets hold
    no padding row and at most 64 channels, and once the noise channels'
    squelch has shut they are the carriers."""
    row = R.ROWS["S1"]
    ref = R.load("S1")
    geo = ref["meta"]["geometry"]
    assert geo == row.geometry() and geo["mesh"] == [4, True]
    assert ref["meta"]["K"] == row.K == 24 and row.total == 4094
    assert ref["rms"].shape == (24, 4094)
    assert ref["state.g0.k"].shape == (4096,)
    idx = ref["active.idx"]
    assert idx.shape == (24, 64) and idx.max() < 4094
    assert ref["active.rms"].shape == (24, 4094)
    assert set(idx[-1][idx[-1] >= 0].tolist()) <= set(
        R.carrier_channels(row))


def test_last_bound_ends_the_hang_agc_noise_channels():
    """The audio domain ends at block hangmax // L_dec = 10 on the noise
    channels of CWU and CWL (0.2 s of hang, 10 blocks at 20 ms) and
    nowhere else: not on their carriers, not where the hang outlasts the
    row (USB's 1.1 s), not without a hang (AM, AME, CAM) or an AGC (FM)."""
    row = R.ROWS["E1"]
    last = R.last_bound(row)
    modes = [m for m, n in row.groups for _ in range(n)]
    car = set(R.carrier_channels(row))
    for c, m in enumerate(modes):
        cw = m in ("CWU", "CWL") and c not in car
        assert last[c] == (10 if cw else 35), (c, m)
    for name in ("R3", "R4", "R9", "S1"):
        assert (R.last_bound(R.ROWS[name]) == R.ROWS[name].K - 1).all()


def test_cw_hang_tie_is_the_inputs():
    """Why the domain ends (tools/reference.py): 32 CWU channels fed one
    block repeated, the port against itself with its master FFT taken by
    fft_fourstep (another exact float32 FFT): the AGC's hang counts part
    from block 2 (each block's peak re-clamps on an exact tie that
    rounding decides) while the audio RMS stays within 0.1 dB through
    block 10, and from block 11, where the hangs end apart, it parts by
    more than the bound on some channels: no package is needed for it."""
    from ka9q_sdr_tpu_torch.models import bank as TB
    from ka9q_sdr_tpu_torch.ops.fftfilt import fft_fourstep

    row = R.Row("C", "CWU 32 ch", 1.536e6, 30720, 34817, 16,
                groups=(("CWU", 32),), signals=True, kept="carriers")
    groups, x = R.row_input(row)
    freqs = groups[0][1]
    xc = torch.as_tensor((x[:, 0] + 1j * x[:, 1]).astype(np.complex64))
    cfg = TB.make_bank_config(32, "CWU", samprate=row.samprate, L=row.L,
                              M=row.M)

    def run(fft):
        def master(spec, overlap, block, stage=None):
            buf = torch.cat([overlap, block], dim=-1)
            return buf[..., spec.L:], fft(buf)

        orig, TB.master_execute = TB.master_execute, master
        try:
            bank = TB.ChannelBank(cfg, freqs, device="cpu")
            hang, rms = [], []
            for _ in range(row.K):
                a, _ = bank.process(xc)
                hang.append(bank.state.demod.agc.hangcount.numpy().copy())
                rms.append(R._rms(a.numpy()))
        finally:
            TB.master_execute = orig
        return np.stack(hang), np.stack(rms)

    h0, r0 = run(lambda b: torch.fft.fft(b, dim=-1))
    h1, r1 = run(fft_fourstep)
    db = np.abs(20 * np.log10(r1 / r0))
    assert (h0[2:] != h1[2:]).any(axis=1).all()
    last = R.last_bound(row)
    noise = last < row.K - 1
    assert noise.sum() == 31 and set(last[noise]) == {10}
    assert db[1:11].max() <= R.RMS_DB
    assert db[11:, noise].max() > R.RMS_DB


def test_reference_files_are_small():
    """At most 4 MB for every file under data/reference/ together, each
    row's among them."""
    files = sorted(R.REF_DIR.glob("*.npz"))
    assert {f.stem for f in files} >= set(R.ROWS)
    total = sum(f.stat().st_size for f in files)
    assert total <= 4_000_000, total


@pytest.mark.parametrize("name", ["R2", "R4", "R5", "R6", "R7", "R9", "M1",
                                  "E1", "S1"])
def test_reference_input_hash(name):
    """The input made here is the one the reference was made from."""
    R.check_input(R.ROWS[name], R.load(name), _input(name)[1])


@functools.cache
def _input(name):
    return R.row_input(R.ROWS[name])


def test_m1_input_is_r2s_noise_with_modulated_carriers():
    """M1 is R2's geometry and channels; its noise is R2's bit for bit
    (R2's input is that noise plus bench_inputs' carriers); each carrier's
    phase is the closed-form integral of its instantaneous frequency and
    makes whole cycles in a block, so the block repeated does not step."""
    m1, r2 = R.ROWS["M1"], R.ROWS["R2"]
    assert m1.geometry() == r2.geometry() and m1.calls == r2.calls
    assert len(m1.tones) == len(R.carrier_channels(m1)) == 3
    f2, x2 = R.row_input(r2)
    y = R.bench_noise(r2.L)
    tt = np.arange(r2.L) / r2.samprate
    for ch in (3, 2048, 4091):
        y += 0.2 * np.exp(2j * np.pi * f2[ch] * tt)
    assert np.array_equal(R.quantise_i16(y), x2)
    fs, L = int(m1.samprate), m1.L
    n = L - 64 + np.arange(129)         # across the end of the block
    for ch, (fa, da, fp, dp) in zip(R.carrier_channels(m1), m1.tones):
        ph = R.fm_phase(f2[ch], (fa, da, fp, dp), n, fs, L)
        assert np.array_equal(ph, R.fm_phase(f2[ch], (fa, da, fp, dp),
                                             n + 3 * L, fs, L))
        assert np.array_equal(ph[64:], R.fm_phase(
            f2[ch], (fa, da, fp, dp), np.arange(65), fs, L))
        # each step, the one from sample L - 1 to the next block's sample 0
        # too, advances by the instantaneous frequency
        t = n[:-1] / fs
        inst = f2[ch] + da * np.cos(2 * np.pi * fa * t) + dp * np.cos(
            2 * np.pi * fp * t)
        step = np.diff(ph)
        want = 2 * np.pi * inst / fs
        assert np.allclose(np.angle(np.exp(1j * (step - want))), 0,
                           atol=1e-6)
    with pytest.raises(ValueError, match="no whole number of cycles"):
        R.fm_phase(f2[3], (1025, 3000, 100, 500), n, fs, L)


def test_e1_input_is_on_the_grid():
    """E1's channels lie on bench.py's span rounded to 50 Hz (a 20 ms
    block's whole cycles), each group's carrier on its middle channel;
    the block is bench_inputs' noise and each mode's signal parts, so
    that with the noise taken away the spectrum holds the AM carrier and
    its two 1 kHz sidebands at their amplitudes, and otherwise lines only
    at the other carriers' parts (FMF's: 1 kHz apart up to the sixth,
    0.2 J_6(3) = 0.0023) and float32 rounding."""
    row = R.ROWS["E1"]
    groups, x = _input("E1")
    assert [(m, len(f)) for m, f in groups] == list(row.groups)
    freqs = np.concatenate([f for _, f in groups])
    assert np.all(freqs % 50 == 0) and np.all(np.diff(freqs) > 0)
    assert x.dtype == np.float32 and x.shape == (row.L, 2)
    sig = (x[:, 0] + 1j * x[:, 1]).astype(np.complex128) - R.bench_noise(
        row.L)
    spec = np.abs(np.fft.fft(sig)) / row.L
    step = row.samprate / row.L
    fc = groups[0][1][256]
    bins = [int(round((fc + d) / step)) % row.L for d in (0, 1000, -1000)]
    assert np.allclose(spec[bins], [0.2, 0.05, 0.05], atol=1e-5)
    want = set()
    for mode, f in groups:
        parts, fm, _ = R.MODE_SIGNALS[mode]
        offs = [1000 * k for k in range(-6, 7)] if fm else \
            [off for _, off in parts]
        want |= {int(round((f[len(f) // 2] + d) / step)) % row.L
                 for d in offs}
    assert set(np.flatnonzero(spec > 1e-3).tolist()) == want


def test_check_input_names_the_input():
    row = R.ROWS["R5"]
    _, x = R.row_input(row)
    x = x.copy()
    x[0, 0] ^= 1
    with pytest.raises(ValueError, match="the input differs, not the port"):
        R.check_input(row, R.load("R5"), x)


def _held(row, ref, call, **kw):
    arrays, _ = R.run_port(row, CPU, call, **kw)
    rep = R.compare(ref, arrays, row.name, call)
    print(rep.summary())
    assert rep.ok, rep.summary()
    return rep


def test_r5_port_cpu(capsys):
    """R5 through the port on the CPU by its call plan (scan chunks of 8,
    the rest one block a call) within the bounds, by the module's CLI:
    its input's hash checked, one ok line a plan, exit 0."""
    assert R.main(["--rows", "R5", "--cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(R.ROWS["R5"].calls)
    assert all(ln.startswith("R5 ") and ln.endswith("; ok") for ln in lines)


def test_main_needs_a_card_without_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        R.main(["--rows", "R5"])
    assert e.value.code == 2


@functools.cache
def _small_ref(name):
    return generate(SMALL_ROWS[name])


@functools.cache
def _small_run(name, call):
    return R.run_port(SMALL_ROWS[name], CPU, call)[0]


@pytest.mark.parametrize("name,call", [(n, c) for n, r in SMALL_ROWS.items()
                                       for c in r.calls])
def test_small_round_trip(name, call):
    """The generator with JAX and the comparator with the port at a small
    geometry: within the bounds, and a perturbation of one kept PCM
    sample (the last ear's, where a channel is stereo), one flag or one
    state word is a breach."""
    row = SMALL_ROWS[name]
    ref = _small_ref(name)
    arrays = _small_run(name, call)
    rep = R.compare(ref, arrays, name, call)
    assert rep.ok, rep.summary()
    assert len(rep.lsb) == len(rep.lsb_out) == len(R.pcm_blocks(row))
    for row_pcm in (0, -1):
        bad = dict(arrays, pcm=arrays["pcm"].copy())
        bad["pcm"][-1, row_pcm, 5] += R.PCM_LSB + 1
        assert not R.compare(ref, bad, name, call).ok
    key = next(k for k in arrays if k.startswith("state."))
    bad = dict(arrays, **{key: arrays[key] + 1})
    assert R.compare(ref, bad, name, call).state_differ == [
        key[len("state."):]]
    if arrays["flagged"][-1]:
        bad = dict(arrays, flags=arrays["flags"].copy())
        bad["flags"][-1, 0] ^= True
        assert not R.compare(ref, bad, name, call).ok


def test_small_modes_stereo_and_tones():
    """The small multi-mode row: ISB and IQ keep both ears (their two PCM
    rows differ: the sidebands' tones, I and Q); the port's tones are the
    reference's bins, 1500 / 1000 Hz in ISB's ears; a tone one bin away
    is counted and no breach, two bins away or a missing ear is one."""
    ref, arrays = _small_ref("S-MODES"), _small_run("S-MODES", "step")
    assert ref["ears"].tolist() == [1, 1, 2, 2, 1]
    assert ref["pcm"].shape == (4, 7, 960)
    assert not np.array_equal(arrays["pcm"][-1, 2], arrays["pcm"][-1, 3])
    rep = R.compare(ref, arrays)
    assert rep.ok and rep.tones[2] == [1500.0, 1000.0], rep.summary()
    for moved, breach in ((1, False), (2, True)):
        bad = dict(arrays, tone=arrays["tone"].copy())
        bad["tone"][3, 1] += moved
        got = R.compare(ref, bad)
        assert got.ok is not breach and len(got.tone_one_bin) == 1 - breach
    bad = dict(arrays, tone=arrays["tone"].copy())
    bad["tone"][3, 1] = -1
    assert not R.compare(ref, bad).ok


def test_small_active_sets():
    """The small mesh row's active call: 16 slots over 14 channels padded
    to 16, so the padding rows reach the top-k and are marked unused, as
    in JAX; its sets equal JAX's.  A padding row in a set is a breach,
    and so is a bound channel in one set and not the other; a channel
    whose audio the block does not yet bind is only counted."""
    ref = R.for_call(_small_ref("S-MESH"), "active")
    arrays = _small_run("S-MESH", "active")
    idx = ref["idx"]
    assert idx.shape == (12, 16) and idx.max() < 14
    assert (idx == -1).sum(axis=1).min() >= 2
    rep = R.compare(_small_ref("S-MESH"), arrays, "S-MESH", "active")
    assert rep.ok and len(rep.active_differ) == 12, rep.summary()
    full = _small_ref("S-MESH")
    for b, at, breach in ((5, 15, True), (0, 14, True), (11, 0, True)):
        bad = dict(arrays, idx=arrays["idx"].copy())
        slots = bad["idx"][b]
        free = int(np.flatnonzero(slots == -1)[0])
        slots[free] = at if at >= 14 else next(
            c for c in range(14) if c not in slots)
        got = R.compare(full, bad, "S-MESH", "active")
        assert got.ok is not breach, (b, at, got.summary())
    # a noise channel left out of block 0's set (outside the audio's
    # domain) is counted
    bad = dict(arrays, idx=arrays["idx"].copy())
    car = R.carrier_channels(SMALL_ROWS["S-MESH"])
    slot = next(i for i, c in enumerate(bad["idx"][0])
                if c >= 0 and c not in car)
    bad["idx"][0][slot] = -1
    got = R.compare(full, bad, "S-MESH", "active")
    assert got.ok and got.active_out[0] == 1, got.summary()


@pytest.mark.parametrize("call", ["step", "scan"])
def test_plfreq_bound(call):
    """The PL tone's bound on the small modulated row: the port measures
    each carrier's tone within 1 Hz and in the reference's bin; a carrier
    one bin away is counted and no breach, two bins away (in a block or
    after the last) or NaN against a tone is a breach."""
    row = SMALL_ROWS["S-FMM"]
    ref, arrays = _small_ref("S-FMM"), _small_run("S-FMM", call)
    rep = R.compare(ref, arrays)
    assert rep.ok and not rep.pl_one_bin, rep.summary()
    assert np.all(np.abs(np.asarray(rep.pl_end) - [100, 150, 200]) <= 1.0)
    assert rep.pl_equal == 3 * (1 + (row.K if call == "step" else
                                     row.K % R.SCAN_CHUNK))
    width = float(ref["pl_bin"])
    car = [list(ref["kept"]).index(c) for c in ref["carriers"]]
    for key, at in (("plfreq_end", np.s_[car[1]]),
                    ("plfreq", np.s_[-1, car[1]])):
        for moved, breach in ((width, False), (2 * width, True),
                              (np.nan, True)):
            bad = dict(arrays, **{key: arrays[key].copy()})
            bad[key][at] += moved
            got = R.compare(ref, bad)
            assert got.ok is not breach, (key, moved, got.summary())
            assert len(got.pl_one_bin) == (not breach)
    assert "PL tone not recorded" in R.compare(
        {k: v for k, v in ref.items() if not k.startswith("pl")},
        arrays).summary()


@pytest.mark.slow
@pytest.mark.parametrize("name", ["R1", "R2", "R3", "R4", "R6", "R7", "R8",
                                  "R9", "M1", "E1", "S1"])
def test_rows_port_cpu(name):
    """R1-R4, R6-R9, M1, E1 and S1 (on 4 CPU shards) through the port on
    the CPU by their call plans, within the bounds (minutes a row: run by
    hand, ``-m slow``)."""
    row = R.ROWS[name]
    ref = R.load(name)
    freqs, x = R.row_input(row)
    R.check_input(row, ref, x)
    torch.set_num_threads(os.cpu_count())
    try:
        for call in row.calls:
            _held(row, ref, call, x=x, freqs=freqs)
    finally:
        torch.set_num_threads(1)


if __name__ == "__main__":
    if sys.argv[1:2] != ["--write"]:
        sys.exit("usage: JAX_PLATFORMS=cpu python "
                 "tests/test_torch_reference.py --write ROW [ROW ...]")
    jax.config.update("jax_platforms", "cpu")
    for name in sys.argv[2:] or list(R.ROWS):
        write(name)
