"""The runner's rows against reference outputs made by the JAX package, and
the script that makes them.

``ka9q_sdr_tpu_torch/tools/reference.py`` defines the rows (R1-R5, the
rows of ``python -m ka9q_sdr_tpu_torch.bench`` at its defaults), what a
reference file holds and the bounds a run of the port is held to; its
module docstring states them.  This file holds the JAX side:

- run as a script it writes the files, one process a row so that each
  row's peak memory is its own::

    JAX_PLATFORMS=cpu python tests/test_torch_reference.py --write R5

  (each row through the JAX package's ``ChannelBank.process_i16_pcm`` or
  ``MultiBank.process`` on its CPU backend, K blocks of the row's one
  input block from a fresh bank);
- as tests: the files exist and their geometry is the runner's rows (the
  runner's own ``_run`` with its row functions recorded); the input
  hashes of R2, R4 and R5 match inputs made here; R5 through the port on
  the CPU within the bounds; a small geometry (N = 8192, 16 channels, as
  tests/test_torch_bankd.py) through this generator with JAX and the
  comparator with the port in one test, so the machinery itself is held
  against JAX on every run; and, marked ``slow``, R1-R4 through the port
  on the CPU.
"""

from __future__ import annotations

import os
import resource
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
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
)}


def generate(row: R.Row, freqs=None, x=None) -> dict:
    """The row through the JAX package on its CPU backend: K blocks of the
    row's input, one a call, from a fresh bank.  Returns the record's
    arrays (``reference.Record``)."""
    if x is None:
        freqs, x = R.row_input(row)
    rec = R.Record(row)
    if row.groups:
        mb = JB.MultiBank(list(freqs), samprate=row.samprate, L=row.L,
                          M=row.M)
        for _ in range(row.K):
            outs = mb.process(x)
            rec.add(np.concatenate([np.asarray(a) for a, _ in outs]),
                    np.concatenate([np.asarray(R.diag_flags(d))
                                    for _, d in outs]))
        return rec.arrays(mb.states)
    cfg = JB.make_bank_config(row.n_channels, row.mode,
                              samprate=row.samprate, L=row.L, M=row.M,
                              **dict(row.cfg))
    bank = JB.ChannelBank(cfg, freqs)
    for _ in range(row.K):
        pcm, diag = bank.process_i16_pcm(x)
        rec.add(np.asarray(pcm), np.asarray(R.diag_flags(diag)))
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


@pytest.mark.parametrize("name", list(R.ROWS))
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


@pytest.mark.parametrize("name,lag", [("R1", 1), ("R2", 2), ("R3", 2),
                                      ("R4", 2), ("R5", 2)])
def test_first_bound_follows_the_audio_filter(name, lag):
    """An FM carrier's audio is bound from block 0, an AGC carrier's PCM
    from block 1 and its RMS from block 0, a noise channel's from block 1,
    an FM noise channel's lag = ceil((M_dec - 1) / L_dec) blocks later."""
    row = R.ROWS[name]
    pcm, rms = R.first_bound(row)
    modes = [m for m, n in row.groups for _ in range(n)] or \
        [row.mode] * row.n_channels
    car = set(R.carrier_channels(row))
    for c in sorted(car) + [0, row.total - 1]:
        fm = modes[c] == "FM"
        want = ((0 if fm else 1), 0) if c in car else \
            ((1 + lag, 1 + lag) if fm else (1, 1))
        assert (pcm[c], rms[c]) == want, c


def test_reference_files_are_small():
    """At most 4 MB for the five files together."""
    total = sum((R.REF_DIR / f"{n}.npz").stat().st_size for n in R.ROWS)
    assert total <= 4_000_000, total


@pytest.mark.parametrize("name", ["R2", "R4", "R5"])
def test_reference_input_hash(name):
    """The input made here is the one the reference was made from."""
    row = R.ROWS[name]
    _, x = R.row_input(row)
    R.check_input(row, R.load(name), x)


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


@pytest.mark.parametrize("name,call", [(n, c) for n, r in SMALL_ROWS.items()
                                       for c in r.calls])
def test_small_round_trip(name, call):
    """The generator with JAX and the comparator with the port at a small
    geometry: within the bounds, and a perturbation of one kept PCM
    sample, one flag or one state word is a breach."""
    row = SMALL_ROWS[name]
    ref = generate(row)
    arrays, _ = R.run_port(row, CPU, call)
    rep = R.compare(ref, arrays, name, call)
    assert rep.ok, rep.summary()
    assert len(rep.lsb) == len(rep.lsb_out) == row.K
    bad = dict(arrays, pcm=arrays["pcm"].copy())
    bad["pcm"][-1, 0, 5] += R.PCM_LSB + 1
    assert not R.compare(ref, bad).ok
    key = next(k for k in arrays if k.startswith("state."))
    bad = dict(arrays, **{key: arrays[key] + 1})
    assert R.compare(ref, bad).state_differ == [key[len("state."):]]
    if arrays["flagged"][-1]:
        bad = dict(arrays, flags=arrays["flags"].copy())
        bad["flags"][-1, 0] ^= True
        assert not R.compare(ref, bad).ok


@pytest.mark.slow
@pytest.mark.parametrize("name", ["R1", "R2", "R3", "R4"])
def test_rows_port_cpu(name):
    """R1-R4 through the port on the CPU by their call plans, within the
    bounds (minutes a row: run by hand, ``-m slow``)."""
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
