"""The port's measurement tools (``ka9q_sdr_tpu_torch.tools``) under
--cpu, as subprocesses: each must keep printing its one-line JSON contract,
the keys tests/test_tools.py asserts of the JAX package's twins, which the
next measurements parse.  Host-clock times at a tiny geometry; the card's
numbers come from chip_smoke.py.

The stage profile's derived rows are computed from the printed (rounded)
values, so they must equal the differences of the printed values exactly,
where the JAX tool's rows could differ from them by a rounding step."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_tool(name, *args, timeout=280):
    # one torch thread, as the in-process tests set, so the suite's
    # parallel workers are not oversubscribed
    proc = subprocess.run(
        [sys.executable, "-m", f"ka9q_sdr_tpu_torch.tools.{name}", *args],
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.strip().splitlines() if ln]
    assert lines, f"no stdout; stderr: {proc.stderr[-500:]}"
    return json.loads(lines[-1])


def test_stage_profile_cpu_smoke():
    res = _run_tool("stage_profile", "--cpu", "--iters", "3")
    for key in ("master_ms", "chan_ms", "full_ms", "fills_ms",
                "pl_ring_ms", "pl_fft_ms", "pl_fft_amortised_ms",
                "d_channelize_ms", "d_demod_ms", "realtime_x",
                "front_nco_ms", "front_n0_ms", "front_psd_ms"):
        assert key in res, key
        assert isinstance(res[key], (int, float)), key
    assert res["channels"] == 16 and res["L_dec"] > 0
    assert res["device"] == "cpu" and res["timing"] == "host clock"
    assert res["d_channelize_ms"] == round(res["chan_ms"] - res["master_ms"],
                                           3)
    assert res["d_demod_ms"] == round(res["full_ms"] - res["chan_ms"], 3)
    assert res["pl_fft_amortised_ms"] <= res["pl_fft_ms"]


@pytest.mark.parametrize("stages,keys", [
    ("front", {"front_nco_ms", "front_n0_ms", "front_psd_ms"}),
    ("master,chan", {"master_ms", "chan_ms"})])
def test_stage_profile_stage_subsets(stages, keys):
    res = _run_tool("stage_profile", "--cpu", "--iters", "1", "--stages",
                    stages)
    assert keys <= res.keys() and "full_ms" not in res
    assert "d_channelize_ms" not in res


def test_serve_soak_cpu_smoke():
    res = _run_tool("serve_soak", "--cpu", "--blocks", "25")
    assert res["blocks"] == 25
    assert res["sustained_rt"] > 0
    assert 0 < res["p50_ms"] <= res["p99_ms"] <= res["max_ms"]
    assert res["channels"] >= 1 and res["block_ms"] > 0
    assert res["peak_rss_kb"] > 0 and res["device"] == "cpu"


@pytest.mark.parametrize("tool", ["stage_profile", "serve_soak"])
def test_tools_need_a_card_without_cpu(tool):
    """Without --cpu a tool measures the card or nothing: it never falls
    back to the host."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m", f"ka9q_sdr_tpu_torch.tools.{tool}"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "no CUDA device" in proc.stderr
    assert proc.stdout == ""
