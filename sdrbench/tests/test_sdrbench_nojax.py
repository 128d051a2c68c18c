"""Nothing the benchmark runs imports JAX or the JAX package, and its
yardstick imports nothing of the program: a tiny CPU dry path of the
traffic, the reference and the metrics with ``jax``, ``jaxlib``, ``flax``,
``ka9q_sdr_tpu`` and ``ka9q_sdr_tpu_torch`` blocked (top-level names
compared whole); and a run without a card exits non-zero."""

import os
import subprocess
import sys
from pathlib import Path

from sdrbench.run import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]

DRY = r"""
import importlib.abc, sys

BLOCKED = {"jax", "jaxlib", "flax", "ka9q_sdr_tpu", "ka9q_sdr_tpu_torch"}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".", 1)[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import numpy as np, torch
from sdrbench import cells, compare, control, devtime, generator, serve, yardstick
from sdrbench.run import Run, forbidden_modules
from sdrbench.program import channel_freqs
from sdrbench.reference.bank import RefBank
from sdrbench.tests import tiny

cfg, tr = tiny.config("mixed6144_20ms"), tiny.traffic("sat")
groups = channel_freqs(cfg)
plan = generator.draw(groups, float(cfg["samprate"]), tr["signals"], 7)
loop = generator.make_loop(plan, cfg["L"], tr["noise_rms"], 7, "cpu")
nums = control.control_numbers(cfg, tr, 7, 3, torch.device("cpu"))
assert nums["bb_power_rel_gap"] > 0
run = Run(cfg, "cpu", 1.0, "closed", 0.02)
run.dev_ms = [(0.0, 1.0, 2.0)] * 3
for m in cells.benchmark(".")["end_to_end"] + cells.benchmark(".")["per_layer"]:
    cells.reader(m["name"])
found = {m.split(".", 1)[0] for m in sys.modules} & BLOCKED
assert not found and not forbidden_modules(), found
print("dry path ok")
"""


def test_dry_path_imports_no_jax_and_nothing_of_the_program():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", DRY], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "dry path ok" in out.stdout


def test_forbidden_names_are_compared_whole():
    assert forbidden_modules(["ka9q_sdr_tpu_torch", "ka9q_sdr_tpu_torch.ops",
                              "numpy", "jaxtyping"]) == []
    assert forbidden_modules(["ka9q_sdr_tpu.ops.agc", "jax.numpy",
                              "flax"]) == ["flax", "jax", "ka9q_sdr_tpu"]


def test_a_run_without_a_card_exits_non_zero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-m", "sdrbench.run", "--workload",
                          "fm4096-sat", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
