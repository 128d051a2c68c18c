"""Finding a cell's parts by name: ``BENCHMARK.json`` at the root of the
checkout names the cell's configuration and traffic mix and the metrics
it reports; each lives in a file of its own under this directory:

- ``configs/<config>.json``: the deployment (bank kind, rate, block,
  groups, options) as it is run;
- ``traffic/<traffic>.json``: the loop (closed, or open at the wire
  rate), whether the entry compacts, and the signals;
- ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``;
- ``limits/<workload>.json``: the limit of each number ``correct``
  compares.

A later cell, mix, metric or configuration is a new file and a new entry
in ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root=".") -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(workload: str) -> dict:
    return load_json(HERE / "limits" / f"{workload}.json")


def metrics_for(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of `workload` reports: its end-to-end
    metrics untraced, its per-layer metrics traced."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries
            if workload in m.get("workloads", [workload])]


def reader(name: str):
    """The `read` function of metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"sdrbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
