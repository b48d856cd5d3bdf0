"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root lists the configurations, the
cells (a configuration under a traffic mix) and the metrics.  Everything
else is a file of its own under ``perfbench/``:

* ``configs/<config>.json``: the configuration (the ``file`` that
  ``BENCHMARK.json`` names for it);
* ``traffic/<traffic>.json``: the traffic mix, whose ``driver`` names
* ``drivers/<driver>.py``: the entry point the window drives, with a
  ``run(ctx)`` function;
* ``metrics/<metric>.py``: one reader per per-layer metric, with a
  ``read(records)`` function that returns a number or None;
* ``costs/<kernel>.py``: the operations and bytes of a kernel or a step.

A later cell or metric is added by adding such files and entries, with
no edit to a file that is there.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]      # perfbench/
ROOT = HERE.parent                              # the checkout


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    return json.loads((root / config_entry(bench, name)["file"]).read_text())


def load_traffic(name: str, base: Path = HERE) -> dict:
    return json.loads((base / "traffic" / f"{name}.json").read_text())


def load_module(kind: str, name: str, base: Path = HERE):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = base / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end_of(bench: dict, cell_name: str) -> list:
    """The end-to-end metrics a cell reports."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def per_layer_of(bench: dict, cell_name: str) -> list:
    """The per-layer metrics a cell's traced run reports: those that list
    it, and those without a list whose end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end_of(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]
