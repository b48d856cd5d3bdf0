"""BENCHMARK.json against the benchmark's contract, the pieces each cell
finds by name, and the import rules of the harness."""
from __future__ import annotations

import ast
import hashlib
import json
import re
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.lib import cells  # noqa: E402

BENCH = cells.load_benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    for w in cmd[1:]:
        assert not w.startswith("/") and ".." not in w.split("/")
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_entry_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
        assert w["chips"] in (1, 4) and one_line(w["why"])
        names.append(w["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert one_line(m["layer"])
        names.append(m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline_pct") or m["name"].endswith("_roofline")
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_every_cell_reports_setup_and_a_metric_of_each_kind():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25 and "workloads" not in setup[0]
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in cells.end_to_end_of(BENCH, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cells.per_layer_of(BENCH, w["name"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_per_layer_moves_are_reported_in_their_cells():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", []):
            reported = {x["name"] for x in cells.end_to_end_of(BENCH, cell)}
            assert m["moves"] in reported, (m["name"], cell)
        layers.setdefault(m["layer"], set()).add(m["name"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_its_files_by_name(cell):
    w = cells.cell(BENCH, cell)
    cfg = cells.load_config(BENCH, w["config"], ROOT)
    assert cfg["name"] == w["config"]
    tr = cells.load_traffic(w["traffic"])
    driver = cells.load_module("drivers", tr["driver"])
    assert callable(driver.run)
    for m in cells.per_layer_of(BENCH, cell):
        assert callable(cells.load_module("metrics", m["name"]).read)
    assert set(tr["limits"]) and all(v >= 0 for v in tr["limits"].values())


def _tree_hashes(base: Path) -> dict:
    return {p.relative_to(base): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(base.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_and_metric_need_only_new_files(tmp_path):
    """Copy the benchmark, add a configuration, a traffic mix, a driver, a
    metric and a cost as new files plus new entries: they are found, and
    no file of the copy that was there changed."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = _tree_hashes(root / "perfbench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = root / "perfbench"
    (pb / "configs" / "dummy-cfg.json").write_text(json.dumps({"name": "dummy-cfg"}))
    (pb / "traffic" / "dummy-mix.json").write_text(json.dumps(
        {"driver": "dummy_driver", "limits": {"gap": 0.0}}))
    (pb / "drivers" / "dummy_driver.py").write_text(
        "def run(ctx):\n    return {}\n")
    (pb / "metrics" / "dummy.metric_pct.py").write_text(
        "from pathlib import Path\n"
        "from perfbench.lib import cells\n"
        "def read(r):\n"
        "    base = Path(__file__).resolve().parents[1]\n"
        "    return cells.load_module('costs', 'dummy_kernel', base).cost(1)['bytes']\n")
    (pb / "costs" / "dummy_kernel.py").write_text(
        "def cost(n):\n    return {'bytes': 4 * n}\n")
    bench["configs"].append({"name": "dummy-cfg", "source": "https://example.org",
                             "file": "perfbench/configs/dummy-cfg.json",
                             "reduced": [], "why": "a test entry"})
    bench["workloads"].append({"name": "dummy-cfg.dummy-mix", "config": "dummy-cfg",
                               "traffic": "dummy-mix", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "dummy.metric_pct", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "setup_s",
                               "workloads": ["dummy-cfg.dummy-mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    got = cells.load_benchmark(root)
    assert cells.load_config(got, "dummy-cfg", root)["name"] == "dummy-cfg"
    tr = cells.load_traffic("dummy-mix", pb)
    assert cells.load_module("drivers", tr["driver"], pb).run(None) == {}
    names = [m["name"] for m in cells.per_layer_of(got, "dummy-cfg.dummy-mix")]
    assert names == ["dummy.metric_pct"]
    assert cells.load_module("metrics", "dummy.metric_pct", pb).read(None) == 4
    after = _tree_hashes(pb)
    assert {k: v for k, v in after.items() if k in before} == before


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    files = [p for p in (ROOT / "perfbench").rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        for mod in _imports(p):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "flax", "repro"), (p, mod)


def test_reference_imports_nothing_of_the_program():
    files = list((ROOT / "perfbench" / "reference").rglob("*.py"))
    assert files
    for p in files:
        for mod in _imports(p):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "repro", "repro_torch"), (p, mod)
            assert top in ("perfbench", "numpy", "torch", "math", "__future__"), (p, mod)
            if top == "perfbench":
                assert mod.startswith("perfbench.reference"), (p, mod)


def test_forbidden_names_are_compared_whole(monkeypatch):
    import types
    from perfbench import run
    monkeypatch.setitem(sys.modules, "repro_torch_probe", types.ModuleType("x"))
    assert "repro_torch_probe" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.probe", types.ModuleType("y"))
    assert "repro.probe" in run.forbidden_modules()
