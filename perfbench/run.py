"""Run one cell of the benchmark and print its result line.

  python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic,
driver and metric readers are found by name (``lib/cells.py``).  The run
needs as many CUDA cards as the cell asks for: without them it exits 2
and prints no result.  It exits 3, with no result, if ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` is loaded when the
window has closed.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; its last key, ``check``, holds each number compared with
its limit, which the last lines of standard error repeat.
"""
from __future__ import annotations


def _process_start() -> float:
    """Epoch seconds at which this process started."""
    import os
    import time
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def setup_paths(root: Path = ROOT) -> None:
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)


def cache_env(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The kernel library builds into ``src/repro_torch/kernels/_build``."""
    base = root / "perfbench" / ".cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Context:
    """What a driver gets: the cell's data, the run's arguments, and the
    device hooks (no-ops on the CPU)."""

    def __init__(self, bench, cell_name, seed, seconds, trace, device,
                 config=None, traffic=None, root=ROOT, early=None):
        from perfbench.lib import cells
        from perfbench.lib.trace import Tracer
        self.bench = bench
        self.cell = cells.cell(bench, cell_name)
        self.cell_name = cell_name
        self.config = config or cells.load_config(bench, self.cell["config"], root)
        self.traffic = traffic or cells.load_traffic(self.cell["traffic"],
                                                     root / "perfbench")
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.on_card = device != "cpu"
        self.chips = self.cell["chips"]
        self.tracer = Tracer(self.on_card)
        self.t_start = T_START
        self.window_start = None
        self.root = root
        #: what the driver's ``prestart`` started, if it has one
        self.early = early

    def sync(self):
        if self.on_card:
            import torch
            torch.cuda.synchronize()

    def reset_peak(self):
        if self.on_card:
            import torch
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def peak_bytes(self) -> int:
        if not self.on_card:
            return 0
        import torch
        torch.cuda.synchronize()
        return int(torch.cuda.max_memory_allocated())

    def mark_window_start(self) -> float:
        self.window_start = time.time()
        return self.window_start

    def free(self):
        gc.collect()
        if self.on_card:
            import torch
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def per_layer(bench, ctx, records) -> dict:
    from perfbench.lib import cells
    out = {}
    for m in cells.per_layer_of(bench, ctx.cell_name):
        v = cells.load_module("metrics", m["name"], ctx.root / "perfbench").read(records)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = ROOT, config=None,
             traffic=None, driver=None, early=None) -> dict:
    """Run one cell and return its result object.  ``device="cpu"`` (with
    a ``config``/``traffic`` cut to a toy size) is the CPU tests' entry:
    the drivers run the program's plain path and no device metric is
    read.  ``driver`` puts another module in the place of the traffic's
    driver (the control, ``perfbench/control.py``); ``early`` is what
    the driver's ``prestart`` started."""
    from perfbench.lib import cells
    from perfbench.lib.trace import union_s
    bench = cells.load_benchmark(root)
    ctx = Context(bench, workload, seed, seconds, trace, device, config,
                  traffic, root, early)
    driver = driver or cells.load_module("drivers", ctx.traffic["driver"],
                                         root / "perfbench")
    out = driver.run(ctx)
    limits = ctx.traffic["limits"]
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in out["checks"].items()}
    correct = (out["failed"] == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    ws = out.get("window_start", ctx.window_start)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
    if trace:
        metrics = per_layer(bench, ctx, out["records"])
    else:
        metrics = {k: {"value": float(v), "unit": units[k]}
                   for k, v in out["e2e"].items()}
        metrics["setup_s"] = {"value": ws - ctx.t_start, "unit": "s"}
    dev = {"platform": "gpu" if ctx.on_card else "cpu",
           "kind": _device_name(ctx), "count": ctx.chips,
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    st = out["records"].stretch if trace else None
    if st is not None:
        # Over several cards the driver averages over the ranks.
        busy, window = out.get("device_times") or (union_s(st.device), st.window_s)
        dev["busy_s"], dev["window_s"] = busy, window
        result["breakdown"] = {"device_ops": st.top_ops(),
                               "idle_gaps": st.idle_gaps()}
        out.setdefault("extra", {})["trace"] = {
            "wall_s": st.wall_s, "device_ops": len(st.device), "host_ops": len(st.host)}
    if out.get("extra"):
        result["extra"] = out["extra"]
    result["card"] = _card(ctx)
    result["check"] = checks
    return result


def _device_name(ctx) -> str:
    if not ctx.on_card:
        return "cpu"
    import torch
    return torch.cuda.get_device_name(0)


def _card(ctx) -> dict:
    """The card's name and power limit, read beside every number."""
    if not ctx.on_card:
        return {}
    import subprocess
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return {"nvidia_smi": q.stdout.strip().splitlines()}
    except (OSError, subprocess.SubprocessError):
        return {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    setup_paths()
    cache_env()
    from perfbench.lib import cells
    bench = cells.load_benchmark()
    cell = cells.cell(bench, args.workload)
    driver = cells.load_module(
        "drivers", cells.load_traffic(cell["traffic"])["driver"])
    # A driver that runs processes of its own starts them first, so that
    # their start-up runs beside this process's.
    early = (driver.prestart(args, bench, ROOT, T_START)
             if hasattr(driver, "prestart") else None)
    try:
        import torch
        chips = cell["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          driver=driver, early=early)
    finally:
        if early is not None:
            early.close()
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: modules of the JAX side loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
