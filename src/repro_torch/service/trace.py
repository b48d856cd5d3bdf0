"""Chrome/Perfetto ``trace_event`` tracing of the serving engine, the
counterpart of ``repro.service.trace``.

:class:`TraceBuilder` collects the events the engine emits while serving:
per-tick phase spans (``schedule / admit / dispatch / device_wait /
materialize / retire``, one row per shard and one for the fleet) and one
async track per request (submit, admit, preempt, resume, migrate, shrink,
truncate, then its terminal), and renders them as one Trace Event Format
JSON document (``serve_sa --trace out.json``).  Open the file at
https://ui.perfetto.dev (or ``chrome://tracing``).

Layout:

* ``pid`` 0 is the engine.  ``tid`` 0 holds the fleet-wide spans
  (schedule, admit); ``tid`` ``shard_index + 1`` holds that shard's
  dispatch, device_wait, materialize and retire spans.  Metadata events
  name the rows.
* Request lifecycles are async events of category ``"request"`` with id
  ``req_id``: ``b`` at submit, ``n`` instants, ``e`` at the terminal.
* Timestamps are microseconds on the engine's monotonic epoch (engine.py
  ``_now``), the clock of every wall figure of the engine.

The document validates against ``trace_schema.json`` beside this module,
a byte-for-byte copy of the reference's; :func:`validate_trace`
implements the JSON-Schema subset the schema uses (type, required,
properties, items, enum, minimum) with no third-party dependency.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional

from repro_torch.service.telemetry import TICK_PHASES

SCHEMA_PATH = Path(__file__).with_name("trace_schema.json")

_US = 1e6           # seconds -> trace microseconds


class TraceBuilder:
    """Accumulates Trace Event Format events (host-side, append-only)."""

    def __init__(self):
        self.events: List[dict] = []
        self._clock = None          # bound by the engine: epoch seconds
        self._named_tids = set()
        self._meta("process_name", {"name": "sa-serve-engine"}, tid=0)
        self._name_tid(0, "engine (schedule/admit)")

    # ------------------------------------------------------------- plumbing
    def bind_clock(self, clock) -> None:
        """Attach the engine's monotonic epoch clock (seconds)."""
        self._clock = clock

    def _now_us(self) -> float:
        return (self._clock() if self._clock is not None else 0.0) * _US

    def _meta(self, name: str, args: dict, tid: int) -> None:
        self.events.append({"ph": "M", "name": name, "pid": 0, "tid": tid,
                            "args": args})

    def _name_tid(self, tid: int, name: str) -> None:
        if tid not in self._named_tids:
            self._named_tids.add(tid)
            self._meta("thread_name", {"name": name}, tid=tid)

    def ensure_shard_track(self, shard_index: int) -> None:
        self._name_tid(shard_index + 1, f"shard {shard_index}")

    # ---------------------------------------------------------- phase spans
    def span(self, phase: str, t0: float, t1: float,
             shard: Optional[int] = None, tick: Optional[int] = None) -> None:
        """One complete ('X') phase span, [t0, t1] in epoch seconds."""
        tid = 0 if shard is None else shard + 1
        if shard is not None:
            self.ensure_shard_track(shard)
        ev = {"ph": "X", "name": phase, "cat": "tick", "pid": 0, "tid": tid,
              "ts": t0 * _US, "dur": max(t1 - t0, 0.0) * _US}
        if tick is not None:
            ev["args"] = {"tick": tick}
        self.events.append(ev)

    # ----------------------------------------------------- decision instants
    def instant(self, name: str, **args) -> None:
        """Thread-scoped instant mirroring one structured-log decision."""
        self.events.append({"ph": "i", "name": name, "cat": "decision",
                            "pid": 0, "tid": 0, "s": "t",
                            "ts": self._now_us(), "args": args})

    # ------------------------------------------------------ request lifecycle
    def _async(self, ph: str, req_id: int, name: str, args: dict) -> None:
        self.events.append({"ph": ph, "cat": "request", "id": int(req_id),
                            "name": name, "pid": 0, "tid": 0,
                            "ts": self._now_us(), "args": args})

    def request_begin(self, req_id: int, **args) -> None:
        self._async("b", req_id, f"req{req_id}", args)

    def request_instant(self, req_id: int, what: str, **args) -> None:
        self._async("n", req_id, what, args)

    def request_end(self, req_id: int, **args) -> None:
        self._async("e", req_id, f"req{req_id}", args)

    # -------------------------------------------------------------- document
    def to_json(self) -> dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def dumps(self) -> str:
        return json.dumps(self.to_json(), sort_keys=True)


# ------------------------------------------------------------------ validation
def load_schema() -> dict:
    return json.loads(SCHEMA_PATH.read_text(encoding="utf-8"))


def _check(doc, schema, path: str, errors: List[str]) -> None:
    t = schema.get("type")
    if t:
        ok = {"object": dict, "array": list, "string": str,
              "boolean": bool, "null": type(None)}
        if t == "number":
            good = isinstance(doc, (int, float)) \
                and not isinstance(doc, bool)
        elif t == "integer":
            good = isinstance(doc, int) and not isinstance(doc, bool)
        else:
            good = isinstance(doc, ok[t])
        if not good:
            errors.append(f"{path}: expected {t}, got {type(doc).__name__}")
            return
    if "enum" in schema and doc not in schema["enum"]:
        errors.append(f"{path}: {doc!r} not in {schema['enum']}")
    if "minimum" in schema and isinstance(doc, (int, float)) \
            and not isinstance(doc, bool) and doc < schema["minimum"]:
        errors.append(f"{path}: {doc} < minimum {schema['minimum']}")
    if isinstance(doc, dict):
        for req in schema.get("required", ()):
            if req not in doc:
                errors.append(f"{path}: missing required key {req!r}")
        for key, sub in schema.get("properties", {}).items():
            if key in doc:
                _check(doc[key], sub, f"{path}.{key}", errors)
    if isinstance(doc, list) and "items" in schema:
        for i, item in enumerate(doc):
            _check(item, schema["items"], f"{path}[{i}]", errors)


def validate_trace(doc: dict, schema: Optional[dict] = None) -> List[str]:
    """Validate a trace document against the checked-in schema.

    Returns the list of violations (empty == valid).  Phase-span events
    additionally get a semantic check the schema language cannot express:
    every ``X`` event's duration must be non-negative and its phase name
    drawn from the tick taxonomy.
    """
    schema = load_schema() if schema is None else schema
    errors: List[str] = []
    _check(doc, schema, "$", errors)
    for i, ev in enumerate(doc.get("traceEvents", [])):
        if not isinstance(ev, dict):
            continue
        if ev.get("ph") == "X":
            if ev.get("dur", 0) < 0:
                errors.append(f"$.traceEvents[{i}]: negative dur")
            if ev.get("cat") == "tick" and ev.get("name") not in TICK_PHASES:
                errors.append(
                    f"$.traceEvents[{i}]: unknown tick phase "
                    f"{ev.get('name')!r}")
    return errors
