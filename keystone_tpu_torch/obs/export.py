"""Trace export: Chrome-trace/Perfetto JSON + compact JSONL event log
(port of ``keystone_tpu/obs/export.py``).

The Chrome trace event format (the JSON array flavor inside a
``{"traceEvents": [...]}`` document) is what Perfetto's UI and
``chrome://tracing`` load directly:

  - one track per thread (``M`` thread-name metadata events; spans are
    ``X`` complete events with microsecond ``ts``/``dur``),
  - instant events (cost decisions, faults) as ``i`` events,
  - counter tracks (queue depths, outstanding requests) as ``C`` events.

``events.jsonl`` is the same record stream in this repo's own row shape
(one JSON object per line — see ``obs/tracer.py`` for the schema): the
compact log ``tools/trace.py`` / ``bin/trace`` summarize without parsing
the Chrome projection back apart.

``validate_chrome_trace`` is the schema gate the tests assert through:
it checks exactly the invariants the viewers rely on, so "the file
validates" is a testable claim, not a vibe.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Iterable, List, Optional

__all__ = [
    "device_of_span_args",
    "load_events",
    "to_chrome_trace",
    "validate_chrome_trace",
    "write_trace_dir",
]

TRACE_JSON = "trace.json"
EVENTS_JSONL = "events.jsonl"
META_JSON = "meta.json"

# The subset of Chrome trace event phases this exporter emits.
_PHASES = {"X", "i", "C", "M"}

# Per-device read lanes the mesh ingestion plane submits on
# (data/prefetch.py ``mesh_read_lane``): ``read.d<k>`` owns device k's
# row shard, so its runtime.task spans ARE device-k evidence.
_DEVICE_LANE = re.compile(r"^read\.d(\d+)$")


def device_of_span_args(args: Dict[str, Any]) -> Optional[str]:
    """The device identity a span's args pin it to, or None.

    Two tag conventions feed this: an explicit ``device=`` attr (the
    mesh fold's ``fold.segment`` spans — ``data[0-7]`` for a dispatch
    covering the whole axis), and a ``lane=read.d<k>`` attr (the
    per-device ingestion lanes, genuinely device-local work)."""
    dev = args.get("device")
    if dev is not None:
        return str(dev)
    lane = args.get("lane")
    if isinstance(lane, str):
        m = _DEVICE_LANE.match(lane)
        if m:
            return m.group(1)
    return None


def _jsonable(v: Any) -> Any:
    """Args must survive json.dumps: coerce exotic leaves (numpy
    scalars, dtypes, tuples-as-keys never occur) to plain types."""
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    try:
        # numpy scalars expose item(); anything else degrades to str.
        return v.item()
    except AttributeError:
        return str(v)


def to_chrome_trace(records: Iterable[Dict[str, Any]],
                    run_id: Optional[str] = None) -> Dict[str, Any]:
    """Project tracer records (span/event/counter rows) into one
    Chrome-trace document. ``records`` is a :class:`~keystone_tpu_torch.obs.
    tracer.Tracer`'s ``events`` list (or the rows read back from
    ``events.jsonl``)."""
    records = list(records)
    if run_id is None:
        for r in records:
            if "run_id" in r:
                run_id = r["run_id"]
                break
    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
        "args": {"name": f"keystone_tpu_torch run {run_id or '?'}"},
    }]
    # Stable small tids per thread, in first-seen order; one thread-name
    # metadata event per track.
    tid_of: Dict[Any, int] = {}
    for r in records:
        raw = r.get("tid")
        if raw is None:
            continue
        if raw not in tid_of:
            tid_of[raw] = len(tid_of) + 1
            events.append({
                "name": "thread_name", "ph": "M", "pid": 1,
                "tid": tid_of[raw],
                "args": {"name": r.get("thread", f"thread-{raw}")},
            })
    # Synthetic device tracks: spans pinned to a device (explicit
    # ``device=`` attr, or a ``read.d<k>`` per-device ingestion lane)
    # render on their own ``device-<k>`` row so an 8-chip run reads as
    # 8 parallel tracks, not one interleaved thread. Numeric device ids
    # sort numerically so device-10 lands after device-9.
    dev_keys: List[str] = []
    for r in records:
        if r.get("type") != "span":
            continue
        dev = device_of_span_args(r.get("args") or {})
        if dev is not None and dev not in dev_keys:
            dev_keys.append(dev)
    dev_keys.sort(key=lambda s: (0, int(s)) if s.isdigit() else (1, s))
    dev_tid_of: Dict[str, int] = {}
    for dev in dev_keys:
        dev_tid_of[dev] = len(tid_of) + len(dev_tid_of) + 1
        events.append({
            "name": "thread_name", "ph": "M", "pid": 1,
            "tid": dev_tid_of[dev],
            "args": {"name": f"device-{dev}"},
        })
    for r in records:
        kind = r.get("type")
        if kind == "span":
            args = dict(_jsonable(r.get("args", {})))
            args["run_id"] = r.get("run_id")
            args["span_id"] = r.get("span_id")
            if r.get("parent_id") is not None:
                args["parent_id"] = r["parent_id"]
            if r.get("error") is not None:
                args["error"] = r["error"]
            dev = device_of_span_args(args)
            events.append({
                "name": r["name"], "ph": "X", "pid": 1,
                "tid": (
                    dev_tid_of[dev] if dev is not None
                    else tid_of.get(r.get("tid"), 0)
                ),
                "ts": int(r["ts_us"]), "dur": int(r["dur_us"]),
                "args": args,
            })
        elif kind == "event":
            args = dict(_jsonable(r.get("args", {})))
            args["run_id"] = r.get("run_id")
            events.append({
                "name": r["name"], "ph": "i", "pid": 1,
                "tid": tid_of.get(r.get("tid"), 0),
                "ts": int(r["ts_us"]), "s": "t",
                "args": args,
            })
        elif kind == "counter":
            events.append({
                "name": r["name"], "ph": "C", "pid": 1, "tid": 0,
                "ts": int(r["ts_us"]),
                "args": {"value": float(r["value"])},
            })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"run_id": run_id},
    }


def validate_chrome_trace(doc: Any) -> List[str]:
    """Schema check of a Chrome-trace document; returns violation
    strings (empty = valid). Checks the invariants the Perfetto /
    chrome://tracing loaders rely on: a ``traceEvents`` list whose every
    event carries a string ``name``, a known ``ph``, integer
    ``pid``/``tid``, a numeric non-negative ``ts`` (except metadata),
    a non-negative ``dur`` on complete (``X``) events, an ``args.name``
    on metadata events, and a numeric counter value on ``C`` events."""
    bad: List[str] = []
    if not isinstance(doc, dict):
        return [f"document is {type(doc).__name__}, not an object"]
    ev = doc.get("traceEvents")
    if not isinstance(ev, list):
        return ["traceEvents missing or not a list"]
    for i, e in enumerate(ev):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            bad.append(f"{where}: not an object")
            continue
        name = e.get("name")
        if not isinstance(name, str) or not name:
            bad.append(f"{where}: missing/empty name")
        ph = e.get("ph")
        if ph not in _PHASES:
            bad.append(f"{where}: unknown phase {ph!r}")
            continue
        for key in ("pid", "tid"):
            if not isinstance(e.get(key), int):
                bad.append(f"{where}: {key} missing or not an int")
        if ph != "M":
            ts = e.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                bad.append(f"{where}: ts missing/negative")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                bad.append(f"{where}: X event without non-negative dur")
        if ph == "M":
            args = e.get("args")
            if not (isinstance(args, dict)
                    and isinstance(args.get("name"), str)):
                bad.append(f"{where}: metadata event without args.name")
        if ph == "C":
            args = e.get("args")
            if not isinstance(args, dict) or not all(
                isinstance(v, (int, float)) and not isinstance(v, bool)
                for v in args.values()
            ) or not args:
                bad.append(f"{where}: counter event without numeric args")
        if ph == "i" and e.get("s") not in (None, "t", "p", "g"):
            bad.append(f"{where}: instant scope {e.get('s')!r} invalid")
    return bad


def write_trace_dir(directory: str, tracer) -> Dict[str, str]:
    """Write one trace directory: ``events.jsonl`` (compact rows),
    ``trace.json`` (Chrome trace), ``meta.json`` (run_id + counts).
    Returns the written paths keyed by role."""
    os.makedirs(directory, exist_ok=True)
    records = tracer.events
    jsonl_path = os.path.join(directory, EVENTS_JSONL)
    with open(jsonl_path, "w") as f:
        for r in records:
            f.write(json.dumps(_jsonable(r)) + "\n")
    doc = to_chrome_trace(records, run_id=tracer.run_id)
    trace_path = os.path.join(directory, TRACE_JSON)
    with open(trace_path, "w") as f:
        json.dump(doc, f)
    counts: Dict[str, int] = {}
    for r in records:
        counts[r.get("type", "?")] = counts.get(r.get("type", "?"), 0) + 1
    meta_path = os.path.join(directory, META_JSON)
    meta = {"run_id": tracer.run_id, "counts": counts}
    dropped = getattr(tracer, "dropped", 0)
    if dropped:
        # No silent caps: a bounded buffer that rolled off old records
        # says so in the trace it wrote.
        meta["dropped_records"] = dropped
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    return {"events": jsonl_path, "trace": trace_path, "meta": meta_path}


def load_events(directory: str) -> List[Dict[str, Any]]:
    """Read a trace directory's ``events.jsonl`` back into record rows
    (what ``tools/trace.py`` summarizes)."""
    path = os.path.join(directory, EVENTS_JSONL)
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
