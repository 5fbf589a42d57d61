"""Flight recorder: the bounded ring of recent events a postmortem reads
(port of ``keystone_tpu/obs/flight.py``).

Chaos taught this repo that the exception alone rarely names the cause:
a serving worker dies and the interesting fact is which batch was in
flight and whether the breaker had been flapping; a ``ShardCorrupted``
surfaces consumer-side and the interesting fact is which segment reads
and checkpoint writes preceded it. The flight recorder keeps a bounded,
always-on ring of recent notes — span completions (when tracing is on),
cost decisions, fault-path events — and the fault paths
(``MicroBatchServer._worker_died``, breaker opens, shard-corruption
raises, replica watchdog evictions) dump it alongside the exception via
:func:`dump_flight_record`, so the log names the spans in flight at
death instead of just the stack.

Always-on is safe because the steady-state cost is zero: fault paths are
the only unconditional writers, and span notes fire only while a tracer
is active. No torch, no numpy (imported by the runtime's IO workers and
the serving worker)."""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = [
    "FlightRecorder",
    "default_flight_recorder",
    "dump_flight_record",
    "flight_note",
    "flight_snapshot",
    "render_flight_record",
    "set_dump_dir",
]

logger = logging.getLogger("keystone_tpu_torch.obs.flight")

# Optional on-disk dumps: when a directory is configured (set_dump_dir()
# or the env knob), every dump_flight_record ALSO writes its rendered
# block to a UNIQUE file there. Uniqueness is load-bearing: two replicas
# dying in the same tick dump concurrently, and a timestamp-only name
# would let the second clobber the first — the postmortem of the death
# that explains the other one. pid + an atomic per-process sequence +
# O_EXCL creation make collisions structurally impossible.
DUMP_DIR_ENV = "KEYSTONE_FLIGHT_DUMPS"
_DUMP_DIR: Optional[str] = None
_DUMP_SEQ = itertools.count(1)


class FlightRecorder:
    """Thread-safe bounded ring of ``(ts, kind, name, attrs)`` notes."""

    def __init__(self, maxlen: int = 256):
        self._ring: "deque[Dict[str, Any]]" = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def note(self, kind: str, name: str, **attrs) -> None:
        rec = {"ts": time.time(), "kind": kind, "name": name}
        if attrs:
            rec["attrs"] = {k: v for k, v in attrs.items() if v is not None}
        with self._lock:
            self._ring.append(rec)

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


_DEFAULT = FlightRecorder()


def default_flight_recorder() -> FlightRecorder:
    return _DEFAULT


def flight_note(kind: str, name: str, **attrs) -> None:
    """Append one note to the process flight ring (fault paths call this
    unconditionally; the tracer mirrors span completions here while
    active)."""
    _DEFAULT.note(kind, name, **attrs)


def flight_snapshot() -> List[Dict[str, Any]]:
    return _DEFAULT.snapshot()


def render_flight_record(limit: int = 25) -> str:
    """Human-readable postmortem block: the last ``limit`` ring notes
    (oldest first) plus every span currently OPEN on the active tracer —
    what was in flight at the moment of death."""
    lines: List[str] = []
    notes = _DEFAULT.snapshot()[-limit:]
    t_ref = notes[-1]["ts"] if notes else time.time()
    for rec in notes:
        attrs = rec.get("attrs") or {}
        suffix = " ".join(f"{k}={v}" for k, v in attrs.items())
        lines.append(
            f"  {rec['ts'] - t_ref:+8.3f}s [{rec['kind']}] {rec['name']}"
            + (f" {suffix}" if suffix else "")
        )
    from keystone_tpu_torch.obs import tracer as tracer_mod

    t = tracer_mod.active_tracer()
    if t is not None:
        for sp in t.inflight():
            parent = sp.get("parent_id")
            lines.append(
                f"  IN FLIGHT: {sp['name']} (span {sp['span_id']}"
                + (f" < {parent}" if parent else "")
                + f", thread {sp['thread']})"
            )
    if not lines:
        return "flight record: (empty)"
    return "flight record (most recent last):\n" + "\n".join(lines)


def set_dump_dir(directory: Optional[str]) -> None:
    """Configure (or clear, with None) the on-disk flight-dump
    directory; ``KEYSTONE_FLIGHT_DUMPS=dir`` is the env form."""
    global _DUMP_DIR
    _DUMP_DIR = directory


def _dump_dir() -> Optional[str]:
    return _DUMP_DIR or os.environ.get(DUMP_DIR_ENV, "").strip() or None


def _write_dump_file(context: str, exc: Optional[BaseException],
                     rendered: str) -> Optional[str]:
    """Write one dump to a UNIQUE file under the configured dump dir
    (None when no dir is configured). ``O_EXCL`` creation: concurrent
    dumps — two replicas dying in the same tick — can NEVER clobber
    each other; a (theoretical) name collision retries with the next
    sequence number instead of truncating an existing postmortem."""
    directory = _dump_dir()
    if not directory:
        return None
    # The file is an AUGMENTATION of the loud log line, never a
    # precondition: an unwritable dump dir / full disk must not
    # propagate into dump_flight_record's last-resort guard and
    # swallow the warning the dump exists to emit.
    try:
        os.makedirs(directory, exist_ok=True)
        body = (
            f"context: {context}\n"
            + (f"exception: {exc!r}\n" if exc is not None else "")
            + rendered + "\n"
        )
        for _ in range(8):
            name = (
                f"flight-{time.time_ns()}-{os.getpid()}"
                f"-{next(_DUMP_SEQ):06d}.txt"
            )
            path = os.path.join(directory, name)
            try:
                fd = os.open(
                    path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644
                )
            except FileExistsError:  # pragma: no cover - seq is unique
                continue
            with os.fdopen(fd, "w") as f:
                f.write(body)
            return path
    except OSError:
        return None
    return None  # pragma: no cover - 8 collisions cannot happen


def dump_flight_record(
    context: str, exc: Optional[BaseException] = None,
    log: Optional[logging.Logger] = None, limit: int = 25,
) -> str:
    """The fault-path hook: render the ring (+ in-flight spans), log it
    loudly with the failure context, note the dump itself, write it to
    a unique file when a dump directory is configured (set_dump_dir /
    ``KEYSTONE_FLIGHT_DUMPS``), and return the rendered block (callers
    that can attach it to a report do). Never raises — a postmortem aid
    must not kill the path it serves."""
    try:
        rendered = render_flight_record(limit=limit)
        flight_note("dump", context, error=repr(exc) if exc else None)
        path = _write_dump_file(context, exc, rendered)
        (log or logger).warning(
            "%s%s\n%s%s", context,
            f": {exc!r}" if exc is not None else "", rendered,
            f"\nflight dump written: {path}" if path else "",
        )
        return rendered
    except Exception:  # pragma: no cover - last-resort guard
        return "flight record: (unavailable)"
