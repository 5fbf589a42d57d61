"""Live exporter: a periodic publisher for long-lived serving processes
(port of ``keystone_tpu/obs/live.py``).

A traced run writes its trace when ``tracing()`` exits; a serving process
does not exit, so its signals must be readable while it runs. Two formats
from one collection pass:

  - **Prometheus text format** over a stdlib HTTP endpoint
    (``GET /metrics``; ``/healthz`` liveness; ``/snapshot.json`` the raw
    JSON), the scrape path;
  - **atomic JSON snapshot files** (``live_metrics.json`` through
    ``data/durable.py::atomic_write_json``: a reader sees the old snapshot
    or the whole new one, never a torn write), for scrape-less
    environments; ``python -m keystone_tpu_torch.tools.slo`` renders them.

One background publisher thread owns the cadence: every ``interval_s`` it
evaluates the SLO tracker (idle decay happens with zero traffic too),
calls every collector, renders both formats and counts
``exporter.publishes``. The publisher and the HTTP thread make no CUDA
call (no synchronize, no allocation, no tensor read): serving's CUDA
graphs replay on other threads, and a publisher that synchronized would
stall the batcher, so collectors read host-side ``stats()`` only.
Collector errors are counted and logged once, never fatal to the thread,
and ``close()`` joins both threads.

Sources are late-bound callables (``server.stats``, ``runtime.stats``, a
registry's ``snapshot``), so one exporter composes the whole picture
without owning any of it.
"""

from __future__ import annotations

import http.server
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

from keystone_tpu_torch.obs.metrics import (
    METRIC_EXPORTER_ERRORS,
    METRIC_EXPORTER_PUBLISHES,
    METRIC_EXPORTER_PUBLISH_S,
    MetricsRegistry,
)

__all__ = ["LiveExporter", "render_prometheus"]

logger = logging.getLogger("keystone_tpu_torch.obs.live")

SNAPSHOT_FILE = "live_metrics.json"

_PROM_PREFIX = "keystone"


def _prom_name(*parts: str) -> str:
    out = "_".join(p for p in parts if p)
    return "".join(
        c if (c.isalnum() or c == "_") else "_" for c in out
    ).strip("_")


def _split_registry_key(key: str) -> "tuple[str, Dict[str, str]]":
    """``name{k=v,...}.suffix`` (the registry snapshot key shape) →
    (``name_suffix``, labels)."""
    labels: Dict[str, str] = {}
    if "{" in key and "}" in key:
        head, rest = key.split("{", 1)
        inside, tail = rest.split("}", 1)
        for pair in inside.split(","):
            if "=" in pair:
                k, v = pair.split("=", 1)
                labels[k.strip()] = v.strip()
        key = head + tail
    return key, labels


def render_prometheus(doc: Mapping[str, Any]) -> str:
    """Project one collected snapshot document into Prometheus
    text-format. Numeric leaves only; nested dicts flatten into the
    metric name; registry-shaped keys (``name{k=v}.p99``) keep their
    labels as Prometheus labels. Strings/None are skipped — the JSON
    snapshot is the lossless view, this is the scrapeable one."""
    lines: List[str] = []

    def emit(name: str, labels: Dict[str, str], value: Any) -> None:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            return
        if labels:
            lbl = ",".join(
                f'{_prom_name(k)}="{v}"' for k, v in sorted(labels.items())
            )
            lines.append(f"{name}{{{lbl}}} {float(value):g}")
        else:
            lines.append(f"{name} {float(value):g}")

    def walk(prefix: str, obj: Any, labels: Dict[str, str]) -> None:
        if isinstance(obj, Mapping):
            for k, v in obj.items():
                key, extra = _split_registry_key(str(k))
                walk(_prom_name(prefix, key), v, {**labels, **extra})
        elif isinstance(obj, (list, tuple)):
            return  # sequences (ledgers, transition logs) are JSON-only
        else:
            emit(prefix, labels, obj)

    for section, payload in doc.items():
        if section in ("ts", "seq"):
            emit(_prom_name(_PROM_PREFIX, "exporter", section), {}, payload)
            continue
        walk(_prom_name(_PROM_PREFIX, str(section)), payload, {})
    return "\n".join(lines) + "\n"


class _Handler(http.server.BaseHTTPRequestHandler):
    exporter: "LiveExporter"  # set on the server class per exporter

    def do_GET(self):  # noqa: N802 - stdlib handler name
        ex = self.server.exporter  # type: ignore[attr-defined]
        if self.path.startswith("/healthz"):
            body, ctype = b"ok\n", "text/plain"
        elif self.path.startswith("/snapshot.json"):
            body = json.dumps(ex.last_snapshot()).encode()
            ctype = "application/json"
        elif self.path == "/" or self.path.startswith("/metrics"):
            body = ex.last_prometheus().encode()
            ctype = "text/plain; version=0.0.4"
        else:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # noqa: D102 - silence per-scrape log
        pass


class LiveExporter:
    """Periodic publisher over late-bound stat sources (module
    docstring).

    ``sources``: ``{section: callable-or-registry}`` — each tick, every
    callable runs and its dict lands under ``section`` in the snapshot;
    a :class:`MetricsRegistry` contributes its ``snapshot()``.
    ``slo``: an :class:`~keystone_tpu_torch.obs.slo.SLOTracker` — evaluated
    each tick (state decay under zero traffic) and rendered under the
    ``slo`` section. ``snapshot_dir``: atomic JSON snapshots land there.
    ``port``: serve HTTP on it (0 = ephemeral — read ``.port`` after
    construction); None disables the endpoint.
    """

    def __init__(
        self,
        sources: Optional[Mapping[str, Any]] = None,
        slo=None,
        snapshot_dir: Optional[str] = None,
        port: Optional[int] = None,
        interval_s: float = 1.0,
        host: str = "127.0.0.1",
    ):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self._sources: Dict[str, Callable[[], Any]] = {}
        for section, src in dict(sources or {}).items():
            if isinstance(src, MetricsRegistry):
                self._sources[section] = src.snapshot
            elif callable(src):
                self._sources[section] = src
            else:
                raise TypeError(
                    f"source {section!r} must be a callable or a "
                    f"MetricsRegistry, got {type(src).__name__}"
                )
        self._slo = slo
        self.snapshot_dir = snapshot_dir
        self.interval_s = float(interval_s)
        # The exporter's own accounting rides the same registry plane it
        # publishes, so "is the exporter alive" is itself scrapeable.
        self.metrics = MetricsRegistry()
        self._publishes = self.metrics.counter(METRIC_EXPORTER_PUBLISHES)
        self._errors = self.metrics.counter(METRIC_EXPORTER_ERRORS)
        self._publish_s = self.metrics.histogram(
            METRIC_EXPORTER_PUBLISH_S, maxlen=256
        )
        self._sources.setdefault("exporter", self.metrics.snapshot)

        self._lock = threading.Lock()
        self._doc: Dict[str, Any] = {}
        self._text = "# no publish yet\n"
        self._seq = 0
        self._error_logged = False
        self._stop = threading.Event()
        self._closed = False

        self._http = None
        self._http_thread = None
        self.port: Optional[int] = None
        if port is not None:
            self._http = http.server.ThreadingHTTPServer(
                (host, int(port)), _Handler
            )
            self._http.daemon_threads = True
            self._http.exporter = self  # type: ignore[attr-defined]
            self.port = self._http.server_address[1]
            self._http_thread = threading.Thread(
                target=self._http.serve_forever,
                name="keystone-obs-exporter-http", daemon=True,
            )
            self._http_thread.start()

        if snapshot_dir:
            os.makedirs(snapshot_dir, exist_ok=True)
        self._thread = threading.Thread(
            target=self._loop, name="keystone-obs-exporter", daemon=True
        )
        self._thread.start()

    # -- collection (publisher thread + publish_now callers) ---------------

    def _collect(self) -> Dict[str, Any]:
        doc: Dict[str, Any] = {"ts": time.time(), "seq": self._seq}
        if self._slo is not None:
            try:
                self._slo.evaluate()
                doc["slo"] = self._slo.verdict()
            except Exception as e:  # noqa: BLE001 — never thread-fatal
                self._note_error("slo", e)
        for section, fn in self._sources.items():
            try:
                doc[section] = fn()
            except Exception as e:  # noqa: BLE001 — never thread-fatal
                self._note_error(section, e)
        return doc

    def _note_error(self, section: str, exc: Exception) -> None:
        self._errors.add(1)
        if not self._error_logged:
            self._error_logged = True
            logger.warning(
                "live exporter: collector %r failed (%r) — counted on "
                "exporter.errors, further failures are silent",
                section, exc,
            )

    def publish_now(self) -> Dict[str, Any]:
        """One synchronous publish pass (collect → render → write);
        returns the snapshot document. The loop calls this every tick;
        tests and close() call it directly."""
        t0 = time.perf_counter()
        doc = self._collect()
        text = render_prometheus(doc)
        with self._lock:
            self._seq += 1
            self._doc = doc
            self._text = text
        if self.snapshot_dir:
            # Imported lazily: data/durable.py imports the obs package
            # at module scope, and a top-level import here would close
            # that cycle during package init.
            from keystone_tpu_torch.data.durable import atomic_write_json

            try:
                atomic_write_json(
                    os.path.join(self.snapshot_dir, SNAPSHOT_FILE), doc
                )
            except OSError as e:
                self._note_error("snapshot_write", e)
        self._publishes.add(1)
        self._publish_s.observe(time.perf_counter() - t0)
        return doc

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.publish_now()
            except Exception as e:  # noqa: BLE001 — keep publishing
                self._note_error("publish", e)

    # -- reading -----------------------------------------------------------

    def last_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._doc)

    def last_prometheus(self) -> str:
        with self._lock:
            return self._text

    # -- shutdown ----------------------------------------------------------

    def close(self, timeout: float = 5.0) -> None:
        """Stop publishing: one final publish (the snapshot file ends
        current, not one interval stale), then both threads join.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._thread.join(timeout=timeout)
        try:
            self.publish_now()
        except Exception:  # noqa: BLE001 — best-effort final write
            pass
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._http_thread.join(timeout=timeout)

    def __enter__(self) -> "LiveExporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
