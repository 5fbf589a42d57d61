"""Continuous trainer: incremental re-fit over arriving shard segments,
checkpoint-resumable, publishing through the serving lifecycle gate
(port of ``keystone_tpu/learning/continuous.py``).

Pipelines are *re-fit* as data arrives. :class:`ContinuousTrainer`
composes the existing ingredients rather than inventing new ones:

  - **The fold is a plain normal-equations accumulation** —
    ``G += XᵀX``, ``C += Xᵀy`` per segment, solved every K segments for
    a fresh ``LinearMapper`` candidate. Host numpy in float64: the fold
    is deterministic by construction, so the bit-identity resume
    contract below is a property of the carry snapshot, not of
    careful device bookkeeping. (The trainer deliberately does NO
    device work itself — candidate export happens inside the lifecycle
    controller's gate, which moves the weights onto the serving device.)
  - **Checkpoint/resume rides CheckpointSpec verbatim**
    (``data/durable.py``): the carry (G, C, n) snapshots every ``CheckpointSpec.every_segments``
    through the same write-behind lane, fingerprint-guarded, atomic,
    versioned. A trainer killed mid-fit (the ``trainer.fit`` fault
    site fires once per segment fold) restores the carry and cursor and
    refolds the remaining segments in the same order — the resumed
    carry is BIT-IDENTICAL to the uninterrupted one, so the candidate
    it publishes has the SAME plan fingerprint.
  - **Publication goes through the lifecycle controller** — never
    straight to the plane: every candidate passes the validation gate
    (finite weights, bucket bit-identity, held-out quality) and the
    canary window before any replica serves it. The trainer also hands
    the controller ``data_time`` — the arrival stamp of the newest
    segment the candidate covers — which is the start of the
    model-staleness clock.

:class:`TimedSegmentFeed` models "arriving shards" deterministically:
segments carry arrival offsets on an injectable clock, are
index-addressable (a resumed trainer re-reads exactly the segments an
uninterrupted one would have), and block the trainer until their
arrival time — no feeder thread, so the arrival schedule is replayable
by construction, the same discipline as ``utils/faults.py``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from keystone_tpu_torch.data.durable import resolve_checkpoint
from keystone_tpu_torch.obs.metrics import (
    METRIC_TRAINER_RESUMES,
    METRIC_TRAINER_SEGMENTS_FIT,
)
from keystone_tpu_torch.utils import faults

__all__ = ["ContinuousTrainer", "TimedSegmentFeed"]

logger = logging.getLogger("keystone_tpu_torch.learning")


class TimedSegmentFeed:
    """Arriving (X, y) segments with deterministic arrival stamps.

    ``segments`` is a sequence of ``(X, y)`` numpy pairs;
    ``arrival_offsets`` gives each segment's arrival time in seconds
    from :meth:`start` (non-decreasing; default 0 for every segment —
    everything already arrived, the unit-test shape). The feed is
    INDEX-ADDRESSABLE (:meth:`load`), which is what makes trainer
    resume bit-identical: segment i is segment i on every run.
    """

    def __init__(
        self,
        segments: Sequence[Tuple[Any, Any]],
        arrival_offsets: Optional[Sequence[float]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._segments = [
            (np.asarray(X), np.asarray(y)) for X, y in segments
        ]
        if not self._segments:
            raise ValueError("TimedSegmentFeed needs >= 1 segment")
        if arrival_offsets is None:
            offsets = [0.0] * len(self._segments)
        else:
            offsets = [float(t) for t in arrival_offsets]
        if len(offsets) != len(self._segments):
            raise ValueError(
                f"{len(offsets)} arrival offsets for "
                f"{len(self._segments)} segments"
            )
        if any(b < a for a, b in zip(offsets, offsets[1:])):
            raise ValueError("arrival_offsets must be non-decreasing")
        self._offsets = offsets
        self._clock = clock
        self._t0: Optional[float] = None

    def start(self) -> "TimedSegmentFeed":
        """Stamp the feed's epoch (idempotent): offsets are relative to
        the FIRST start, so a resumed trainer sees the original arrival
        stamps, not re-aged ones."""
        if self._t0 is None:
            self._t0 = self._clock()
        return self

    @property
    def num_segments(self) -> int:
        return len(self._segments)

    def available(self) -> int:
        """How many leading segments have arrived by now."""
        if self._t0 is None:
            return 0
        now = self._clock() - self._t0
        n = 0
        for off in self._offsets:
            if off <= now:
                n += 1
            else:
                break
        return n

    def arrival_time(self, i: int) -> float:
        """ABSOLUTE (clock-domain) arrival stamp of segment ``i`` — the
        staleness clock's start. Raises until :meth:`start`."""
        if self._t0 is None:
            raise RuntimeError("feed not started")
        return self._t0 + self._offsets[i]

    def load(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        return self._segments[i]

    def wait_for(self, i: int, stop: threading.Event,
                 poll_s: float = 0.01) -> bool:
        """Block until segment ``i`` has arrived (True) or ``stop`` is
        set (False). The wait is clock-driven, not event-driven, so a
        fake clock advances it deterministically under test."""
        if self._t0 is None:
            self.start()
        while self.available() <= i:
            if stop.wait(poll_s):
                return False
        return True


class ContinuousTrainer:
    """Incrementally re-fit a linear pipeline over arriving segments and
    publish every K segments through a lifecycle controller (module
    docstring).

    Knobs:

      - ``feed``: a :class:`TimedSegmentFeed` (or anything with its
        ``num_segments/load/arrival_time/wait_for`` surface).
      - ``controller``: the
        :class:`~keystone_tpu_torch.serving.lifecycle.LifecycleController`
        publications go through. ``None`` collects candidates on
        ``self.candidates`` instead (the unit-test shape) — a real
        deployment ALWAYS publishes through the gate.
      - ``publish_every_k``: candidate cadence in segments (the final
        segment always publishes, so a feed tail shorter than K is
        never silently unfitted).
      - ``lam``: ridge regularizer of the incremental solve.
      - ``checkpoint``: CheckpointSpec | directory | None (None
        consults ``KEYSTONE_CHECKPOINT_DIR`` — the ``run.py
        --checkpoint-dir`` wiring, same as the streamed solvers).
      - ``metrics``: registry for ``trainer.segments_fit`` /
        ``trainer.resumes`` (defaults to the controller plane's).

    Thread contract: :meth:`run` does host-only numpy work plus calls
    into the controller (whose gate owns any device work); it may run
    inline (tests) or on the :meth:`start` thread. A crash mid-fit is
    recorded on ``self.error`` and logged loudly — the recovery story
    is a NEW trainer over the same feed + checkpoint directory, which
    resumes from the snapshot bit-identically.
    """

    def __init__(
        self,
        feed: TimedSegmentFeed,
        controller=None,
        publish_every_k: int = 4,
        lam: float = 1e-3,
        checkpoint=None,
        source_id: str = "continuous",
        metrics=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if publish_every_k < 1:
            raise ValueError("publish_every_k must be >= 1")
        self.feed = feed
        self.controller = controller
        self.publish_every_k = int(publish_every_k)
        self.lam = float(lam)
        self.checkpoint = checkpoint
        self.source_id = str(source_id)
        self._clock = clock

        self._lock = threading.Lock()
        self.segments_fit = 0
        self.resumes = 0
        self.publishes = 0
        self.error: Optional[BaseException] = None
        self.results: List[Dict[str, Any]] = []
        self.candidates: List[Any] = []  # controller=None collection

        reg = metrics
        if reg is None and controller is not None:
            reg = getattr(getattr(controller, "plane", None),
                          "metrics", None)
        self._metrics = reg
        if reg is not None:
            self._c_segments = reg.counter(METRIC_TRAINER_SEGMENTS_FIT)
            self._c_resumes = reg.counter(METRIC_TRAINER_RESUMES)

        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ContinuousTrainer":
        """Run :meth:`run` on a background thread (idempotent)."""
        with self._lock:
            if self._thread is not None:
                return self
            self._thread = threading.Thread(
                target=self._run_guarded,
                name="keystone-continuous-trainer", daemon=True,
            )
            self._thread.start()
        return self

    # lint: device-owner-thread: the trainer offers candidates, whose gate runs on the card
    def _run_guarded(self) -> None:
        try:
            self.run()
        except BaseException as e:  # noqa: BLE001 — recorded, loud
            self.error = e
            logger.warning(
                "continuous trainer DIED mid-fit: %r — restart it over "
                "the same feed and checkpoint directory to resume "
                "bit-identically", e,
            )

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: float = 30.0) -> None:
        """Join the trainer thread (the shutdown path — a trainer that
        finished its feed has already exited)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    # -- the fit loop ------------------------------------------------------

    def _fingerprint(self, d: int, k: int) -> Dict[str, Any]:
        """The checkpoint identity: fit kind + geometry + regularizer +
        source — a snapshot from a different feed or λ can never seed
        this carry (CheckpointSpec contract)."""
        return {
            "fit": "continuous_linear",
            "d": int(d), "k": int(k), "lam": self.lam,
            "source": self.source_id,
            "num_segments": self.feed.num_segments,
        }

    def run(self) -> Dict[str, Any]:
        """Fold the feed to completion, publishing every K segments.
        Returns the final stats block."""
        feed = self.feed.start()
        X0, y0 = feed.load(0)
        d = int(X0.shape[-1])
        k = int(y0.shape[-1]) if y0.ndim > 1 else 1
        fingerprint = self._fingerprint(d, k)
        ckpt = resolve_checkpoint(self.checkpoint)

        G = np.zeros((d, d), np.float64)
        C = np.zeros((d, k), np.float64)
        n = np.zeros((1,), np.float64)
        start = 0
        if ckpt is not None:
            arrays, start = ckpt.restore(fingerprint)
            if arrays is not None:
                G, C, n = arrays
                # Restored buffers are read-only views of the snapshot
                # blob; the fold mutates in place.
                G = np.array(G, copy=True)
                C = np.array(C, copy=True)
                n = np.array(n, copy=True)
                with self._lock:
                    self.resumes += 1
                if self._metrics is not None:
                    self._c_resumes.add(1)
                logger.warning(
                    "continuous trainer RESUMED from checkpoint at "
                    "segment %d (%s)", start, self.source_id,
                )

        num = feed.num_segments
        for i in range(start, num):
            if not feed.wait_for(i, self._stop):
                break  # stopped while waiting for an arrival
            # The chaos hook: one fire per segment fold — an injected
            # error here IS the killed-trainer scenario.
            faults.maybe_fail(faults.SITE_TRAINER_FIT)
            X, y = feed.load(i)
            Xf = X.astype(np.float64, copy=False)
            yf = y.reshape(len(y), -1).astype(np.float64, copy=False)
            G += Xf.T @ Xf
            C += Xf.T @ yf
            n[0] += len(Xf)
            with self._lock:
                self.segments_fit += 1
            if self._metrics is not None:
                self._c_segments.add(1)
            if ckpt is not None:
                ckpt.maybe_save([G, C, n], i, num, fingerprint)
            if (i + 1) % self.publish_every_k == 0 or (i + 1) == num:
                self._publish(G, C, i)
        if ckpt is not None and not self._stop.is_set():
            # Completed: the snapshot is spent (same contract as the
            # streamed solvers — a later identical fit starts fresh).
            ckpt.clear(fingerprint)
        return self.stats()

    def _solve(self, G: np.ndarray, C: np.ndarray) -> np.ndarray:
        d = G.shape[0]
        return np.linalg.solve(
            G + self.lam * np.eye(d, dtype=np.float64), C
        ).astype(np.float32)

    def _candidate(self, G: np.ndarray, C: np.ndarray):
        """Solve the current carry into a transformer-only
        FittedPipeline candidate: its weights on the host (the gate
        exports it onto the serving device — this module stays
        host-only)."""
        from keystone_tpu_torch.ops.learning.linear import LinearMapper
        from keystone_tpu_torch.workflow.pipeline import (
            FittedPipeline,
            TransformerGraph,
        )

        pipe = LinearMapper(self._solve(G, C)).to_pipeline()
        return FittedPipeline(
            TransformerGraph.from_graph(pipe.executor.graph),
            pipe.source, pipe.sink,
        )

    def _publish(self, G: np.ndarray, C: np.ndarray,
                 segment: int) -> None:
        candidate = self._candidate(G, C)
        with self._lock:
            self.publishes += 1
        if self.controller is None:
            self.candidates.append(candidate)
            return
        result = self.controller.offer(
            candidate,
            data_time=self.feed.arrival_time(segment),
            context={"segments_covered": segment + 1},
        )
        with self._lock:
            self.results.append(result)

    # -- reading -----------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            results = list(self.results)
            out = {
                "segments_fit": self.segments_fit,
                "resumes": self.resumes,
                "publishes": self.publishes,
                "published": sum(
                    1 for r in results if r.get("published")
                ),
                # NOT "gate_rejected": a canary rollback or a publish
                # failure also lands here — the controller's stats()
                # holds the per-reason books; this is just the
                # trainer's view of its own offers.
                "not_published": sum(
                    1 for r in results
                    if not r.get("published")
                ),
                "num_segments": self.feed.num_segments,
                "publish_every_k": self.publish_every_k,
                "error": repr(self.error) if self.error else None,
            }
        return out
