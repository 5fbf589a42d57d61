"""Deterministic, seedable fault injection + retry policy (the chaos
substrate of the reliability layer, docs/reliability.md; port of
``keystone_tpu/utils/faults.py``, whole).

KeystoneML inherited fault tolerance from Spark's RDD lineage; the
data plane here (disk shards, prefetch threads, a serving
worker) inherits nothing, so every recovery path must be *built* — and a
recovery path that was never executed is a recovery path that does not
work. This module makes executing them cheap and, critically,
REPLAYABLE: a :class:`FaultPlan` names the exact call sites and call
indices at which an ``IOError``, payload corruption, or latency spike
happens, so a chaos test that failed once fails identically forever.

Instrumented sites (each site counts its own calls, 0-based):

  - ``shard.load``    — one segment/field read inside the disk shard
                        classes (``data/shards.py``).
  - ``prefetch.read`` — one ``source.load`` on the Prefetcher's reader
                        thread (``data/prefetch.py``).
  - ``serving.execute`` — one batch execution inside the micro-batch
                        server's worker (``serving/batcher.py``).
  - ``serving.replica.execute`` — one batch execution on a replica
                        worker OUTSIDE the per-batch error guard
                        (``serving/replicas.py``): an injected error
                        here kills the whole replica worker (watchdog
                        + restart territory), not just one batch.
  - ``serving.replica.spawn`` — one replica (re)spawn attempt in the
                        replicated server's restart path; injected
                        errors burn the restart budget toward
                        permanent eviction.
  - ``serving.autoscale.spawn`` — one scale-up spawn attempt in
                        ``ReplicatedServer.add_replica``
                        (``serving/replicas.py``): injected errors are
                        absorbed by bounded retries within the restart
                        budget, so chaos tests can kill an autoscaler's
                        scale-up mid-flight and prove elasticity stays
                        zero-drop.
  - ``checkpoint.write`` — one snapshot write inside
                        ``CheckpointSpec.save`` (``data/durable.py``)
                        — fires on the write-behind runtime worker
                        (or inline for a synchronous spec), so chaos
                        tests can kill/fail/delay a snapshot while the
                        fold keeps running.
  - ``serving.zoo.page_in`` — one paged-weight decode task on the model
                        zoo's page lane (``serving/zoo.py``): error
                        rules are absorbed by the zoo's bounded
                        RetryPolicy (exhaustion quarantines the
                        tenant), corrupt rules flip a byte of a stored
                        weight plane — the per-tensor CRCs must catch
                        it and quarantine, never serve.
  - ``serving.zoo.page_out`` — one weight encode task on the zoo's
                        page lane: an injected kill mid-encode must
                        leave the previous RESIDENT copy authoritative
                        (nothing is published until the encode
                        completes).
  - ``image.decode``  — one segment decode inside the image-tier shard
                        source (``data/images.py``): decompressing the
                        encoded bytes for every image of one segment on
                        the prefetcher's read lane. Injected errors
                        exercise the same bounded-retry path as
                        ``prefetch.read``; decode wall time is reported
                        to the active :func:`observing_retries` stats as
                        per-site busy time under ``"decode"``.
  - ``image.augment`` — one segment augmentation pass (deterministic
                        seeded crop/flip) in the image-tier shard
                        source, also on the read lane and also reported
                        as per-site busy time (``"augment"``).
  - ``trainer.fit``    — one segment fold inside the continuous
                        trainer's incremental re-fit loop
                        (``learning/continuous.py``): an injected error
                        kills the trainer mid-fit — the chaos suite
                        proves a restarted trainer resumes from its
                        checkpoint BIT-IDENTICALLY and still publishes.
  - ``lifecycle.validate`` — one candidate validation pass in the
                        publication gate (``serving/lifecycle.py``): an
                        injected error is a gate-infrastructure failure
                        — the candidate is rejected loudly (audited,
                        ``ok=False``) and the serving plane is never
                        touched.
  - ``lifecycle.publish`` — one canary/promotion swap attempt in the
                        lifecycle controller: an injected error fails
                        the publication loudly while the incumbent plan
                        keeps serving (zero-drop — the swap machinery
                        re-enters the old plan on failure).
  - ``fleet.plane.spawn`` — one plane-process (re)spawn attempt in the
                        fleet router's watchdog (``serving/fleet.py``):
                        injected errors are absorbed by paced bounded
                        retries inside the per-plane restart budget;
                        exhaustion evicts the plane LOUDLY while the
                        surviving fleet keeps serving.
  - ``fleet.rpc.send`` — one router→plane RPC send
                        (``serving/fleet_rpc.py``), fired BEFORE any
                        bytes hit the wire so error rules are safely
                        retried (at-most-once preserved); corrupt rules
                        model wire corruption of a shipped weight plane
                        — the split-plane per-tensor CRCs must catch it
                        and quarantine the plane, never serve.

Activation is either lexical (``with plan.active():``) or ambient via
the ``KEYSTONE_FAULT_PLAN`` env var (a JSON plan, or ``@/path/to.json``)
— the env form is what ``run.py --fault-plan`` wires through for manual
chaos drills. With no active plan every hook is a counter-free no-op.

:class:`RetryPolicy` is the bounded-exponential-backoff companion:
transient-only (``OSError`` by default — a checksum failure is
*persistent* and must fail loud, never be retried into silence), with
deterministic jitter derived from (seed, site, call, attempt) so two
runs of the same plan back off identically.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "FaultError",
    "FaultPlan",
    "FaultRule",
    "RetryPolicy",
    "SITE_AUTOSCALE_SPAWN",
    "SITE_CHECKPOINT_WRITE",
    "SITE_FLEET_PLANE_SPAWN",
    "SITE_FLEET_RPC_SEND",
    "SITE_IMAGE_AUGMENT",
    "SITE_IMAGE_DECODE",
    "SITE_LIFECYCLE_PUBLISH",
    "SITE_LIFECYCLE_VALIDATE",
    "SITE_PREFETCH_READ",
    "SITE_REPLICA_EXECUTE",
    "SITE_REPLICA_SPAWN",
    "SITE_SERVING_EXECUTE",
    "SITE_SHARD_LOAD",
    "SITE_TRAINER_FIT",
    "SITE_ZOO_PAGE_IN",
    "SITE_ZOO_PAGE_OUT",
    "active_plan",
    "corrupt_array",
    "install",
    "maybe_fail",
    "observe_busy",
    "observe_retry",
    "observing_retries",
    "uninstall",
]

SITE_SHARD_LOAD = "shard.load"
SITE_PREFETCH_READ = "prefetch.read"
SITE_SERVING_EXECUTE = "serving.execute"
SITE_REPLICA_EXECUTE = "serving.replica.execute"
SITE_REPLICA_SPAWN = "serving.replica.spawn"
SITE_AUTOSCALE_SPAWN = "serving.autoscale.spawn"
SITE_CHECKPOINT_WRITE = "checkpoint.write"
SITE_IMAGE_DECODE = "image.decode"
SITE_IMAGE_AUGMENT = "image.augment"
SITE_ZOO_PAGE_IN = "serving.zoo.page_in"
SITE_ZOO_PAGE_OUT = "serving.zoo.page_out"
SITE_TRAINER_FIT = "trainer.fit"
SITE_LIFECYCLE_VALIDATE = "lifecycle.validate"
SITE_LIFECYCLE_PUBLISH = "lifecycle.publish"
SITE_FLEET_PLANE_SPAWN = "fleet.plane.spawn"
SITE_FLEET_RPC_SEND = "fleet.rpc.send"

_KINDS = ("error", "corrupt", "latency")
_EXC_TYPES: Dict[str, type] = {
    "OSError": OSError,
    "IOError": OSError,  # alias in py3
    "TimeoutError": TimeoutError,
    "RuntimeError": RuntimeError,
    "ValueError": ValueError,
}


class FaultError(OSError):
    """The default injected transient error: an OSError subclass so the
    retry layer treats it exactly like a real flaky read, while tests can
    still assert the failure was the *injected* one."""


class FaultRule:
    """One injection: at ``site``, on the call indices in ``calls``
    (0-based per-site counter) or with seeded probability ``p``, perform
    ``kind``:

      - ``error``:   raise ``exc`` (default :class:`FaultError`).
      - ``corrupt``: flip one byte of the payload handed to
                     :func:`corrupt_array` (checksum layers must catch it).
      - ``latency``: sleep ``latency_s`` before returning.

    ``count`` bounds how many times the rule fires (probability rules
    default to unbounded; call-list rules fire once per listed call).
    """

    def __init__(
        self,
        site: str,
        kind: str = "error",
        calls: Optional[Sequence[int]] = None,
        p: float = 0.0,
        count: Optional[int] = None,
        exc: str = "FaultError",
        message: str = "injected fault",
        latency_s: float = 0.0,
    ):
        if kind not in _KINDS:
            raise ValueError(f"fault kind {kind!r} not in {_KINDS}")
        if calls is None and p <= 0.0:
            raise ValueError("a FaultRule needs calls=[...] or p > 0")
        self.site = str(site)
        self.kind = kind
        self.calls = None if calls is None else frozenset(int(c) for c in calls)
        self.p = float(p)
        self.count = None if count is None else int(count)
        self.exc = str(exc)
        self.message = str(message)
        self.latency_s = float(latency_s)
        self.fired = 0

    def make_exception(self) -> BaseException:
        cls = _EXC_TYPES.get(self.exc, FaultError)
        if self.exc == "FaultError":
            cls = FaultError
        return cls(f"{self.message} [site={self.site} kind={self.kind}]")

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"site": self.site, "kind": self.kind}
        if self.calls is not None:
            d["calls"] = sorted(self.calls)
        if self.p:
            d["p"] = self.p
        if self.count is not None:
            d["count"] = self.count
        if self.kind == "error":
            d["exc"] = self.exc
        if self.latency_s:
            d["latency_s"] = self.latency_s
        return d


class FaultPlan:
    """A deterministic set of :class:`FaultRule` injections.

    Determinism contract: per-site call counters start at zero at
    install time, call-indexed rules fire at exactly the listed calls,
    and probabilistic rules draw from ``default_rng(seed ^ hash(site))``
    in per-site call order — so the same plan over the same workload
    injects the same faults, every run (the replayability every chaos
    test in tests/test_chaos.py leans on).

    Thread-safe: sites fire from reader/worker threads while the plan is
    installed from the main thread.
    """

    def __init__(self, rules: Sequence[FaultRule] = (), seed: int = 0):
        self.rules = list(rules)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._rngs: Dict[str, np.random.Generator] = {}
        self.log: List[Tuple[str, int, str]] = []  # (site, call, kind)

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_dict(spec: Dict[str, Any]) -> "FaultPlan":
        rules = [FaultRule(**r) for r in spec.get("rules", ())]
        return FaultPlan(rules, seed=int(spec.get("seed", 0)))

    @staticmethod
    def from_json(text: str) -> "FaultPlan":
        return FaultPlan.from_dict(json.loads(text))

    @staticmethod
    def from_env(env: str = "KEYSTONE_FAULT_PLAN") -> Optional["FaultPlan"]:
        """Parse the ambient plan: a JSON object, or ``@/path/to.json``.
        Returns None when the variable is unset/empty."""
        raw = os.environ.get(env, "").strip()
        if not raw:
            return None
        if raw.startswith("@"):
            with open(raw[1:]) as f:
                raw = f.read()
        return FaultPlan.from_json(raw)

    def to_dict(self) -> Dict[str, Any]:
        return {"seed": self.seed, "rules": [r.to_dict() for r in self.rules]}

    # -- firing ------------------------------------------------------------

    def _site_rng(self, site: str) -> np.random.Generator:
        rng = self._rngs.get(site)
        if rng is None:
            rng = np.random.default_rng(
                (self.seed ^ (zlib.crc32(site.encode()) & 0x7FFFFFFF))
            )
            self._rngs[site] = rng
        return rng

    def fire(
        self,
        site: str,
        counter: Optional[str] = None,
        kinds: Optional[Tuple[str, ...]] = None,
    ) -> Tuple[int, List[FaultRule]]:
        """Advance a call counter and return (call_index, rules matching
        ``site`` and ``kinds``). ``counter`` names the counter keyed
        (default: the site itself) — corruption hooks count under
        ``<site>.corrupt`` so error rules at the same site never shift
        corruption call indices, and ``kinds`` keeps each hook from
        consuming (or double-firing) the other hook's rules.
        Probability draws happen for every call of a p-rule's site,
        matched or not, so the draw sequence is a pure function of
        (seed, site, call order)."""
        counter = site if counter is None else counter
        with self._lock:
            call = self._counters.get(counter, 0)
            self._counters[counter] = call + 1
            matched = []
            for r in self.rules:
                if r.site != site:
                    continue
                if kinds is not None and r.kind not in kinds:
                    continue
                if r.count is not None and r.fired >= r.count:
                    continue
                hit = False
                if r.calls is not None:
                    hit = call in r.calls
                elif r.p > 0.0:
                    hit = bool(self._site_rng(site).random() < r.p)
                if hit:
                    r.fired += 1
                    matched.append(r)
                    self.log.append((site, call, r.kind))
            return call, matched

    def calls_seen(self, site: str) -> int:
        with self._lock:
            return self._counters.get(site, 0)

    # -- activation --------------------------------------------------------

    def active(self) -> "_Activation":
        """Context manager installing this plan for the dynamic extent
        (across ALL threads — reader/worker threads must see it)."""
        return _Activation(self)

    def __enter__(self) -> "FaultPlan":
        install(self)
        return self

    def __exit__(self, *exc) -> None:
        uninstall(self)


class _Activation:
    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def __enter__(self) -> FaultPlan:
        install(self.plan)
        return self.plan

    def __exit__(self, *exc) -> None:
        uninstall(self.plan)


_ACTIVE_LOCK = threading.Lock()
_ACTIVE: Optional[FaultPlan] = None
_ENV_CHECKED = False


def install(plan: FaultPlan) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is not None and _ACTIVE is not plan:
            raise RuntimeError(
                "a FaultPlan is already installed; nesting plans would make "
                "call counters ambiguous (uninstall the active plan first)"
            )
        _ACTIVE = plan


def uninstall(plan: Optional[FaultPlan] = None) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        if plan is None or _ACTIVE is plan:
            _ACTIVE = None


def active_plan() -> Optional[FaultPlan]:
    """The installed plan, resolving ``KEYSTONE_FAULT_PLAN`` once on
    first use (the ``run.py --fault-plan`` path installs ambiently)."""
    global _ENV_CHECKED, _ACTIVE
    if _ACTIVE is not None:
        return _ACTIVE
    if not _ENV_CHECKED:
        with _ACTIVE_LOCK:
            if not _ENV_CHECKED:
                _ENV_CHECKED = True
                plan = FaultPlan.from_env()
                if plan is not None:
                    _ACTIVE = plan
    return _ACTIVE


def _reset_env_cache() -> None:
    """Test hook: forget the memoized KEYSTONE_FAULT_PLAN lookup."""
    global _ENV_CHECKED
    with _ACTIVE_LOCK:
        _ENV_CHECKED = False


def maybe_fail(site: str) -> None:
    """Site hook for error/latency faults: raises or sleeps per the
    active plan; no-op (and counter-free) when no plan is installed."""
    plan = active_plan()
    if plan is None:
        return
    _, matched = plan.fire(site, kinds=("error", "latency"))
    for r in matched:
        if r.kind == "latency":
            time.sleep(r.latency_s)
        elif r.kind == "error":
            raise r.make_exception()


def corrupt_array(site: str, arr: np.ndarray) -> np.ndarray:
    """Site hook for corruption faults: when a ``corrupt`` rule fires,
    return a COPY of ``arr`` with one byte flipped (first byte XOR 0xFF
    — deterministic); otherwise return ``arr`` untouched. Shares the
    site counter with :func:`maybe_fail` callers only if they use
    distinct sites — corruption sites count independently via the
    ``<site>.corrupt`` counter so error rules at the same site never
    shift corruption call indices."""
    plan = active_plan()
    if plan is None:
        return arr
    _, matched = plan.fire(site, counter=site + ".corrupt",
                           kinds=("corrupt",))
    if not matched:
        return arr
    out = np.array(arr, copy=True)
    flat = out.view(np.uint8).reshape(-1)
    if flat.size:
        flat[0] ^= 0xFF
    return out


# -- retry observability ----------------------------------------------------
#
# Retries happen layers below the code that owns the fit's stats (the
# shard classes have no PrefetchStats handle, and one shards object can
# serve many fits). The observer is a THREAD-local slot the consuming
# layer (Prefetcher reader thread, or the serial segment loop) points at
# its stats for the duration of a load — every RetryPolicy in the stack
# then reports recovered transients into the right fit's counters, so
# "the fit survived flaky IO" is never structurally invisible.

_RETRY_TLS = threading.local()


class _RetryObservation:
    """Restore-on-exit guard for the thread's retry-stats slot."""

    def __init__(self, stats):
        self.stats = stats
        self.prev = None

    def __enter__(self):
        self.prev = getattr(_RETRY_TLS, "stats", None)
        _RETRY_TLS.stats = self.stats
        return self.stats

    def __exit__(self, *exc):
        _RETRY_TLS.stats = self.prev


def observing_retries(stats) -> _RetryObservation:
    """Route this thread's :func:`observe_retry` calls into ``stats``
    (an object with ``retries`` / ``backoff_s`` counters, e.g.
    PrefetchStats) for the context's duration; ``None`` silences."""
    return _RetryObservation(stats)


def observe_retry(delay_s: float) -> None:
    """Count one recovered transient (called from retry ``on_retry``
    hooks at any layer). No-op when the thread has no observer."""
    stats = getattr(_RETRY_TLS, "stats", None)
    if stats is not None:
        stats.retries += 1
        stats.backoff_s += float(delay_s)


def observe_busy(site: str, seconds: float) -> None:
    """Report per-site busy seconds into the thread's observer (the
    same thread-local channel as :func:`observe_retry`) — how the shard
    layer's checksum pass attributes its ``verify`` time to the
    consuming fit's :class:`~keystone_tpu_torch.data.prefetch.PrefetchStats`
    without holding a stats handle. No-op without an observer, or for
    observers without per-site accounting (``add_busy``)."""
    stats = getattr(_RETRY_TLS, "stats", None)
    if stats is not None and hasattr(stats, "add_busy"):
        stats.add_busy(site, float(seconds))


class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter.

    ``attempts`` counts TOTAL tries (so 3 means 2 retries). Retries only
    ``transient`` exception types (``OSError`` — which injected
    :class:`FaultError`\\ s subclass — by default); anything else,
    including :class:`~keystone_tpu_torch.data.durable.ShardCorrupted`,
    re-raises immediately: a checksum mismatch is persistent state, and
    retrying it would just re-read the same bad bytes while hiding the
    failure from the operator.

    Jitter is a pure function of (seed, key, attempt): two runs of the
    same plan back off by identical amounts, keeping chaos-test timing
    replayable. Exhaustion re-raises the LAST error unchanged, so
    callers observe exactly the pre-retry-layer failure mode.
    """

    def __init__(
        self,
        attempts: int = 3,
        base_delay_s: float = 0.02,
        max_delay_s: float = 2.0,
        jitter: float = 0.25,
        seed: int = 0,
        transient: Tuple[type, ...] = (OSError,),
    ):
        if attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {attempts}")
        self.attempts = int(attempts)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.jitter = float(jitter)
        self.seed = int(seed)
        self.transient = tuple(transient)

    def delay_s(self, attempt: int, key: str = "") -> float:
        """Backoff before retry number ``attempt`` (1-based): capped
        exponential plus deterministic jitter in [0, jitter] fractions
        of the base step."""
        base = min(
            self.base_delay_s * (2.0 ** (attempt - 1)), self.max_delay_s
        )
        h = zlib.crc32(f"{self.seed}:{key}:{attempt}".encode()) & 0xFFFFFFFF
        frac = (h / 0xFFFFFFFF) * self.jitter
        return min(base * (1.0 + frac), self.max_delay_s)

    def call(
        self,
        fn: Callable[[], Any],
        key: str = "",
        on_retry: Optional[Callable[[int, float, BaseException], None]] = None,
    ) -> Any:
        """Run ``fn`` with retries. ``on_retry(attempt, delay_s, exc)``
        fires before each backoff sleep (the stats-counter hook)."""
        last: Optional[BaseException] = None
        for attempt in range(1, self.attempts + 1):
            try:
                return fn()
            except self.transient as e:  # noqa: PERF203 — retry loop
                last = e
                if attempt == self.attempts:
                    raise
                d = self.delay_s(attempt, key)
                if on_retry is not None:
                    on_retry(attempt, d, e)
                time.sleep(d)
        raise last  # pragma: no cover — loop always returns or raises


def _env_number(name: str, default: str, cast, minimum):
    """Parse a numeric env knob, failing at PARSE time with one clear
    error naming the variable — a bad value must not surface as an
    unrelated TypeError deep inside a shard read's retry loop."""
    raw = os.environ.get(name, default)
    try:
        value = cast(raw)
    except (TypeError, ValueError):
        raise ValueError(
            f"{name}={raw!r} is not a valid {cast.__name__} "
            f"(unset it or set a number >= {minimum})"
        ) from None
    if value < minimum:
        raise ValueError(
            f"{name}={raw!r} must be >= {minimum}"
        )
    return value


def default_retry_policy() -> RetryPolicy:
    """The data plane's shared default policy; knobs ride env vars so
    drills can tighten/loosen without code changes:
    ``KEYSTONE_RETRY_ATTEMPTS`` (default 3, an int >= 1) and
    ``KEYSTONE_RETRY_BASE_S`` (default 0.02, a float >= 0). Invalid
    values raise one :class:`ValueError` naming the variable, here at
    policy construction — never mid-read."""
    return RetryPolicy(
        attempts=_env_number("KEYSTONE_RETRY_ATTEMPTS", "3", int, 1),
        base_delay_s=_env_number("KEYSTONE_RETRY_BASE_S", "0.02", float, 0.0),
    )
