"""The port's obs plane (``keystone_tpu_torch/obs/``) against the
reference's on the CPU, exactly (host-side logic: no tolerance).

  - histograms: the same samples into both packages' ``BucketedHistogram``
    give the same buckets, percentiles, merges and serialized states;
    ``MetricsRegistry`` snapshots have the same keys and values;
  - SLO: the same event stream under the same fake clock gives the same
    ``SLOTracker`` states, transitions, burn rates and budget ledger;
  - the tracer: spans, events and counters nest and carry one ``run_id``;
    ``write_trace_dir`` writes the same files with the same keys as the
    reference's, and the Chrome trace validates;
  - the flight recorder keeps a bounded ring and renders it;
  - the metric-name catalogue is the reference's.
"""

import json
import os

import numpy as np
import pytest

from keystone_tpu_torch import obs
from keystone_tpu_torch.obs import flight, metrics, slo, tracer


def _samples(seed=0, n=500):
    rng = np.random.default_rng(seed)
    return list(rng.lognormal(mean=-5.0, sigma=1.2, size=n))


def _slo_stream(seed=3, n=400):
    """(dt, latency_s or None, ok) events: healthy, then a burst of slow
    and failed requests, then healthy again."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        bad_phase = 150 <= i < 230
        ok = not (bad_phase and rng.random() < 0.3)
        lat = float(rng.uniform(0.001, 0.02)) * (6.0 if bad_phase else 1.0)
        out.append((0.05, lat if ok else None, ok))
    return out


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _drive_tracker(slo_mod, stream):
    clock = FakeClock()
    tracker = slo_mod.SLOTracker([
        slo_mod.SLOObjective("latency", kind="latency", threshold_s=0.05, target=0.95,
                             fast_window_s=2.0, slow_window_s=10.0),
        slo_mod.SLOObjective("availability", kind="availability", target=0.99,
                             fast_window_s=2.0, slow_window_s=10.0),
    ], clock=clock)
    states = []
    for dt, lat, ok in stream:
        clock.t += dt
        tracker.observe(latency_s=lat, ok=ok)
        states.append(tracker.states())
    clock.t += 30.0
    tracker.evaluate()
    verdict = tracker.verdict()
    for o in verdict["objectives"].values():
        o.pop("transitions", None)  # carry wall stamps of the fake clock only
    return states, verdict, tracker.burn_rates()


class TestHistogramsAgainstReference:
    def test_same_buckets_and_percentiles(self):
        from keystone_tpu.obs.metrics import BucketedHistogram as J

        t, j = metrics.BucketedHistogram(), J()
        for v in _samples():
            t.observe(v)
            j.observe(v)
        assert t.stats_snapshot() == j.stats_snapshot()
        for q in (0, 1, 50, 90, 99, 99.9, 100):
            assert t.percentile(q) == j.percentile(q)
        assert t.state_dict() == j.state_dict()

    def test_same_merges(self):
        from keystone_tpu.obs.metrics import BucketedHistogram as J

        parts = [_samples(seed) for seed in range(3)]
        t_parts, j_parts = [], []
        for p in parts:
            t, j = metrics.BucketedHistogram(), J()
            for v in p:
                t.observe(v)
                j.observe(v)
            t_parts.append(t)
            j_parts.append(j)
        t_all, j_all = metrics.BucketedHistogram(), J()
        for t, j in zip(t_parts, j_parts):
            t_all.merge(t)
            j_all.merge(j)
        assert t_all.state_dict() == j_all.state_dict()
        assert t_all.percentile(99) == j_all.percentile(99)
        # Cross-package state hand-off: a port histogram merges the
        # reference's serialized state exactly as its own.
        t_from_j = metrics.BucketedHistogram()
        for j in j_parts:
            t_from_j.merge_state(json.loads(json.dumps(j.state_dict())))
        assert t_from_j.state_dict() == t_all.state_dict()

    def test_edge_cases_match(self):
        from keystone_tpu.obs.metrics import BucketedHistogram as J

        t, j = metrics.BucketedHistogram(), J()
        assert t.percentile(50) is None and j.percentile(50) is None
        t.observe(0.0123)
        j.observe(0.0123)
        assert t.percentile(1) == j.percentile(1) == 0.0123
        with pytest.raises(ValueError):
            t.percentile(101)

    def test_registry_snapshot_is_the_references(self):
        from keystone_tpu.obs.metrics import MetricsRegistry as J

        regs = (metrics.MetricsRegistry(), J())
        for r in regs:
            r.counter(metrics.METRIC_SERVING_COMPLETED).add(7)
            r.counter(metrics.METRIC_SERVING_REJECTED).add(2)
            r.gauge(metrics.METRIC_SERVING_QUEUE_DEPTH).set(3.0)
            h = r.bucketed_histogram(metrics.METRIC_SERVING_LATENCY_S)
            for v in _samples(seed=4, n=50):
                h.observe(v)
            hist = r.histogram(metrics.METRIC_SERVING_LATENCY_S, replica="0")
            for v in (0.001, 0.002, 0.004):
                hist.observe(v)
        assert regs[0].snapshot() == regs[1].snapshot()

    def test_catalogue_is_the_references(self):
        from keystone_tpu.obs import metrics as j_metrics

        names = {k: v for k, v in vars(metrics).items() if k.startswith("METRIC_")}
        j_names = {k: v for k, v in vars(j_metrics).items() if k.startswith("METRIC_")}
        assert names == j_names
        assert metrics.__all__ == j_metrics.__all__


class TestSLOAgainstReference:
    def test_same_states_verdicts_and_budgets(self):
        from keystone_tpu.obs import slo as j_slo

        stream = _slo_stream()
        t_states, t_verdict, t_burns = _drive_tracker(slo, stream)
        j_states, j_verdict, j_burns = _drive_tracker(j_slo, stream)
        assert t_states == j_states
        assert t_verdict == j_verdict
        assert t_burns == j_burns
        seen = {s for states in t_states for s in states.values()}
        assert {slo.STATE_OK, slo.STATE_BREACH} <= seen  # the stream moved it

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_same_verdict_on_random_streams(self, seed):
        from keystone_tpu.obs import slo as j_slo

        stream = _slo_stream(seed=seed, n=250)
        assert _drive_tracker(slo, stream)[1] == _drive_tracker(j_slo, stream)[1]

    def test_publishes_into_a_registry(self):
        reg = obs.MetricsRegistry()
        tracker = obs.SLOTracker([obs.SLOObjective("availability", kind="availability",
                                                   min_events=1)], metrics=reg)
        tracker.observe(ok=False)
        tracker.evaluate()
        snap = reg.snapshot()
        assert any(k.startswith(metrics.METRIC_SLO_STATE) for k in snap)

    def test_validation(self):
        with pytest.raises(ValueError):
            obs.SLOTracker([])
        with pytest.raises(ValueError):
            obs.SLOTracker([obs.SLOObjective("a", kind="availability"),
                            obs.SLOObjective("a", kind="availability")])


class TestTracer:
    def test_spans_nest_under_one_run_id(self):
        with obs.tracing() as t:
            with obs.span("outer", kind="test"):
                with obs.span("inner"):
                    obs.event("tick", n=1)
        recs = t.events
        spans = {r["name"]: r for r in recs if r.get("type") == "span"}
        assert {"outer", "inner"} <= set(spans)
        assert len({r["run_id"] for r in recs}) == 1
        assert spans["inner"]["parent_id"] == spans["outer"]["span_id"]

    def test_disabled_is_a_no_op(self):
        assert not obs.enabled()
        with obs.span("nothing"):
            obs.event("nothing")

    def test_nested_activation_raises(self):
        with obs.tracing():
            with pytest.raises(RuntimeError, match="already active"):
                with obs.tracing():
                    pass

    def test_write_trace_dir_same_files_and_keys_as_the_reference(self, tmp_path):
        from keystone_tpu import obs as j_obs

        def run(mod, directory):
            with mod.tracing(str(directory), run_id="fixed-run"):
                with mod.span("serve", kind="serving"):
                    mod.event("request", ok=True)
                mod.counter_track("queue_depth", 3)
            meta = json.loads((directory / "meta.json").read_text())
            trace = json.loads((directory / "trace.json").read_text())
            events = [json.loads(line) for line in
                      (directory / "events.jsonl").read_text().splitlines()]
            return (sorted(os.listdir(directory)), sorted(meta),
                    sorted(trace), [sorted(e) for e in events],
                    sorted({e.get("name") for e in events}), trace)

        t = run(obs, tmp_path / "t")
        j = run(j_obs, tmp_path / "j")
        assert t[:5] == j[:5]
        assert obs.validate_chrome_trace(t[5]) == []
        assert obs.load_events(str(tmp_path / "t"))

    def test_tail_sampler_keeps_errors(self):
        from keystone_tpu.obs import TailSampler as J

        for cls in (obs.TailSampler, J):
            sampler = cls(head_rate=0.25, slow_s=1.0)
            got = [sampler.keep(0.001, flagged=True), sampler.keep(2.0)]
            got += [sampler.keep(0.001) for _ in range(8)]
            assert got[:2] == [(True, "flagged"), (True, "slow")]
            assert [k for k, _ in got[2:]].count(True) == 2
        t, j = obs.TailSampler(head_rate=0.1), J(head_rate=0.1)
        assert [t.keep(0.01) for _ in range(40)] == [j.keep(0.01) for _ in range(40)]

    def test_tracing_from_env(self, tmp_path, monkeypatch):
        monkeypatch.setenv(tracer.TRACE_ENV, str(tmp_path / "env"))
        with obs.tracing_from_env() as t:
            obs.event("hello")
        assert t is not None
        assert (tmp_path / "env" / "trace.json").exists()
        monkeypatch.setenv(tracer.TRACE_SAMPLE_ENV, "2.0")
        with pytest.raises(ValueError, match=tracer.TRACE_SAMPLE_ENV):
            obs.tracing_from_env()

    def test_xla_profile_leg_writes_a_torch_profiler_trace(self, tmp_path):
        import torch

        with obs.tracing(str(tmp_path), xla_profile=True):
            torch.ones(8).sum()
        doc = json.loads((tmp_path / "xla" / "trace.json").read_text())
        assert "traceEvents" in doc


class TestFlightRecorder:
    def test_bounded_ring_and_render(self):
        rec = flight.FlightRecorder(maxlen=4)
        for i in range(10):
            rec.note("event", f"e{i}", i=i)
        snap = rec.snapshot()
        assert [r["name"] for r in snap] == ["e6", "e7", "e8", "e9"]
        rec.clear()
        assert rec.snapshot() == []

    def test_same_ring_as_the_reference(self):
        from keystone_tpu.obs import flight as j_flight

        t, j = flight.FlightRecorder(maxlen=3), j_flight.FlightRecorder(maxlen=3)
        for rec in (t, j):
            for i in range(5):
                rec.note("k", f"n{i}", i=i)
        strip = lambda snap: [{k: v for k, v in r.items() if k not in ("t", "ts", "thread")}
                              for r in snap]
        assert strip(t.snapshot()) == strip(j.snapshot())

    def test_module_level_notes_render(self):
        obs.flight_note("serving", "breaker_open", replica=1)
        assert any(r["name"] == "breaker_open" for r in obs.flight_snapshot())
        assert "breaker_open" in obs.render_flight_record()
