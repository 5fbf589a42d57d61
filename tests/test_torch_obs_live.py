"""The port's live exporter and SLO snapshot renderer against the JAX
package, on the CPU.

``obs.live.render_prometheus`` is held byte for byte to the reference's on
one snapshot document (labelled registry keys, nested sections, skipped
strings, bools, None and sequences); ``tools.slo.render`` likewise on one
snapshot carrying every section it draws. The exporter itself: one publish
collects, renders and writes the snapshot atomically; the HTTP endpoints
answer on an ephemeral port; the publisher ticks; a failing collector is
counted and never fatal; ``close`` publishes once more and joins both
threads; ``run.py serve --metrics-port / --metrics-dir`` publishes while it
serves, and the exporter's threads make no CUDA call.
"""

import json
import os
import threading
import time
import urllib.request

import pytest
import torch

from keystone_tpu_torch import obs
from keystone_tpu_torch.obs import live
from keystone_tpu_torch.obs.metrics import MetricsRegistry
from keystone_tpu_torch.tools import slo as slo_cli

from keystone_tpu.obs import live as jlive
from keystone_tpu.tools import slo as jslo_cli

SNAPSHOT = {
    "ts": 1700000000.5,
    "seq": 7,
    "metrics": {
        "serving.completed": 120,
        "serving.latency_s{replica=r0}.p99": 0.0123,
        "serving.latency_s{replica=r1,stage=exec}.count": 40,
        "placement.decisions": 3.0,
        "flag": True,
        "label": "text",
        "missing": None,
    },
    "serving": {"completed": 120, "rejected": 2, "failed": 0, "p99_latency_s": 0.0123,
                "per_replica": {"r0": {"completed": 60}, "r1": {"completed": 60}},
                "fingerprints": ["a", "b"], "healthy_replicas": 2},
    "slo": {
        "state": "WARN",
        "objectives": {
            "latency": {"state": "WARN", "burn_fast": 2.5, "burn_slow": 1.1,
                        "budget_spent_fraction": 0.31, "budget_remaining_fraction": 0.69,
                        "good_total": 990, "bad_total": 10,
                        "transitions": [{"t_s": 1.25, "from": "OK", "to": "WARN",
                                         "burn_fast": 2.5, "budget_spent_fraction": 0.2}],
                        "ledger": [{"state": "OK", "t_start": 0.0, "t_end": 1.25,
                                    "good": 900, "bad": 2},
                                   {"state": "WARN", "t_start": 1.25, "t_end": None,
                                    "good": 90, "bad": 8}]},
            "availability": {"state": "OK", "burn_fast": 0.0, "burn_slow": 0.0,
                             "budget_spent_fraction": 0.0, "budget_remaining_fraction": 1.0,
                             "good_total": 1000, "bad_total": 0},
        },
    },
    "autoscale": {"replicas": 2, "min_replicas": 1, "max_replicas": 3, "replicas_low": 1,
                  "replicas_high": 2, "scale_ups": 1, "scale_downs": 0, "brownout_level": 0,
                  "decisions": [{"t_s": 0.5, "action": "scale_up", "reason": "burn",
                                 "inputs": {"state": "WARN", "burn_fast": 2.5, "replicas": 1,
                                            "queue_depth": 4}}]},
    "lifecycle": {"published": 3, "rejected": 1, "rollbacks": 0, "canary_promotions": 2,
                  "staleness_s": 0.5, "staleness_median_s": 0.4, "staleness_num_samples": 3,
                  "incumbent_fingerprint": "abc",
                  "decisions": [{"t_s": 0.1, "action": "publish", "fingerprint": "abc",
                                 "reason": "gate ok"}]},
    "trainer": {"segments_fit": 8, "num_segments": 8, "resumes": 0, "publishes": 2},
    "zoo": {"num_tenants": 2, "residents": 1, "resident_bytes": 100, "budget_bytes": 150,
            "page_ins": 3, "page_outs": 2, "quarantined": 0, "coldstart_failfast": 0,
            "accounting_ok": True,
            "tenants": {"a": {"resident": True, "admission_share": 0.5, "offered": 10,
                              "completed": 10, "rejected": 0, "failed": 0,
                              "slo": {"state": "OK", "objectives": {"latency": {
                                  "burn_fast": 0.1, "burn_slow": 0.1,
                                  "budget_spent_fraction": 0.01}}}},
                        "b": {"resident": False, "admission_share": 0.5, "offered": 5,
                              "completed": 4, "rejected": 1, "failed": 0}},
            "decisions": [{"t_s": 0.2, "action": "page_in", "tenant": "b",
                           "reason": "fault"}]},
}


class TestRender:
    def test_prometheus_text_equals_the_reference(self):
        text = live.render_prometheus(SNAPSHOT)
        assert text == jlive.render_prometheus(SNAPSHOT)
        assert 'keystone_metrics_serving_latency_s_p99{replica="r0"} 0.0123' in text
        assert "keystone_exporter_seq 7" in text
        assert "label" not in text and "fingerprints" not in text and "flag" not in text

    def test_slo_render_equals_the_reference(self):
        doc = {k: v for k, v in SNAPSHOT.items() if k != "ts"}  # no age line
        out = slo_cli.render(doc)
        assert out == jslo_cli.render(doc)
        for part in ("SLO verdict: WARN", "latency transitions", "budget ledger",
                     "autoscale: replicas=2", "lifecycle: published=3", "trainer:",
                     "zoo: tenants=2", "serving: completed=120"):
            assert part in out, part

    def test_slo_cli_reads_a_directory_and_fails_on_a_missing_one(self, tmp_path, capsys):
        d = tmp_path / "m"
        d.mkdir()
        (d / live.SNAPSHOT_FILE).write_text(json.dumps(SNAPSHOT))
        assert slo_cli.main([str(d)]) == 0
        assert "SLO verdict: WARN" in capsys.readouterr().out
        assert slo_cli.main([str(tmp_path / "nope")]) == 1
        (d / live.SNAPSHOT_FILE).write_text("{}")
        assert slo_cli.main([str(d)]) == 1


class TestLiveExporter:
    def test_publish_collects_renders_and_snapshots(self, tmp_path):
        reg = MetricsRegistry()
        reg.counter("serving.completed").add(5)
        calls = []

        def serving():
            calls.append(threading.current_thread().name)
            return {"completed": 5}

        with live.LiveExporter(sources={"metrics": reg, "serving": serving},
                               snapshot_dir=str(tmp_path), interval_s=60.0) as ex:
            doc = ex.publish_now()
            assert doc["serving"] == {"completed": 5}
            assert doc["metrics"]["serving.completed"] == 5
            with open(tmp_path / live.SNAPSHOT_FILE) as f:
                assert json.load(f)["seq"] == doc["seq"]
            assert "keystone_serving_completed 5" in ex.last_prometheus()
            assert ex.last_prometheus() == live.render_prometheus(ex.last_snapshot())
        assert not [f for f in os.listdir(tmp_path) if f != live.SNAPSHOT_FILE]

    def test_http_endpoints(self):
        with live.LiveExporter(sources={"serving": lambda: {"completed": 3}}, port=0,
                               interval_s=60.0) as ex:
            ex.publish_now()
            base = f"http://127.0.0.1:{ex.port}"
            body = urllib.request.urlopen(base + "/metrics", timeout=10).read().decode()
            assert "keystone_serving_completed 3" in body
            assert urllib.request.urlopen(base + "/healthz", timeout=10).read() == b"ok\n"
            snap = json.loads(urllib.request.urlopen(base + "/snapshot.json", timeout=10).read())
            assert snap["serving"] == {"completed": 3}
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(base + "/nope", timeout=10)

    def test_publisher_ticks_and_close_joins_both_threads(self, tmp_path):
        ex = live.LiveExporter(sources={}, snapshot_dir=str(tmp_path), port=0,
                               interval_s=0.02)
        deadline = time.time() + 10
        while ex.metrics.snapshot().get("exporter.publishes", 0) < 3 and time.time() < deadline:
            time.sleep(0.01)
        assert ex.metrics.snapshot()["exporter.publishes"] >= 3
        before = ex.metrics.snapshot()["exporter.publishes"]
        ex.close()
        ex.close()  # idempotent
        assert ex.metrics.snapshot()["exporter.publishes"] >= before + 1  # the final one
        assert not ex._thread.is_alive() and not ex._http_thread.is_alive()

    def test_collector_error_is_counted_never_fatal(self):
        def broken():
            raise RuntimeError("collector broke")

        with live.LiveExporter(sources={"bad": broken, "good": lambda: {"x": 1}},
                               interval_s=60.0) as ex:
            doc = ex.publish_now()
            ex.publish_now()
            assert doc["good"] == {"x": 1} and "bad" not in doc
            assert ex.metrics.snapshot()["exporter.errors"] == 2

    def test_validation(self):
        with pytest.raises(ValueError):
            live.LiveExporter(interval_s=0)
        with pytest.raises(TypeError):
            live.LiveExporter(sources={"x": 3})


SERVE_TINY = ["serve", "--device", "cpu", "--input-dim", "32", "--numFFTs", "2",
              "--blockSize", "32", "--fit-n", "128", "--max-batch", "8", "--rate", "200",
              "--duration-s", "0.6"]


class TestServeLivePlane:
    def test_serve_publishes_and_its_threads_make_no_cuda_call(self, tmp_path, capsys,
                                                                monkeypatch):
        """The exporter's publisher and HTTP threads read host-side stats
        only: a CUDA synchronize, cache release or allocation from them
        would stall the card's batcher."""
        from keystone_tpu_torch import run

        seen = []

        def recorder(name):
            def hook(*a, **k):
                seen.append((name, threading.current_thread().name))
            return hook

        for name in ("synchronize", "empty_cache", "current_stream"):
            monkeypatch.setattr(torch.cuda, name, recorder(name))
        d = tmp_path / "m"
        rc = run.main(SERVE_TINY + ["--metrics-port", "0", "--metrics-dir", str(d),
                                    "--metrics-interval-s", "0.05", "--slo-p99-ms", "100"])
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0 and summary["metrics_port"] > 0
        with open(d / live.SNAPSHOT_FILE) as f:
            doc = json.load(f)
        assert doc["exporter"]["exporter.publishes"] >= 2
        assert doc["serving"]["completed"] == summary["num_samples"]
        assert doc["slo"]["state"] in ("OK", "WARN", "BREACH")
        assert "runtime" in doc and "slo_metrics" in doc
        assert not [s for s in seen if s[1].startswith("keystone-obs-exporter")]
        assert slo_cli.main([str(d)]) == 0
        assert "serving: completed=" in capsys.readouterr().out

    def test_obs_exports_what_the_reference_exports(self):
        import keystone_tpu.obs as jobs

        assert sorted(obs.__all__) == sorted(jobs.__all__)
        assert obs.LiveExporter is live.LiveExporter
