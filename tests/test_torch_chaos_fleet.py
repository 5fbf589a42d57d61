"""The port's serving-fleet chaos suite on the CPU (planes spawned with
``plane_cfg={"device": "cpu"}``): the reference's 11 cases of
``tests/test_chaos_fleet.py`` on the port, with its marks (``chaos`` on
the module, ``slow`` on the same five storm legs), then the port held to
the reference on the same inputs.

  - SIGKILL a plane process under traffic and the fleet books still
    balance EXACTLY (``offered == completed + rejected + failed`` at the
    router), the watchdog respawns the dead plane through the
    ``fleet.plane.spawn`` fault site within its restart budget, and the
    merged fleet p99 stays computable through the degraded window;
    spawn-fault exhaustion evicts the plane LOUDLY with the surviving
    fleet intact; a corrupted plan ship QUARANTINES the receiving plane
    (the ``fleet.rpc.send`` corrupt site models wire corruption of a
    shipped weight plane, caught by the split-plane CRCs);
  - against the reference: rows served through a two-plane fleet equal
    the port's offline batch apply bit for bit, and the reference's apply
    of the same fitted weights within 1e-5 relative; the two routers'
    books and ``stats()`` keys are the same under the same scripted kill.

Each plane spawn imports torch (about 3 s here). Every wait is bounded.
"""

import copy
import json
import os
import signal
import time

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.serving.export import export_plan
from keystone_tpu_torch.serving.fleet import (
    FleetPlaneDied,
    FleetRouter,
    FleetSaturated,
)
from keystone_tpu_torch.serving.fleet_plane import (
    ShipRejected,
    decode_plan_ship,
    encode_plan_ship,
)
from keystone_tpu_torch.serving.loadgen import run_multi_tenant_open_loop
from keystone_tpu_torch.utils.faults import FaultPlan, FaultRule
from tests._torch_serving_util import TINY_D_IN, fit_tiny_mnist, reference_tiny_mnist

pytestmark = pytest.mark.chaos

SERVED_RTOL = 1e-5


@pytest.fixture(scope="module")
def shipment():
    """One fitted pipeline + its encoded plan ship, shared across the
    module (the fit dominates setup cost)."""
    fitted, X = fit_tiny_mnist()
    plan = export_plan(
        fitted, np.zeros(TINY_D_IN, np.float32), max_batch=8
    )
    return fitted, plan, X, encode_plan_ship(fitted, plan)


def _fleet(ship, num_planes=2, **kw):
    kw.setdefault("replicas_per_plane", 1)
    kw.setdefault("heartbeat_interval_s", 0.1)
    kw.setdefault("heartbeat_timeout_s", 3.0)
    kw.setdefault("restart_budget", 2)
    kw.setdefault("spawn_retry_delay_s", 0.01)
    kw.setdefault("plane_cfg", {"device": "cpu"})
    return FleetRouter(ship, num_planes=num_planes, **kw)


def _books_balance(stats):
    return stats["aggregate_offered"] == (
        stats["completed"] + stats["rejected"] + stats["failed"]
    )


class TestShipIntegrity:
    def test_round_trip_reproduces_fingerprint(self, shipment):
        _fitted, plan, _X, ship = shipment
        rebuilt = decode_plan_ship(copy.deepcopy(ship), "cpu")
        assert rebuilt.fingerprint == plan.fingerprint

    def test_tampered_weight_plane_rejected(self, shipment):
        """Flip one bit in a shipped split-plane tensor: the per-tensor
        CRC must reject the ship — wrong bits never become a plan."""
        _fitted, _plan, _X, ship = shipment
        bad = copy.deepcopy(ship)
        t = bad.tensors[0]
        plane = t.raw if t.raw is not None else t.hi
        plane.flat[0] ^= 1
        with pytest.raises(ShipRejected, match="CRC"):
            decode_plan_ship(bad, "cpu")

    def test_wire_corruption_rule_rejected(self, shipment):
        """The chaos-plan form of the same contract: a corrupt rule at
        "fleet.rpc.send" flips bytes inside the decode path and the
        CRC catches it."""
        _fitted, _plan, _X, ship = shipment
        plan = FaultPlan([
            FaultRule("fleet.rpc.send", "corrupt", p=1.0),
        ])
        with plan:
            with pytest.raises(ShipRejected, match="CRC"):
                decode_plan_ship(copy.deepcopy(ship), "cpu")

    def test_claimed_fingerprint_mismatch_rejected(self, shipment):
        _fitted, _plan, _X, ship = shipment
        bad = copy.deepcopy(ship)
        bad.fingerprint = "0" * len(bad.fingerprint)
        with pytest.raises(ShipRejected, match="fingerprint"):
            decode_plan_ship(bad, "cpu")


class TestFleetKill:
    def test_sigkill_respawn_books_balance(self, shipment):
        """SIGKILL one plane under traffic — its in-flight requests fail
        with the NAMED FleetPlaneDied, the watchdog respawns it (new
        pid), the books balance exactly across the kill, and the merged
        fleet histogram keeps the dead plane's observations."""
        _fitted, _plan, X, ship = shipment
        fleet = _fleet(ship, num_planes=2)
        try:
            for i in range(20):
                fleet.submit(X[i % len(X)]).result(timeout=30)
            # Let the watchdog scrape the histograms (the reference sleeps
            # 0.3 s; a loaded host can take longer to publish and scrape).
            deadline = time.monotonic() + 15.0
            while (fleet.stats()["fleet_latency_count"] < 20
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            pre_count = fleet.stats()["fleet_latency_count"]
            assert pre_count >= 20

            victim = fleet.plane_pids()["plane0"]
            os.kill(victim, signal.SIGKILL)
            named = 0
            for i in range(40):
                try:
                    fleet.submit(X[i % len(X)]).result(timeout=30)
                except FleetPlaneDied:
                    named += 1
                time.sleep(0.01)

            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                s = fleet.stats()
                if s["restarts_total"] >= 1 and s["healthy_planes"] == 2:
                    break
                time.sleep(0.1)
            s = fleet.stats()
            assert s["restarts_total"] >= 1
            assert s["healthy_planes"] == 2
            assert s["evicted_planes"] == []
            assert fleet.plane_pids()["plane0"] != victim
            # Books: exact, with every kill-window failure NAMED.
            assert _books_balance(s), s
            assert s["failed"] == named
            # The dead plane's scraped observations survive the kill in
            # the fleet merge.
            assert s["fleet_latency_count"] >= pre_count
            assert s["fleet_p99_latency_s"] is not None
            # Post-respawn the fleet serves normally.
            fleet.submit(X[0]).result(timeout=30)
        finally:
            fleet.close()
        assert fleet.accounting_ok()

    @pytest.mark.slow
    def test_sigkill_mid_poisson_storm(self, shipment):
        """8 tenants of open-loop Poisson arrivals against a 4-plane
        fleet; one plane SIGKILLed mid-storm. The loadgen's books and the
        router's books must BOTH balance, the watchdog must respawn, and
        the merged p99 must stay computable through the degraded
        window."""
        _fitted, _plan, X, ship = shipment
        fleet = _fleet(ship, num_planes=4, replicas_per_plane=1,
                       heartbeat_interval_s=0.05)
        killed = {}
        try:
            def submit(tenant, x, deadline_ms=None):
                return fleet.submit_tenant(tenant, x,
                                           deadline_ms=deadline_ms)

            import threading

            def killer():
                time.sleep(1.2)
                killed["pid"] = fleet.plane_pids()["plane1"]
                os.kill(killed["pid"], signal.SIGKILL)

            kt = threading.Thread(target=killer)
            kt.start()
            report = run_multi_tenant_open_loop(
                submit,
                lambda tenant, i: X[i % len(X)],
                rates_hz={f"t{k}": 30.0 for k in range(8)},
                duration_s=3.0,
                seed=20,
                result_timeout_s=60.0,
            )
            kt.join(timeout=10.0)
            assert report.accounting_ok()
            s = fleet.stats()
            assert _books_balance(s), s
            agg = sum(r.num_offered for r in report.tenants.values())
            assert s["aggregate_offered"] == agg
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                s = fleet.stats()
                if s["restarts_total"] >= 1 and s["healthy_planes"] == 4:
                    break
                time.sleep(0.1)
            assert s["restarts_total"] >= 1
            assert s["healthy_planes"] == 4
            assert fleet.plane_pids()["plane1"] != killed["pid"]
            assert s["fleet_latency_count"] > 0
            assert s["fleet_p99_latency_s"] is not None
            # The storm actually spread: every plane completed work.
            assert all(p["completed"] > 0
                       for p in s["planes"].values())
        finally:
            fleet.close()
        assert fleet.accounting_ok()


class TestSpawnBudget:
    @pytest.mark.slow
    def test_spawn_fault_exhaustion_evicts_loudly(self, shipment):
        """Every respawn attempt fails (injected error rule at
        "fleet.plane.spawn"): the restart budget burns down to a LOUD
        permanent eviction while the surviving plane keeps serving and
        the books stay exact."""
        _fitted, _plan, X, ship = shipment
        fleet = _fleet(ship, num_planes=2, restart_budget=2,
                       heartbeat_interval_s=0.05)
        chaos = FaultPlan([
            FaultRule("fleet.plane.spawn", "error", p=1.0),
        ])
        try:
            fleet.submit(X[0]).result(timeout=30)
            with chaos:
                os.kill(fleet.plane_pids()["plane0"], signal.SIGKILL)
                deadline = time.monotonic() + 30.0
                while time.monotonic() < deadline:
                    s = fleet.stats()
                    if s["evicted_planes"]:
                        break
                    time.sleep(0.1)
            s = fleet.stats()
            assert s["evicted_planes"] == ["plane0"]
            assert s["healthy_planes"] == 1
            assert s["planes"]["plane0"]["restart_budget_left"] == 0
            assert chaos.calls_seen("fleet.plane.spawn") >= 2
            fleet.submit(X[0]).result(timeout=30)
            assert _books_balance(fleet.stats())
        finally:
            fleet.close()
        assert fleet.accounting_ok()


class TestQuarantine:
    @pytest.mark.slow
    def test_corrupted_ship_quarantines_plane(self, shipment):
        """Ship a plan whose weight plane is corrupted in transit (the
        "fleet.rpc.send" corrupt rule, installed in the CHILD via
        KEYSTONE_FAULT_PLAN): the plane boots QUARANTINED — it
        heartbeats, refuses traffic with a named error, and never serves
        wrong bits."""
        _fitted, _plan, X, ship = shipment
        spec = json.dumps({
            "rules": [{"site": "fleet.rpc.send", "kind": "corrupt",
                       "p": 1.0}],
            "seed": 0,
        })
        os.environ["KEYSTONE_FAULT_PLAN"] = spec
        try:
            fleet = _fleet(ship, num_planes=1)
        finally:
            os.environ.pop("KEYSTONE_FAULT_PLAN", None)
        try:
            s = fleet.stats()
            assert s["quarantined_planes"] == ["plane0"]
            assert s["healthy_planes"] == 0  # quarantined != eligible
            assert fleet.plane_pids()["plane0"] is not None
            with pytest.raises(FleetPlaneDied, match="quarantined"):
                fleet.submit(X[0])
            s = fleet.stats()
            assert _books_balance(s)
            assert s["failed"] == 1
        finally:
            fleet.close()


class TestCanaryRoll:
    @pytest.mark.slow
    def test_offer_canary_rolls_across_fleet(self, shipment):
        """A candidate ships to every surviving plane and runs each
        plane's OWN lifecycle gate → canary → promotion; the fleet
        reports the new fingerprint everywhere afterwards."""
        _fitted, _plan, X, ship = shipment
        fitted2, _X2 = fit_tiny_mnist(seed=3)
        plan2 = export_plan(
            fitted2, np.zeros(TINY_D_IN, np.float32), max_batch=8
        )
        assert plan2.fingerprint != ship.fingerprint
        ship2 = encode_plan_ship(fitted2, plan2)
        fleet = _fleet(ship, num_planes=2, replicas_per_plane=2)
        try:
            for i in range(10):
                fleet.submit(X[i % len(X)]).result(timeout=30)
            results = fleet.offer_canary(ship2)
            assert set(results) == {"plane0", "plane1"}
            for name, r in results.items():
                assert r["ok"], (name, r)
                assert r["result"]["published"], (name, r)
                assert r["result"]["fingerprint"] == plan2.fingerprint
            y = fleet.submit(X[0])
            y.result(timeout=30)
            stats = fleet.stats()
            assert _books_balance(stats)
        finally:
            fleet.close()

    @pytest.mark.slow
    def test_corrupt_candidate_rejected_fleet_unharmed(self, shipment):
        """A tampered CANDIDATE ship is rejected per-plane by the same
        CRC verification as boot; the incumbent keeps serving."""
        _fitted, _plan, X, ship = shipment
        bad = copy.deepcopy(ship)
        t = bad.tensors[0]
        plane = t.raw if t.raw is not None else t.hi
        plane.flat[0] ^= 1
        fleet = _fleet(ship, num_planes=1)
        try:
            results = fleet.offer_canary(bad)
            assert results["plane0"]["ok"] is False
            assert results["plane0"]["error"] == "ship_rejected"
            fleet.submit(X[0]).result(timeout=30)  # incumbent intact
        finally:
            fleet.close()


class TestAdmission:
    def test_router_bound_sheds_with_named_rejection(self, shipment):
        """The router's own admission bound: past ``max_outstanding``
        submissions shed synchronously with FleetSaturated (a NAMED
        rejection, counted in the books)."""
        _fitted, _plan, X, ship = shipment
        fleet = _fleet(ship, num_planes=1, max_outstanding=4,
                       dispatchers=1)
        try:
            futs, rejected = [], 0
            for i in range(64):
                try:
                    futs.append(fleet.submit(X[i % len(X)]))
                except FleetSaturated:
                    rejected += 1
            for f in futs:
                f.exception(timeout=30)
            assert rejected >= 1
            s = fleet.stats()
            assert s["rejected"] >= rejected
            assert _books_balance(s)
        finally:
            fleet.close()
        assert fleet.accounting_ok()


def _row_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)).max())


def _wait_respawned(fleet, planes, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        s = fleet.stats()
        if s["restarts_total"] >= 1 and s["healthy_planes"] == planes:
            return s
        time.sleep(0.05)
    raise AssertionError(f"no respawn within {timeout_s} s: {fleet.stats()}")


class TestAgainstReference:
    def test_fleet_rows_equal_the_batch_apply(self):
        """The reference's tiny fit carried into the port, shipped to two
        CPU planes: every served row is the port's offline batch apply of
        the same rows bit for bit, and within 1e-5 relative of the
        reference's apply of the same weights."""
        from keystone_tpu.data import Dataset as JDataset

        j_fitted, t_fitted, X = reference_tiny_mnist(seed=0)
        rows = X[:24]
        offline = t_fitted.apply(Dataset(torch.from_numpy(rows))).array.numpy()
        j_offline = np.asarray(j_fitted.apply(JDataset.of(rows)).to_numpy())
        plan = export_plan(t_fitted, np.zeros(TINY_D_IN, np.float32), max_batch=8)
        fleet = _fleet(encode_plan_ship(t_fitted, plan), num_planes=2)
        try:
            futs = [fleet.submit(r) for r in rows]
            served = np.stack([f.result(timeout=30) for f in futs])
            s = fleet.stats()
        finally:
            fleet.close()
        assert served.tobytes() == offline.tobytes()
        assert _row_rel(served, j_offline) <= SERVED_RTOL
        assert all(p["completed"] > 0 for p in s["planes"].values()), s["planes"]
        assert fleet.accounting_ok()

    def test_books_and_stats_keys_match_under_the_same_scripted_kill(self):
        """Both routers, each over its own package's planes and the same
        fitted weights, run one script: 6 requests one at a time, SIGKILL
        plane0, wait for the respawn, 6 more. The books, the per-plane
        attribution and every ``stats()`` key are the same."""
        from keystone_tpu.serving import export_plan as j_export
        from keystone_tpu.serving.fleet import FleetRouter as JRouter
        from keystone_tpu.serving.fleet_plane import encode_plan_ship as j_encode

        j_fitted, t_fitted, X = reference_tiny_mnist(seed=0)
        example = np.zeros(TINY_D_IN, np.float32)
        ships = (
            j_encode(j_fitted, j_export(j_fitted, example, max_batch=8)),
            encode_plan_ship(t_fitted, export_plan(t_fitted, example, max_batch=8)),
        )
        kw = dict(num_planes=2, replicas_per_plane=1, heartbeat_interval_s=0.1,
                  heartbeat_timeout_s=3.0, restart_budget=2, spawn_retry_delay_s=0.01)
        results = []
        for make, ship, cfg in ((JRouter, ships[0], None),
                                (FleetRouter, ships[1], {"device": "cpu"})):
            fleet = make(ship, plane_cfg=cfg, **kw)
            try:
                for i in range(6):
                    fleet.submit(X[i]).result(timeout=60)
                victim = fleet.plane_pids()["plane0"]
                os.kill(victim, signal.SIGKILL)
                _wait_respawned(fleet, 2)
                assert fleet.plane_pids()["plane0"] != victim
                for i in range(6):
                    fleet.submit(X[i]).result(timeout=60)
                stats = fleet.stats()
            finally:
                fleet.close()
            results.append((stats, fleet.accounting_ok()))
        (j_stats, j_ok), (t_stats, t_ok) = results
        assert j_ok and t_ok
        assert set(t_stats) == set(j_stats)
        for name in ("plane0", "plane1"):
            assert set(t_stats["planes"][name]) == set(j_stats["planes"][name])
        books = ("num_planes", "healthy_planes", "evicted_planes", "quarantined_planes",
                 "restarts_total", "aggregate_offered", "completed", "rejected", "failed",
                 "inflight")
        assert {k: t_stats[k] for k in books} == {k: j_stats[k] for k in books}
        per_plane = ("healthy", "evicted", "quarantined", "outstanding", "offered",
                     "completed", "rejected", "failed", "restarts", "restart_budget_left")
        for name in ("plane0", "plane1"):
            assert ({k: t_stats["planes"][name][k] for k in per_plane}
                    == {k: j_stats["planes"][name][k] for k in per_plane}), name
        assert t_stats["aggregate_offered"] == 12 and t_stats["restarts_total"] == 1


class TestServeFleetCLI:
    def test_a_saved_model_is_what_the_fleet_serves(self, shipment, tmp_path, capsys):
        """``serve --model fitted.pkl --fleet 2`` ships that model: the
        planes serve the saved pipeline's plan fingerprint, with the fleet's
        books balanced."""
        from keystone_tpu_torch import run

        fitted, plan, _X, _ship = shipment
        path = str(tmp_path / "fitted.pkl")
        fitted.save(path)
        rc = run.main(["serve", "--device", "cpu", "--model", path, "--input-dim",
                       str(TINY_D_IN), "--max-batch", "8", "--rate", "200",
                       "--duration-s", "0.3", "--fleet", "2"])
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0 and summary["fleet_accounting_ok"] is True
        assert summary["plan_fingerprint"] == plan.fingerprint
        assert {p["fingerprint"] for p in summary["planes"].values()} == {plan.fingerprint}
        assert summary["fleet_failed"] == 0 and summary["aggregate_offered"] > 0
