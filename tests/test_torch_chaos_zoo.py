"""The model zoo's chaos drills on the port (``tests/test_chaos_zoo.py``'s
cases): a hot-tenant spike degrades only the spiking tenant while every
other tenant's SLO verdict stays OK with zero silent drops; a page-in
fault is absorbed by the bounded retry budget; page-in failures past it
quarantine loudly; a kill mid-page-out leaves the resident copy
authoritative; a ``corrupt`` rule quarantines through the CRC. Then the
spike's schedule against the reference's: the same seed gives the same
per-tenant arrivals.

Driven by the fault harness's ``serving.zoo.page_in`` /
``serving.zoo.page_out`` sites. The multi-tenant Poisson storm is marked
``slow`` as in the reference.
"""

import numpy as np
import pytest

from keystone_tpu_torch import obs
from keystone_tpu_torch.serving import (
    ModelZoo,
    TenantQuarantined,
    export_plan,
    run_multi_tenant_open_loop,
)
from keystone_tpu_torch.utils.faults import FaultPlan, FaultRule
from tests._torch_serving_util import TINY_D_IN, fit_tiny_mnist

pytestmark = pytest.mark.chaos


def _plan(seed=0, max_batch=8):
    fitted, X = fit_tiny_mnist(seed=seed)
    return export_plan(fitted, np.zeros(TINY_D_IN, np.float32), max_batch=max_batch), X


def _availability_slo(target=0.95):
    return obs.SLOTracker([
        obs.SLOObjective("availability", kind="availability", target=target),
    ])


class TestHotTenantIsolation:
    @pytest.mark.slow
    def test_spike_degrades_only_the_hot_tenant(self):
        num_tenants = 8
        plans = [_plan(seed=s) for s in range(num_tenants)]
        names = [f"t{i}" for i in range(num_tenants - 1)] + ["hot"]
        slos = {name: _availability_slo() for name in names}
        per = max(plans[0][0].pinned_bytes, 1)
        zoo = ModelZoo(
            budget_bytes=num_tenants * per + num_tenants,
            max_batch=8, max_wait_ms=10.0,
            tenant_queue_cap=8, max_outstanding_total=64,
        )
        try:
            for name, (p, _) in zip(names, plans):
                zoo.add_tenant(name, p, slo=slos[name])
            base = 25.0
            rates = {name: base for name in names}
            rates["hot"] = base * 80
            pools = {name: plans[i][1] for i, name in enumerate(names)}
            report = run_multi_tenant_open_loop(
                zoo.submit, lambda tenant, i: pools[tenant][i % len(pools[tenant])],
                rates_hz=rates, duration_s=2.5, seed=0, slos=slos,
            )
            states = report.tenant_states()
            assert states["hot"] in ("WARN", "BREACH"), states
            others = {n: s for n, s in states.items() if n != "hot"}
            assert all(s == "OK" for s in others.values()), states
            assert report.tenants["hot"].rejected > 0
            assert report.accounting_ok()
            st = zoo.stats()
            assert st["accounting_ok"]
            for name in others:
                t = st["tenants"][name]
                assert t["rejected"] == 0 and t["failed"] == 0, (name, t)
        finally:
            zoo.close()


class TestPageFaults:
    def test_page_in_fault_absorbed_by_retry(self):
        plan, X = _plan(seed=0)
        zoo = ModelZoo(budget_bytes=10 * max(plan.pinned_bytes, 1), max_batch=8)
        try:
            zoo.add_tenant("a", plan, resident=False)
            with FaultPlan([FaultRule("serving.zoo.page_in", "error", calls=[0])]):
                out = zoo.submit("a", X[0]).result(timeout=60)
            assert np.asarray(out).shape[-1] == 10
            st = zoo.stats()
            assert st["tenants"]["a"]["resident"]
            assert st["tenants"]["a"]["page_retries"] == 1
            assert st["quarantined"] == 0
            assert st["accounting_ok"]
        finally:
            zoo.close()

    def test_page_in_failures_past_budget_quarantine_loudly(self):
        p0, X0 = _plan(seed=0)
        p1, X1 = _plan(seed=1)
        zoo = ModelZoo(budget_bytes=10 * max(p0.pinned_bytes, 1), max_batch=8,
                       page_retry_attempts=2)
        try:
            zoo.add_tenant("a", p0, resident=False)
            zoo.add_tenant("b", p1)
            with FaultPlan([FaultRule("serving.zoo.page_in", "error", p=1.0)]):
                with pytest.raises(TenantQuarantined, match="2 failed"):
                    zoo.submit("a", X0[0])
            st = zoo.stats()
            assert st["tenants"]["a"]["quarantined"]
            assert st["quarantined"] == 1
            assert zoo.metrics.snapshot()["zoo.quarantined"] == 1
            zoo.submit("b", X1[0]).result(timeout=30)
            assert st["accounting_ok"]
        finally:
            zoo.close()

    def test_kill_mid_page_out_leaves_resident_copy_authoritative(self):
        plan, X = _plan(seed=0)
        zoo = ModelZoo(budget_bytes=10 * max(plan.pinned_bytes, 1), max_batch=8,
                       page_retry_attempts=2)
        try:
            zoo.add_tenant("a", plan)
            before = np.asarray(zoo.submit("a", X[0]).result(timeout=30))
            with FaultPlan([FaultRule("serving.zoo.page_out", "error", p=1.0)]):
                with pytest.raises(OSError):
                    zoo.page_out("a")
            st = zoo.stats()["tenants"]["a"]
            assert st["resident"]
            assert st["page_outs"] == 0
            assert not st["quarantined"]
            after = np.asarray(zoo.submit("a", X[0]).result(timeout=30))
            assert np.array_equal(before, after)
            assert any(d["action"] == "page_out" and not d["ok"] for d in zoo.decision_log())
        finally:
            zoo.close()

    def test_corrupt_rule_quarantines_via_fault_plan(self):
        plan, X = _plan(seed=0)
        zoo = ModelZoo(budget_bytes=10 * max(plan.pinned_bytes, 1), max_batch=8)
        try:
            zoo.add_tenant("a", plan, resident=False)
            with FaultPlan([FaultRule("serving.zoo.page_in", "corrupt", calls=[0])]):
                with pytest.raises(TenantQuarantined):
                    zoo.submit("a", X[0])
            st = zoo.stats()
            assert st["tenants"]["a"]["quarantined"]
            assert st["tenants"]["a"]["completed"] == 0
            assert st["accounting_ok"]
        finally:
            zoo.close()


class TestScheduleAgainstReference:
    def test_spike_schedule_is_the_references(self):
        """The spike's offered mix through both packages' multi-tenant
        loadgens against a front door that admits nothing: the same seed
        gives every tenant the same number of arrivals (numpy Poisson
        draws on both sides), all accounted as rejected, and the same
        report row keys."""
        from keystone_tpu.serving import ServerOverloaded as JOverloaded
        from keystone_tpu.serving import run_multi_tenant_open_loop as j_run
        from keystone_tpu_torch.serving import ServerOverloaded

        rates = {f"t{i}": 40.0 for i in range(3)}
        rates["hot"] = 900.0
        rows = []
        for run, exc in ((j_run, JOverloaded), (run_multi_tenant_open_loop, ServerOverloaded)):
            def refuse(tenant, x, deadline_ms, exc=exc):
                raise exc("full")

            report = run(refuse, lambda tenant, i: i, rates_hz=rates, duration_s=0.25, seed=4)
            assert report.accounting_ok()
            row = report.to_row_dict()
            rows.append({k: v for k, v in row.items() if k != "duration_s"} | {
                "tenants": {n: {k: v for k, v in r.items() if k not in ("achieved_qps",)}
                            for n, r in row["tenants"].items()}})
        assert rows[0] == rows[1]
        assert rows[1]["rejected_total"] == rows[1]["offered_total"] > 200
