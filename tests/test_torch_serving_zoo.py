"""The port's multi-tenant model zoo (``keystone_tpu_torch/serving/zoo.py``)
on the CPU: the reference's contract cases (``tests/test_serving_zoo.py``)
on the port, then the port held to the reference on the same inputs.

  - the paged encoding: bit-exact split planes, the compressed 2 B form,
    raw bytes, CRC failures, byte counts;
  - paging round trips (served bits and fingerprints), audited decisions,
    shared operators refused;
  - LRU-by-cost eviction, cold starts against a deadline, quarantine on a
    flipped byte, deficit-weighted fair admission, per-tenant books;
  - against the reference: the encoding's planes, CRCs and byte counts,
    the paged form of the same fitted weights slot for slot, served rows
    within 1e-5 relative across a page round trip, the eviction and
    paging decision logs under one scripted clock (scores included), and
    the per-tenant books and shares of the same admission script;
  - ``run.py serve --tenants`` under a budget that binds,
    ``--tenant-spec`` with a skewed mix, and the refusals.

The port pages every tensor its export pins: a gather fused inside a
fused batch keeps its branches' operators one level below the reference's
walk, so the port also pages the tiny MNIST's two branch sign vectors
(2 x 16 float32, bf16-representable: 64 paged bytes) that the reference
leaves resident. Every wait is bounded.
"""

import gc
import json

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data.durable import ShardCorrupted
from keystone_tpu_torch.serving import (
    ModelZoo,
    ServerClosed,
    ServerOverloaded,
    TenantColdStart,
    TenantQuarantined,
    export_plan,
)
from keystone_tpu_torch.serving.batcher import frozen_heap
from keystone_tpu_torch.serving.zoo import (
    PagedWeights,
    _collect_weight_slots,
    _decode_tensor,
    _encode_tensor,
)
from keystone_tpu_torch.utils import faults
from tests._torch_serving_util import TINY_D_IN, fit_tiny_mnist, reference_tiny_mnist

SERVED_RTOL = 1e-5


def _plan(seed=0, max_batch=8):
    fitted, X = fit_tiny_mnist(seed=seed)
    return export_plan(fitted, np.zeros(TINY_D_IN, np.float32), max_batch=max_batch), X


class TestPagedEncoding:
    def test_f32_round_trip_is_bit_exact(self):
        rng = np.random.default_rng(0)
        arr = rng.normal(size=(37, 5)).astype(np.float32)
        pt = _encode_tensor(arr)
        assert pt.lo is not None
        out = _decode_tensor(pt, faults.SITE_ZOO_PAGE_IN)
        assert out.dtype == np.float32
        assert np.array_equal(out.view(np.uint32), arr.view(np.uint32))

    def test_bf16_representable_drops_low_plane(self):
        arr = np.asarray([1.0, -2.0, 0.5, 0.0, 1024.0], np.float32)
        pt = _encode_tensor(arr)
        assert pt.lo is None
        assert pt.nbytes == arr.size * 2
        assert np.array_equal(_decode_tensor(pt, faults.SITE_ZOO_PAGE_IN), arr)

    def test_non_f32_rides_raw_bytes(self):
        arr = np.arange(12, dtype=np.int32).reshape(3, 4)
        pt = _encode_tensor(arr)
        assert pt.raw is not None
        assert np.array_equal(_decode_tensor(pt, faults.SITE_ZOO_PAGE_IN), arr)

    def test_bit_flip_raises_shard_corrupted(self):
        arr = np.linspace(0.0, 1.0, 16, dtype=np.float32)
        pt = _encode_tensor(arr)
        pt.hi.view(np.uint8)[3] ^= 0xFF
        with pytest.raises(ShardCorrupted, match="checksum"):
            _decode_tensor(pt, faults.SITE_ZOO_PAGE_IN)

    def test_paged_weights_nbytes(self):
        a = np.ones(8, np.float32)
        b = np.full(8, 1.1, np.float32)
        pw = PagedWeights([_encode_tensor(a), _encode_tensor(b)],
                          decoded_bytes=a.nbytes + b.nbytes)
        assert pw.nbytes == 16 + 32
        assert pw.decoded_bytes == 64


class TestPagingRoundTrip:
    def test_round_trip_bit_identity_per_fingerprint(self):
        plan, X = _plan(seed=0)
        zoo = ModelZoo(budget_bytes=10 * max(plan.pinned_bytes, 1), max_batch=8)
        try:
            fp = zoo.add_tenant("a", plan)
            before = np.asarray(zoo.submit("a", X[0]).result(timeout=30))
            zoo.page_out("a")
            st = zoo.stats()["tenants"]["a"]
            assert not st["resident"]
            assert st["paged_bytes"] is not None and st["paged_bytes"] > 0
            after = np.asarray(zoo.submit("a", X[0]).result(timeout=30))
            assert np.array_equal(before, after)
            st = zoo.stats()["tenants"]["a"]
            assert st["resident"]
            assert st["fingerprint"] == fp
            assert st["page_ins"] == 1 and st["page_outs"] == 1
        finally:
            zoo.close()

    def test_paging_decisions_are_audited(self):
        plan, X = _plan(seed=1)
        zoo = ModelZoo(budget_bytes=10 * max(plan.pinned_bytes, 1), max_batch=8)
        try:
            zoo.add_tenant("a", plan)
            zoo.page_out("a")
            zoo.page_in("a")
            actions = [(d["action"], d["tenant"]) for d in zoo.decision_log()]
            assert ("page_out", "a") in actions
            assert ("page_in", "a") in actions
            assert zoo.stats()["num_decisions"] >= 2
            snap = zoo.metrics.snapshot()
            assert snap["zoo.page_ins"] == 1
            assert snap["zoo.page_outs"] == 1
        finally:
            zoo.close()

    def test_shared_operator_objects_rejected(self):
        plan, X = _plan(seed=2)
        zoo = ModelZoo(budget_bytes=10 * max(plan.pinned_bytes, 1), max_batch=8)
        try:
            zoo.add_tenant("a", plan)
            with pytest.raises(ValueError, match="shares operator"):
                zoo.add_tenant("b", plan)
        finally:
            zoo.close()


class TestEviction:
    def _zoo_of_three(self, budget_tenants=2):
        plans = [_plan(seed=s) for s in range(3)]
        per = max(plans[0][0].pinned_bytes, 1)
        zoo = ModelZoo(budget_bytes=budget_tenants * per + budget_tenants, max_batch=8,
                       cold_start_estimate_s=0.0)
        for i, (p, _) in enumerate(plans):
            zoo.add_tenant(f"t{i}", p, resident_bytes=per)
        return zoo, plans

    def test_lru_eviction_is_deterministic(self):
        zoo, plans = self._zoo_of_three()
        try:
            st = zoo.stats()["tenants"]
            assert not st["t0"]["resident"]
            assert st["t1"]["resident"] and st["t2"]["resident"]
            zoo.submit("t1", plans[1][1][0]).result(timeout=30)
            zoo.submit("t0", plans[0][1][0]).result(timeout=30)
            st = zoo.stats()["tenants"]
            assert st["t0"]["resident"] and st["t1"]["resident"]
            assert not st["t2"]["resident"]
            evicts = [d for d in zoo.decision_log() if d["action"] == "evict"]
            assert [d["tenant"] for d in evicts] == ["t0", "t2"]
        finally:
            zoo.close()

    def test_evict_decision_carries_scored_candidates(self):
        zoo, plans = self._zoo_of_three()
        try:
            evict = next(d for d in zoo.decision_log() if d["action"] == "evict")
            assert evict["inputs"]["budget_bytes"] == zoo.budget_bytes
            cands = evict["candidates"]
            assert cands and all(
                {"tenant", "age_s", "page_in_cost_s", "slo_state", "slo_pressure",
                 "score"} <= set(c) for c in cands)
            assert evict["tenant"] == cands[0]["tenant"]
        finally:
            zoo.close()

    def test_single_tenant_over_budget_rejected_at_add(self):
        plan, _ = _plan(seed=0)
        zoo = ModelZoo(budget_bytes=64, max_batch=8)
        try:
            with pytest.raises(ValueError, match="never be paged in"):
                zoo.add_tenant("huge", plan, resident_bytes=1 << 20)
        finally:
            zoo.close()


class TestColdStart:
    def test_deadline_bounded_cold_start_fast_fails(self):
        plan, X = _plan(seed=0)
        zoo = ModelZoo(budget_bytes=10 * max(plan.pinned_bytes, 1), max_batch=8,
                       cold_start_estimate_s=30.0)
        try:
            zoo.add_tenant("a", plan, resident=False)
            with pytest.raises(TenantColdStart, match="deadline"):
                zoo.submit("a", X[0], deadline_ms=1.0)
            st = zoo.stats()
            assert st["coldstart_failfast"] == 1
            assert st["tenants"]["a"]["rejected"] == 1
            assert st["accounting_ok"]
            assert issubclass(TenantColdStart, ServerOverloaded)
        finally:
            zoo.close()

    def test_no_deadline_pays_the_cold_start(self):
        plan, X = _plan(seed=1)
        zoo = ModelZoo(budget_bytes=10 * max(plan.pinned_bytes, 1), max_batch=8,
                       cold_start_estimate_s=30.0)
        try:
            zoo.add_tenant("a", plan, resident=False)
            out = np.asarray(zoo.submit("a", X[0]).result(timeout=60))
            assert out.shape[-1] == 10
            st = zoo.stats()["tenants"]["a"]
            assert st["resident"] and st["page_ins"] == 1
        finally:
            zoo.close()

    def test_estimate_becomes_measured_after_first_page_in(self):
        plan, X = _plan(seed=2)
        zoo = ModelZoo(budget_bytes=10 * max(plan.pinned_bytes, 1), max_batch=8,
                       cold_start_estimate_s=123.0)
        try:
            assert zoo.page_in_estimate_s() == 123.0
            zoo.add_tenant("a", plan, resident=False)
            zoo.page_in("a")
            assert zoo.page_in_estimate_s() < 60.0
        finally:
            zoo.close()


class TestQuarantine:
    def test_crc_bit_flip_quarantines_not_wrong_answer(self):
        p0, X0 = _plan(seed=0)
        p1, X1 = _plan(seed=1)
        zoo = ModelZoo(budget_bytes=10 * max(p0.pinned_bytes, 1), max_batch=8)
        try:
            zoo.add_tenant("a", p0)
            zoo.add_tenant("b", p1)
            zoo.page_out("a")
            paged = zoo._tenants["a"].paged
            plane = next(t.hi if t.hi is not None else t.raw for t in paged.tensors)
            plane.view(np.uint8)[0] ^= 0xFF
            with pytest.raises(TenantQuarantined):
                zoo.submit("a", X0[0])
            st = zoo.stats()
            assert st["quarantined"] == 1
            assert st["tenants"]["a"]["quarantined"]
            assert "CRC" in st["tenants"]["a"]["quarantine_reason"]
            assert zoo.metrics.snapshot()["zoo.quarantined"] == 1
            assert any(d["action"] == "quarantine" and d["tenant"] == "a"
                       for d in zoo.decision_log())
            # The failed page-in left no weight restored.
            assert all(getattr(op, k) is None if i is None else getattr(op, k)[i] is None
                       for op, k, i in zoo._tenants["a"].slots)
            zoo.submit("b", X1[0]).result(timeout=30)
            with pytest.raises(TenantQuarantined):
                zoo.submit("a", X0[0])
            assert zoo.stats()["accounting_ok"]
        finally:
            zoo.close()


class TestFairAdmission:
    def _two_tenant_zoo(self, **kw):
        p0, X0 = _plan(seed=0)
        p1, X1 = _plan(seed=1)
        kw.setdefault("budget_bytes", 10 * max(p0.pinned_bytes, 1))
        kw.setdefault("max_batch", 64)
        # A wide coalescing window keeps submitted requests queued, so the
        # outstanding counts are deterministic while admission is read.
        kw.setdefault("max_wait_ms", 500.0)
        zoo = ModelZoo(**kw)
        zoo.add_tenant("cold", p0)
        zoo.add_tenant("hot", p1)
        return zoo, X0, X1

    def test_hot_tenant_overflow_rejected_cold_tenant_admits(self):
        zoo, X0, X1 = self._two_tenant_zoo(max_outstanding_total=4, tenant_queue_cap=100)
        try:
            assert zoo.guaranteed_share("hot") == 2
            futs = [zoo.submit("hot", X1[0]) for _ in range(4)]
            with pytest.raises(ServerOverloaded, match="fair admission"):
                zoo.submit("hot", X1[0])
            f_cold = zoo.submit("cold", X0[0])
            for f in futs + [f_cold]:
                f.result(timeout=30)
            st = zoo.stats()
            assert st["tenants"]["hot"]["rejected"] == 1
            assert st["tenants"]["cold"]["rejected"] == 0
            assert st["accounting_ok"]
        finally:
            zoo.close()

    def test_per_tenant_queue_cap(self):
        zoo, X0, X1 = self._two_tenant_zoo(max_outstanding_total=1000, tenant_queue_cap=2)
        try:
            futs = [zoo.submit("hot", X1[0]) for _ in range(2)]
            with pytest.raises(ServerOverloaded, match="queue cap"):
                zoo.submit("hot", X1[0])
            for f in futs:
                f.result(timeout=30)
        finally:
            zoo.close()

    def test_weighted_shares(self):
        p0, X0 = _plan(seed=0)
        p1, _ = _plan(seed=1)
        zoo = ModelZoo(budget_bytes=10 * max(p0.pinned_bytes, 1), max_outstanding_total=30,
                       max_batch=8)
        try:
            zoo.add_tenant("big", p0, weight=2.0)
            zoo.add_tenant("small", p1, weight=1.0)
            assert zoo.guaranteed_share("big") == 20
            assert zoo.guaranteed_share("small") == 10
        finally:
            zoo.close()


class TestAccountingAndLifecycle:
    def test_offered_equals_outcomes_per_tenant(self):
        plan, X = _plan(seed=0)
        zoo = ModelZoo(budget_bytes=10 * max(plan.pinned_bytes, 1), max_batch=8)
        try:
            zoo.add_tenant("a", plan)
            futs = [zoo.submit("a", X[i % len(X)]) for i in range(20)]
            for f in futs:
                f.result(timeout=30)
            st = zoo.stats()["tenants"]["a"]
            assert st["offered"] == 20
            assert st["completed"] + st["rejected"] + st["failed"] == 20
            assert st["outstanding"] == 0
            assert st["accounting_ok"]
        finally:
            zoo.close()

    def test_futures_carry_tenant_and_fingerprint(self):
        plan, X = _plan(seed=0)
        zoo = ModelZoo(budget_bytes=10 * max(plan.pinned_bytes, 1), max_batch=8)
        try:
            fp = zoo.add_tenant("a", plan)
            fut = zoo.submit("a", X[0])
            fut.result(timeout=30)
            assert fut.tenant == "a"
            assert fut.plan_fingerprint == fp
        finally:
            zoo.close()

    def test_unknown_tenant_raises(self):
        plan, X = _plan(seed=0)
        zoo = ModelZoo(budget_bytes=10 * max(plan.pinned_bytes, 1), max_batch=8)
        try:
            zoo.add_tenant("a", plan)
            with pytest.raises(ValueError, match="unknown tenant"):
                zoo.submit("nope", X[0])
        finally:
            zoo.close()

    def test_close_is_idempotent_and_poisons_submit(self):
        plan, X = _plan(seed=0)
        zoo = ModelZoo(budget_bytes=10 * max(plan.pinned_bytes, 1), max_batch=8)
        zoo.add_tenant("a", plan)
        zoo.close()
        zoo.close()
        with pytest.raises(ServerClosed):
            zoo.submit("a", X[0])
        with pytest.raises(ServerClosed):
            zoo.add_tenant("b", plan)


class TestPageOutReleases:
    def test_slots_and_programs_let_go_of_the_weights(self):
        """Page-out sets every slot the pin walk pinned to None and drops
        the plan's bucket programs and composed function; page-in brings
        the same tensors back (values, dtypes, shapes)."""
        plan, X = _plan(seed=3)
        zoo = ModelZoo(budget_bytes=10 * max(plan.pinned_bytes, 1), max_batch=8)
        try:
            zoo.add_tenant("a", plan)
            slots = _collect_weight_slots(plan.graph)
            kept = [t.clone() for _, _, _, t in slots]
            assert sum(t.numel() * t.element_size() for t in kept) == plan.pinned_bytes
            zoo.page_out("a")
            assert all((getattr(op, k) if i is None else getattr(op, k)[i]) is None
                       for op, k, i, _ in slots)
            assert plan._programs == {} and plan._composed is None
            with pytest.raises(RuntimeError, match="released"):
                plan.apply_padded(np.zeros((2, TINY_D_IN), np.float32))
            zoo.page_in("a")
            back = [getattr(op, k) if i is None else getattr(op, k)[i] for op, k, i, _ in slots]
            for a, b in zip(kept, back):
                assert a.dtype == b.dtype and torch.equal(a, b)
        finally:
            zoo.close()

    def test_pickle_clone_holds_each_block_once(self):
        """A fit's blocks are views of one stacked solution; a pickle clone
        (the CLI's tenants, ``FittedPipeline.save``) holds each block's
        weights once, so a fresh tenant's device memory is its charge."""
        import pickle

        from keystone_tpu_torch.ops.learning.block import BlockLinearMapper

        W = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 10)).astype(np.float32))
        mapper = BlockLinearMapper(list(W.split(16)), 16, b_opt=torch.zeros(10))
        clone = pickle.loads(pickle.dumps(mapper))
        assert [x.untyped_storage().nbytes() for x in clone.xs] == [16 * 10 * 4] * 4
        assert all(torch.equal(a, b) for a, b in zip(mapper.xs, clone.xs))
        assert all(x.untyped_storage().nbytes() == 64 * 10 * 4 for x in mapper.xs)

    def test_bfloat16_slot_round_trips(self):
        from keystone_tpu_torch.serving.zoo import _to_host, _upload

        t = torch.tensor([1.5, -3.0, 0.0078125], dtype=torch.bfloat16)
        host = _to_host(t)
        assert host.dtype == np.int16
        (back,) = _upload([_decode_tensor(_encode_tensor(host), faults.SITE_ZOO_PAGE_IN)],
                          [torch.bfloat16], torch.device("cpu"))
        assert back.dtype == torch.bfloat16 and torch.equal(back, t)


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------



class TestCollectorIsolation:
    """ROADMAP C.14: a full garbage collection walks every tracked object
    of the process and stops every tenant while it runs; on the card's
    host such a pause (0.18-0.31 s) let the drill's open-loop arrivals
    land as one burst past a base-rate tenant's queue cap. The process
    that owns the heap serves its storm inside ``frozen_heap()``, so
    collections walk only what serving made since; a zoo freezes
    nothing itself."""

    @staticmethod
    def _walked(obj) -> bool:
        # gc.get_objects() lists the collected generations, not the
        # frozen (permanent) one.
        return any(o is obj for o in gc.get_objects())

    def test_collections_skip_the_heap_the_zoo_was_built_on(self):
        plan, X = _plan()
        before = {"state made before the zoo": [1, 2, 3]}
        zoo = ModelZoo(budget_bytes=10 * plan.pinned_bytes)
        try:
            zoo.add_tenant("a", plan)
            assert self._walked(before)  # the zoo froze nothing
            with frozen_heap():
                assert gc.get_freeze_count() > 0
                assert not self._walked(before)
                assert not self._walked(plan)
                assert zoo.submit("a", X[0]).result(timeout=30).shape == (10,)
            assert self._walked(before)
        finally:
            zoo.close()

    def test_the_last_live_zoo_unfreezes(self):
        # The heap is handed back when the owner's block ends, with a zoo
        # still open and the block raising.
        plan, _X = _plan()
        before = {"state made before the zoo": [1]}
        zoo = ModelZoo(budget_bytes=10 * plan.pinned_bytes)
        try:
            zoo.add_tenant("a", plan)
            with pytest.raises(RuntimeError, match="storm"):
                with frozen_heap():
                    assert not self._walked(before)
                    raise RuntimeError("the storm failed")
            assert gc.get_freeze_count() == 0
            assert self._walked(before)
        finally:
            zoo.close()
        assert gc.get_freeze_count() == 0

    def test_nested_blocks_freeze_once(self):
        before = {"state made before the blocks": [1]}
        with frozen_heap():
            made_inside = {"made inside the outer block": [2]}
            with frozen_heap():
                assert self._walked(made_inside)  # nothing frozen again
            assert not self._walked(before)  # the inner exit kept it frozen
        assert self._walked(before)
        assert gc.get_freeze_count() == 0

    @pytest.mark.parametrize("mode", [[], ["--replicas", "2"], ["--tenants", "2"]],
                             ids=["single", "replicas", "tenants"])
    def test_serve_storms_with_the_heap_frozen(self, capsys, monkeypatch, mode):
        from keystone_tpu_torch import serving

        frozen_during = []
        for name in ("run_open_loop", "run_multi_tenant_open_loop"):
            def storm(*a, _run=getattr(serving, name), **kw):
                frozen_during.append(gc.get_freeze_count() > 0)
                return _run(*a, **kw)

            monkeypatch.setattr(serving, name, storm)
        rc, summary, err = _serve(capsys, *mode)
        assert rc == 0, err
        assert frozen_during == [True]
        assert gc.get_freeze_count() == 0


def _pair(seed=0, max_batch=8):
    """The reference's tiny fit and the port's carrying its weights, each
    exported; (reference plan, port plan, X)."""
    from keystone_tpu.serving import export_plan as j_export

    j_fitted, t_fitted, X = reference_tiny_mnist(seed=seed)
    example = np.zeros(TINY_D_IN, np.float32)
    return (j_export(j_fitted, example, max_batch=max_batch),
            export_plan(t_fitted, example, max_batch=max_batch), X)


def _planes(pt):
    return [None if p is None else bytes(p.tobytes()) for p in (pt.hi, pt.lo, pt.raw)]


def _slot_key(op, attr, idx):
    return type(op).__name__, attr, idx


class TestAgainstReference:
    @pytest.mark.parametrize("make", [
        lambda r: r.normal(size=(37, 5)).astype(np.float32),
        lambda r: np.asarray([1.0, -2.0, 0.5, 0.0, 1024.0], np.float32),
        lambda r: r.integers(-9, 9, size=(4, 6)).astype(np.int32),
        lambda r: r.normal(size=(3, 7)).astype(np.float64),
        lambda r: r.normal(size=(0,)).astype(np.float32),
    ])
    def test_encoding_is_the_references(self, make):
        from keystone_tpu.serving.zoo import _decode_tensor as j_decode
        from keystone_tpu.serving.zoo import _encode_tensor as j_encode
        from keystone_tpu.utils import faults as j_faults

        arr = make(np.random.default_rng(7))
        t, j = _encode_tensor(arr), j_encode(arr)
        assert _planes(t) == _planes(j)
        assert (t.crc, t.algo, t.nbytes, t.shape) == (j.crc, j.algo, j.nbytes, j.shape)
        out = _decode_tensor(t, faults.SITE_ZOO_PAGE_IN)
        assert out.tobytes() == np.asarray(j_decode(j, j_faults.SITE_ZOO_PAGE_IN)).tobytes()

    def test_paged_weights_are_the_references_slot_for_slot(self):
        """The same fitted weights paged out by both zoos: every slot the
        reference pages has the port's planes, CRC and byte count; the port
        pages the two branch sign vectors on top (64 bytes, bf16-exact)."""
        from keystone_tpu.serving import ModelZoo as JZoo
        from keystone_tpu.serving.zoo import _collect_weight_slots as j_slots

        jp, tp, X = _pair(seed=0)
        zoos = [JZoo(budget_bytes=1 << 20, max_batch=8), ModelZoo(budget_bytes=1 << 20,
                                                                  max_batch=8)]
        try:
            for zoo, p in zip(zoos, (jp, tp)):
                zoo.add_tenant("a", p)
            j_keys = [_slot_key(op, k, i) for op, k, i, _ in j_slots(jp.graph)]
            t_keys = [_slot_key(op, k, i) for op, k, i, _ in _collect_weight_slots(tp.graph)]
            for zoo in zoos:
                zoo.page_out("a")
            j_paged, t_paged = (z._tenants["a"].paged for z in zoos)
            left = list(zip(t_keys, t_paged.tensors))
            for key, jt in zip(j_keys, j_paged.tensors):
                (n,) = [n for n, (k, _) in enumerate(left) if k == key]
                tt = left.pop(n)[1]
                assert _planes(tt) == _planes(jt), key
                assert (tt.crc, tt.algo, tt.nbytes, tt.shape) == (jt.crc, jt.algo, jt.nbytes,
                                                                   jt.shape), key
            assert [k for k, _ in left] == [("RandomSignNode", "signs", None)] * 2
            assert all(t.lo is None for _, t in left)
            assert t_paged.nbytes == j_paged.nbytes + 2 * TINY_D_IN * 2
            assert t_paged.decoded_bytes == j_paged.decoded_bytes + 2 * TINY_D_IN * 4
            decision = [d for d in zoos[1].decision_log() if d["action"] == "page_out"][-1]
            assert decision["inputs"]["paged_bytes"] == t_paged.nbytes
        finally:
            for zoo in zoos:
                zoo.close()

    def test_served_rows_across_a_page_round_trip(self):
        """Both zoos serve the same rows before and after a page round
        trip: the port's are bit-equal across it, its fingerprint holds,
        and its rows are within 1e-5 relative of the reference's."""
        from keystone_tpu.serving import ModelZoo as JZoo

        jp, tp, X = _pair(seed=1)
        zoos = [JZoo(budget_bytes=1 << 20, max_batch=8), ModelZoo(budget_bytes=1 << 20,
                                                                  max_batch=8)]
        try:
            outs = []
            for zoo, p in zip(zoos, (jp, tp)):
                fp = zoo.add_tenant("a", p)
                before = np.stack([np.asarray(zoo.submit("a", X[i]).result(timeout=30))
                                   for i in range(6)])
                zoo.page_out("a")
                after = np.stack([np.asarray(zoo.submit("a", X[i]).result(timeout=30))
                                  for i in range(6)])
                assert np.array_equal(before, after)
                assert zoo.stats()["tenants"]["a"]["fingerprint"] == fp
                outs.append(after)
            j, t = outs
            rel = np.linalg.norm(t - j, axis=1) / np.linalg.norm(j, axis=1)
            assert rel.max() <= SERVED_RTOL
        finally:
            for zoo in zoos:
                zoo.close()

    def test_eviction_and_paging_decisions_under_one_clock(self, monkeypatch):
        """The reference's LRU script, extended past the first measured
        page-in, on both packages under one scripted clock (the zoo's
        ``_now`` and a ``perf_counter`` that steps 0.25 s a call, so every
        page-in wall and the estimate they feed are scripted too) and
        equal resident charges: the same evictions, victims, scored
        candidates (ages, page-in costs, SLO pressure, scores), page-in
        walls and reasons, and per-tenant books. Only the fingerprints
        (each package's own) and the page-outs' paged bytes (the port also
        pages the signs) are left out."""
        import time
        import types

        from keystone_tpu.serving import ModelZoo as JZoo
        from keystone_tpu.serving import export_plan as j_export
        from keystone_tpu.serving import zoo as j_zoo_mod
        from keystone_tpu_torch.serving import zoo as t_zoo_mod

        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", "ec2")
        logs = []
        for Zoo, exp, mod, pkg in ((JZoo, j_export, j_zoo_mod, "ref"),
                                   (ModelZoo, export_plan, t_zoo_mod, "port")):
            ticks = [0.0]

            def perf_counter():
                ticks[0] += 0.25
                return ticks[0]

            monkeypatch.setattr(mod, "time", types.SimpleNamespace(
                perf_counter=perf_counter, monotonic=time.monotonic, sleep=time.sleep))
            clock = [0.0]
            zoo = Zoo(budget_bytes=2 * 1000 + 2, max_batch=8, cold_start_estimate_s=0.0)
            zoo._now = lambda: clock[0]
            try:
                fits = [reference_tiny_mnist(seed=s) for s in range(3)]
                for i, (jf, tf, _) in enumerate(fits):
                    clock[0] += 1.0
                    zoo.add_tenant(f"t{i}", exp(jf if pkg == "ref" else tf,
                                                np.zeros(TINY_D_IN, np.float32), max_batch=8),
                                   resident_bytes=1000)
                X = fits[0][2]
                for t in ("t1", "t0", "t2", "t1", "t0"):
                    clock[0] += 2.5
                    zoo.submit(t, X[0]).result(timeout=30)
                books = {n: {k: b[k] for k in ("resident", "offered", "completed", "rejected",
                                               "failed", "page_ins", "page_outs",
                                               "guaranteed_share", "last_used_age_s")}
                         for n, b in zoo.stats()["tenants"].items()}
                log = []
                for d in zoo.decision_log():
                    inputs = {k: v for k, v in d["inputs"].items()
                              if k not in ("fingerprint", "paged_bytes", "compression")}
                    log.append(dict(d, inputs=inputs))
                logs.append((log, books, zoo.page_in_estimate_s()))
            finally:
                zoo.close()
        (j_log, j_books, j_est), (t_log, t_books, t_est) = logs
        assert [(d["action"], d["tenant"]) for d in t_log] == [
            ("evict", "t0"), ("page_out", "t0"), ("evict", "t2"), ("page_out", "t2"),
            ("page_in", "t0"), ("evict", "t1"), ("page_out", "t1"), ("page_in", "t2"),
            ("evict", "t0"), ("page_out", "t0"), ("page_in", "t1"), ("evict", "t2"),
            ("page_out", "t2"), ("page_in", "t0")]
        assert t_log == j_log
        assert t_books == j_books
        assert t_est == j_est

    def test_admission_books_and_shares(self):
        """The fair-admission script on both packages: the same refusals
        (queue cap, fair share), the same guaranteed shares and the same
        per-tenant books."""
        from keystone_tpu.serving import ModelZoo as JZoo
        from keystone_tpu.serving import ServerOverloaded as JOverloaded
        from keystone_tpu.serving import export_plan as j_export

        out = []
        for Zoo, exp, over, pkg in ((JZoo, j_export, JOverloaded, "ref"),
                                     (ModelZoo, export_plan, ServerOverloaded, "port")):
            zoo = Zoo(budget_bytes=1 << 20, max_batch=64, max_wait_ms=500.0,
                      max_outstanding_total=6, tenant_queue_cap=4)
            events = []
            try:
                fits = [reference_tiny_mnist(seed=s) for s in range(3)]
                for name, w, (jf, tf, _) in zip(("a", "b", "c"), (1.0, 2.0, 3.0), fits):
                    zoo.add_tenant(name, exp(jf if pkg == "ref" else tf,
                                             np.zeros(TINY_D_IN, np.float32), max_batch=64),
                                   weight=w)
                X = fits[0][2]
                futs = []
                for tenant in "cccccaaabbbc":
                    try:
                        futs.append(zoo.submit(tenant, X[0]))
                        events.append((tenant, "admitted"))
                    except over as e:
                        events.append((tenant, str(e).split(" (")[0]))
                shares = {n: zoo.guaranteed_share(n) for n in "abc"}
                for f in futs:
                    f.result(timeout=30)
                st = zoo.stats()
                books = {n: {k: b[k] for k in ("offered", "completed", "rejected", "failed",
                                               "outstanding", "guaranteed_share",
                                               "accounting_ok")}
                         for n, b in st["tenants"].items()}
                out.append((events, shares, books, st["accounting_ok"]))
            finally:
                zoo.close()
        assert out[0] == out[1]
        events = out[1][0]
        assert ("c", "tenant 'c' is at its queue cap") in events
        assert any("fair admission share" in e for _, e in events)


# ---------------------------------------------------------------------------
# run.py serve --tenants / --tenant-spec / --zoo-budget-mb
# ---------------------------------------------------------------------------

SERVE_TINY = ["serve", "--device", "cpu", "--input-dim", "32", "--numFFTs", "2",
              "--blockSize", "32", "--fit-n", "128", "--max-batch", "8", "--rate", "150",
              "--duration-s", "0.6"]
# One tenant's charge at SERVE_TINY: the block weights (32 x 10 + 10
# float32) and the two branches' signs (2 x 32 float32).
TINY_TENANT_BYTES = (32 * 10 + 10 + 2 * 32) * 4


def _serve(capsys, *argv):
    from keystone_tpu_torch import run

    rc = run.main(list(SERVE_TINY) + list(argv))
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 else None), out.err


def _books_balance(summary):
    return all(t["num_offered"] == t["num_samples"] + t["rejected"] + t["failed"]
               for t in summary["per_tenant"].values())


class TestZooCLI:
    def test_tenants_under_a_binding_budget_page(self, capsys):
        budget_mb = 2.5 * TINY_TENANT_BYTES / (1 << 20)
        rc, summary, err = _serve(capsys, "--tenants", "3", "--zoo-budget-mb", str(budget_mb),
                                  "--slo-p99-ms", "500")
        assert rc == 0, err
        assert summary["tenants"] == 3 and summary["num_tenants"] == 3
        assert summary["tenant_resident_bytes"] == {f"t{i}": TINY_TENANT_BYTES
                                                    for i in range(3)}
        assert summary["zoo_budget_bytes"] == int(budget_mb * (1 << 20))
        assert summary["residents"] <= 2
        assert summary["page_ins"] > 0 and summary["page_outs"] > 0
        assert summary["quarantined"] == 0
        assert summary["accounting_ok"] is True and _books_balance(summary)
        assert summary["offered_total"] == (summary["completed_total"]
                                            + summary["rejected_total"]
                                            + summary["failed_total"]) > 0
        assert set(summary["tenant_slo_states"]) == {"t0", "t1", "t2"}
        for t in summary["per_tenant"].values():
            assert t["offered_rate_hz"] == 50.0

    def test_tenant_spec_with_a_skewed_mix(self, capsys, tmp_path):
        spec = tmp_path / "tenants.json"
        spec.write_text(json.dumps({"tenants": [
            {"id": "big", "weight": 3.0, "rate_hz": 240},
            {"id": "small", "weight": 1.0, "rate_hz": 20},
            {"id": "mid"},
        ]}))
        rc, summary, err = _serve(capsys, "--tenant-spec", str(spec))
        assert rc == 0, err
        rates = {n: t["offered_rate_hz"] for n, t in summary["per_tenant"].items()}
        assert rates == {"big": 240.0, "small": 20.0, "mid": 50.0}
        offered = {n: t["num_offered"] for n, t in summary["per_tenant"].items()}
        assert offered["big"] > offered["mid"] > offered["small"]
        # Every tenant fits the default budget: nothing pages.
        assert summary["residents"] == 3 and summary["page_ins"] == 0
        assert summary["accounting_ok"] is True and _books_balance(summary)
        assert "tenant_slo_states" not in summary

    @pytest.mark.parametrize("argv,message", [
        (["--tenants", "2", "--autoscale", "--slo-p99-ms", "100"], "mutually exclusive"),
        (["--tenant-spec", "@dup"], "duplicate tenant ids"),
        (["--tenants", "2", "--zoo-budget-mb", "0.0001"], "could never be paged in"),
    ])
    def test_refusals(self, capsys, tmp_path, argv, message):
        if argv[-1] == "@dup":
            path = tmp_path / "dup.json"
            path.write_text(json.dumps({"tenants": [{"id": "a"}, {"id": "a"}]}))
            argv = argv[:-1] + [str(path)]
        rc, _, err = _serve(capsys, *argv)
        assert rc == 2 and message in err

    def test_malformed_tenant_spec_exits(self, capsys, tmp_path):
        path = tmp_path / "bad.json"
        path.write_text(json.dumps({"tenants": []}))
        with pytest.raises(SystemExit, match="expected"):
            _serve(capsys, "--tenant-spec", str(path))
