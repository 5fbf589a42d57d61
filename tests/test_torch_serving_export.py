"""The port's serving export (``keystone_tpu_torch/serving/export.py``)
against the reference's on the CPU.

Both packages export the same tiny MNIST fit: the reference's
(``tests/_serving_util.fit_tiny_mnist``) and the port's pipeline carrying
its signs, block weights and feature scalers (``interop``). They must give
the same bucket ladder and ``bucket_for``, and served outputs within 1e-5
absolute (float32 both sides; scores of size about 1). Then the
reference's own contract cases, on the port: validation, the warm path
never building a program, padding masked, the eager walk for host stages,
and fingerprints (two plans differing only in weights differ).
"""

import sys
import threading

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.durable import crc_of_array, fingerprint_token
from keystone_tpu_torch.serving import export_plan
from keystone_tpu_torch.serving.export import ExportedPlan, _default_buckets
from keystone_tpu_torch.workflow import Transformer
from keystone_tpu_torch.workflow.graph import Graph, NodeId, SinkId, SourceId
from keystone_tpu_torch.workflow.pipeline import FittedPipeline
from tests._torch_serving_util import (
    TINY_D_IN,
    CallCountingScale,
    fit_tiny_mnist,
    fitted_from_transformer,
    reference_tiny_mnist,
)

SERVED_ATOL = 1e-5


def _offline(fitted, X):
    return fitted.apply(Dataset.of(torch.from_numpy(X))).array.numpy()


class TestAgainstReference:
    @pytest.mark.parametrize("max_batch", [1, 2, 8, 48, 256])
    def test_same_buckets(self, max_batch):
        from keystone_tpu.serving.export import _default_buckets as j_buckets

        assert _default_buckets(max_batch) == j_buckets(max_batch)

    def test_same_bucket_for_and_served_outputs(self):
        from keystone_tpu.serving import export_plan as j_export

        j_fitted, t_fitted, _ = reference_tiny_mnist()
        example = np.zeros(TINY_D_IN, np.float32)
        j_plan = j_export(j_fitted, example, max_batch=16)
        t_plan = export_plan(t_fitted, example, max_batch=16)
        assert t_plan.buckets == j_plan.buckets
        assert t_plan.compiled and j_plan.compiled
        assert [t_plan.bucket_for(m) for m in range(1, 17)] == \
            [j_plan.bucket_for(m) for m in range(1, 17)]
        rng = np.random.default_rng(1)
        for m in (1, 3, 5, 16):
            X = rng.normal(size=(m, TINY_D_IN)).astype(np.float32)
            t_out, t_info = t_plan.apply_batch_info(list(X))
            j_out, j_info = j_plan.apply_batch_info(list(X))
            assert t_info == type(t_info)(**j_info.__dict__)
            assert t_out.dtype == np.float32 and t_out.shape == (m, 10)
            np.testing.assert_allclose(t_out, np.asarray(j_out), atol=SERVED_ATOL, rtol=0)

    def test_same_pinned_bytes(self):
        from keystone_tpu.serving import export_plan as j_export

        j_fitted, t_fitted, _ = reference_tiny_mnist()
        example = np.zeros(TINY_D_IN, np.float32)
        j_plan = j_export(j_fitted, example, max_batch=4)
        t_plan = export_plan(t_fitted, example, max_batch=4)
        # Both pin the signs and the block weights; the reference's
        # float64 weights under the tests' x64 are twice the port's.
        assert 0 < t_plan.pinned_bytes <= j_plan.pinned_bytes

    @pytest.mark.parametrize("value", [
        None, 3, 2.5, "x", [1, 2.0, "a"],
        np.arange(12, dtype=np.float32).reshape(3, 4),
        np.arange(5, dtype=np.int64),
        np.array([True, False]),
    ], ids=["none", "int", "float", "str", "list", "f32", "i64", "bool"])
    def test_fingerprint_token_is_the_references(self, value):
        from keystone_tpu.data.durable import fingerprint_token as j_token

        assert fingerprint_token(value) == j_token(value)
        if isinstance(value, np.ndarray):
            assert fingerprint_token(torch.from_numpy(value)) == j_token(value)

    def test_crc_of_array_is_the_references(self):
        from keystone_tpu.data.durable import crc_of_array as j_crc

        a = np.random.default_rng(0).normal(size=(7, 5)).astype(np.float32)
        assert crc_of_array(a) == j_crc(a)
        assert crc_of_array(a.T) == j_crc(a.T)  # a C-order copy first

    def test_bf16_token_reads_the_16_bit_pattern(self):
        import ml_dtypes

        from keystone_tpu.data.durable import fingerprint_token as j_token

        a = np.linspace(-3, 3, 12, dtype=np.float32)
        t = torch.from_numpy(a).to(torch.bfloat16)
        j = j_token(a.astype(ml_dtypes.bfloat16))
        assert fingerprint_token(t) == j
        assert j["dtype"] == "bfloat16"


class TestExportValidation:
    def test_rejects_unfitted_pipeline(self):
        t = CallCountingScale()
        with pytest.raises(TypeError, match="FittedPipeline"):
            export_plan(t.to_pipeline(), np.zeros(4, np.float32))

    def test_rejects_graph_with_estimator_state(self):
        from keystone_tpu_torch.workflow.operators import EstimatorOperator

        graph = Graph(
            sources=frozenset({SourceId(0)}),
            sink_dependencies={SinkId(0): NodeId(0)},
            operators={NodeId(0): EstimatorOperator()},
            dependencies={NodeId(0): (SourceId(0),)},
        )
        fitted = FittedPipeline(graph, SourceId(0), SinkId(0))
        with pytest.raises(TypeError, match="Non-transformer"):
            export_plan(fitted, np.zeros(4, np.float32))

    def test_buckets_are_powers_of_two_up_to_max(self):
        assert _default_buckets(256) == [2, 4, 8, 16, 32, 64, 128, 256]
        assert _default_buckets(1) == [1]
        assert _default_buckets(2) == [2]
        assert _default_buckets(48) == [2, 4, 8, 16, 32, 48]
        with pytest.raises(ValueError, match="max_batch"):
            _default_buckets(0)

    def test_batch_over_max_rejected(self):
        plan = export_plan(fitted_from_transformer(CallCountingScale()),
                           np.zeros(4, np.float32), max_batch=8)
        with pytest.raises(ValueError, match="max_batch"):
            plan.apply_batch([np.zeros(4, np.float32)] * 9)

    def test_cuda_plan_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            export_plan(fitted_from_transformer(CallCountingScale()),
                        np.zeros(4, np.float32), device="cuda")


class TestWarmPathNeverBuilds:
    def test_export_builds_every_bucket_then_serving_builds_nothing(self):
        t = CallCountingScale()
        plan = export_plan(fitted_from_transformer(t), np.zeros(6, np.float32), max_batch=16)
        assert plan.compiled
        assert plan.buckets == [2, 4, 8, 16]
        # One meta interpretation by the static verifier, one eager run
        # a bucket on the CPU (a capture, with its eager run, on the card).
        assert plan.trace_count == 4
        assert t.calls == 1 + 4
        assert plan.launches_per_replay == {} and plan.replays == {}
        rng = np.random.default_rng(0)
        for m in (1, 3, 4, 5, 11, 16, 2, 7):
            X = rng.normal(size=(m, 6)).astype(np.float32)
            np.testing.assert_array_equal(plan.apply_batch(list(X)), X * 2.0)
        assert plan.trace_count == 4, "a warm-path request built a program"

    def test_every_bucket_is_built_before_the_first_request(self):
        """Export builds the whole ladder, smallest bucket first; the first
        request at any bucket, and a hot swap's new plan, build nothing."""
        t = CallCountingScale()
        plan = export_plan(fitted_from_transformer(t), np.zeros(3, np.float32), max_batch=8)
        assert sorted(plan._programs) == plan.buckets == [2, 4, 8]
        assert plan.trace_count == 3 and t.calls == 1 + 3
        plan.apply_batch([np.ones(3, np.float32)])  # bucket 2, already built
        assert plan.trace_count == 3 and sorted(plan._programs) == [2, 4, 8]

    def test_off_ladder_shape_builds_once(self):
        plan = export_plan(fitted_from_transformer(CallCountingScale()),
                           np.zeros(3, np.float32), max_batch=8)
        X = np.ones((5, 3), np.float32)
        for _ in range(3):
            np.testing.assert_array_equal(plan.apply_padded(X), X * 2.0)
        assert plan.trace_count == len(plan.buckets) + 1

    def test_mnist_plan_composes_to_one_program(self):
        fitted, _ = fit_tiny_mnist()
        plan = export_plan(fitted, np.zeros(TINY_D_IN, np.float32), max_batch=8)
        assert plan.compiled
        assert len(plan.graph.nodes) == 1
        assert plan.pinned_bytes > 0
        assert plan.device == torch.device("cpu")

    def test_float64_requests_serve_as_float32(self):
        plan = export_plan(fitted_from_transformer(CallCountingScale()),
                           np.zeros(3, np.float64), max_batch=4)
        out = plan.apply_batch([np.ones(3)])
        assert plan.dtype == np.float32 and out.dtype == np.float32


class TestServedOutputs:
    def test_padding_masked_and_rows_match_offline(self):
        fitted, _ = fit_tiny_mnist()
        plan = export_plan(fitted, np.zeros(TINY_D_IN, np.float32), max_batch=16)
        X = np.random.default_rng(1).normal(size=(5, TINY_D_IN)).astype(np.float32)
        out, info = plan.apply_batch_info(list(X))
        assert out.shape[0] == 5
        assert info.bucket == 8 and info.batch_size == 5
        assert info.pad_fraction == pytest.approx(3 / 8)
        np.testing.assert_array_equal(out, _offline(fitted, X))

    def test_eager_fallback_for_host_stage(self):
        class HostSquash(Transformer):
            """No device_fn: forces the non-composable path."""

            def apply(self, x):
                return np.tanh(np.asarray(x))

            def batch_apply(self, ds):
                return Dataset(torch.tanh(torch.as_tensor(ds.array)), n=ds.n)

        plan = export_plan(fitted_from_transformer(HostSquash()), np.zeros(4, np.float32),
                           max_batch=8)
        assert not plan.compiled and plan.trace_count == 0 and plan._programs == {}
        X = np.random.default_rng(2).normal(size=(3, 4)).astype(np.float32)
        np.testing.assert_allclose(plan.apply_batch(list(X)), np.tanh(X), rtol=1e-6)

    def test_eager_walk_masks_padding_rows(self):
        seen = []

        class RecordsN(Transformer):
            def apply(self, x):
                return x

            def batch_apply(self, ds):
                seen.append((ds.n, tuple(ds.array.shape)))
                return ds

        plan = export_plan(fitted_from_transformer(RecordsN()), np.zeros(4, np.float32),
                           max_batch=8)
        plan.apply_batch([np.zeros(4, np.float32)] * 3)
        assert seen[-1] == (3, (4, 4))

    def test_singleton_request_bitwise_matches_offline(self):
        fitted, _ = fit_tiny_mnist(d_in=32, block_size=32, seed=4)
        plan = export_plan(fitted, np.zeros(32, np.float32), max_batch=8)
        X = np.random.default_rng(6).normal(size=(6, 32)).astype(np.float32)
        offline = _offline(fitted, X)
        for i in range(len(X)):
            out, info = plan.apply_batch_info([X[i]])
            assert info.bucket == 2 and info.pad_fraction == 0.5
            np.testing.assert_array_equal(out[0], offline[i])

    def test_single_request_measure(self):
        fitted, _ = fit_tiny_mnist()
        plan = export_plan(fitted, np.zeros(TINY_D_IN, np.float32), max_batch=4)
        assert plan.measure_single_request_s(reps=3) > 0.0


class TestChunkedBatchApply:
    def test_probe_row_is_recomputed_with_the_batch(self):
        """The chunked batch apply's one-row probe is dropped: a row's bits
        come from a call with the rest of its chunk, never from a one-row
        call (a function that marks one-row calls shows it)."""
        from keystone_tpu_torch.workflow import fusion

        def marks_one_row_calls(X):
            return X + float(X.shape[0] == 1)

        X = torch.arange(12, dtype=torch.float32).reshape(6, 2)
        torch.testing.assert_close(fusion._compose_in_chunks([marks_one_row_calls], X), X,
                                   rtol=0, atol=0)

    def test_plan_batch_apply_equals_its_program_at_the_batch(self):
        fitted, _ = fit_tiny_mnist(d_in=32, block_size=32, seed=3)
        plan = export_plan(fitted, np.zeros(32, np.float32), max_batch=8)
        X = np.random.default_rng(2).normal(size=(9, 32)).astype(np.float32)
        walked = FittedPipeline(plan.graph, plan.source, plan.sink).apply(
            Dataset.of(torch.from_numpy(X))).array.numpy()
        np.testing.assert_array_equal(walked, plan.apply_padded(X))


class TestLaunchCounting:
    """Replicas replay captured programs on their own threads, and a hot
    swap captures a new plan while the old one serves: the launch counters
    must add every thread's launches exactly and keep a capture's apart."""

    @pytest.fixture
    def counts(self):
        from keystone_tpu_torch.ops import cuda_ops

        saved = dict(cuda_ops.launches)
        cuda_ops.reset_launch_counts()
        yield cuda_ops
        cuda_ops.launches.update(saved)

    def test_counts_from_many_threads_add_up(self, counts):
        def bump():
            for _ in range(2000):
                counts.count_launches("cosine_features", 3)

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)  # switch threads often: lost updates show
        try:
            threads = [threading.Thread(target=bump) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert counts.launches["cosine_features"] == 8 * 2000 * 3

    def test_a_capture_record_takes_only_its_threads_launches(self, counts):
        with counts.recording_launches() as record:
            counts.count_launches("block_corr")
            other = threading.Thread(target=counts.count_launches, args=("block_corr", 5))
            other.start()
            other.join(timeout=10)
            with counts.recording_launches() as inner:
                counts.count_launches("gram_corr")
            counts.count_launches("block_corr")
        assert not other.is_alive()
        assert record == {"block_corr": 2} and inner == {"gram_corr": 1}
        assert counts.launches["block_corr"] == 5 and counts.launches["gram_corr"] == 0
        counts.count_launches("block_corr")
        assert counts.launches["block_corr"] == 6


def _graph_of(fitted):
    return fitted.transformer_graph, fitted.source, fitted.sink


class TestExportKnobs:
    def test_custom_buckets_must_reach_max_batch(self):
        fitted = fitted_from_transformer(CallCountingScale())
        with pytest.raises(ValueError, match="max_batch"):
            ExportedPlan(fitted.transformer_graph, fitted.source, fitted.sink,
                         np.zeros(4, np.float32), max_batch=16, buckets=[1, 4])

    def test_bucket_for_picks_smallest_fitting(self):
        plan = export_plan(fitted_from_transformer(CallCountingScale()),
                           np.zeros(4, np.float32), max_batch=32)
        assert plan.bucket_for(1) == 2
        assert plan.bucket_for(3) == 4
        assert plan.bucket_for(17) == 32
        for bad in (0, 33):
            with pytest.raises(ValueError):
                plan.bucket_for(bad)

    def test_a_tensor_that_cannot_move_fails_the_export_by_name(self, monkeypatch):
        """Pinning never leaves a weight behind quietly: the error names the
        operator and attribute (on the card, an out-of-memory move)."""
        t = CallCountingScale()
        t.scale = torch.ones(4)

        def refuse(self, *a, **k):
            raise RuntimeError("out of memory")

        monkeypatch.setattr(torch.Tensor, "to", refuse)
        with pytest.raises(RuntimeError, match=r"CallCountingScale\.scale.*out of memory"):
            ExportedPlan(*_graph_of(fitted_from_transformer(t)), np.zeros(4, np.float32),
                         max_batch=4, device="cpu")

    def test_pinning_moves_nothing_already_in_place(self):
        fitted, _ = fit_tiny_mnist()
        before = {id(v) for op in fitted.transformer_graph.operators.values()
                  for v in op.__dict__.values() if isinstance(v, torch.Tensor)}
        export_plan(fitted, np.zeros(TINY_D_IN, np.float32), max_batch=4, device="cpu")
        after = {id(v) for op in fitted.transformer_graph.operators.values()
                 for v in op.__dict__.values() if isinstance(v, torch.Tensor)}
        assert before == after


class TestPlanFingerprint:
    def test_distinct_weights_distinct_fingerprints(self):
        f1, _ = fit_tiny_mnist(seed=0)
        f2, _ = fit_tiny_mnist(seed=1)
        example = np.zeros(TINY_D_IN, np.float32)
        p1 = export_plan(f1, example, max_batch=8)
        p2 = export_plan(f2, example, max_batch=8)
        assert p1.fingerprint != p2.fingerprint
        p1b = export_plan(f1, example, max_batch=8)
        assert p1b.fingerprint == p1.fingerprint

    def test_weights_alone_change_the_fingerprint(self):
        """Two plans that differ ONLY in one weight entry (the same graph,
        shapes and dtypes) have different fingerprints."""
        from keystone_tpu_torch.ops.learning.block import BlockLinearMapper

        example = np.zeros(TINY_D_IN, np.float32)
        f1, _ = fit_tiny_mnist()
        f2, _ = fit_tiny_mnist()
        p_same = export_plan(f2, example, max_batch=4)
        (mapper,) = [o for o in f2.transformer_graph.operators.values()
                     if isinstance(o, BlockLinearMapper)]
        mapper.xs[0][0, 0] += 1.0
        p1 = export_plan(f1, example, max_batch=4)
        p2 = export_plan(f2, example, max_batch=4)
        assert p_same.fingerprint == p1.fingerprint
        assert p1.fingerprint != p2.fingerprint

    def test_bucket_ladder_is_part_of_the_identity(self):
        f1, _ = fit_tiny_mnist(seed=0)
        example = np.zeros(TINY_D_IN, np.float32)
        default = export_plan(f1, example, max_batch=8)
        singleton = export_plan(f1, example, max_batch=8, buckets=[1, 2, 4, 8])
        assert default.fingerprint != singleton.fingerprint

    def test_dict_valued_operator_state_reaches_fingerprint(self):
        class VocabScale(Transformer):
            def __init__(self, vocab):
                self.vocab = vocab

            def apply(self, x):
                return torch.as_tensor(x) * float(len(self.vocab))

            def device_fn(self):
                scale = float(len(self.vocab))
                return lambda X: X * scale

        example = np.zeros(4, np.float32)

        def fp(vocab):
            return export_plan(fitted_from_transformer(VocabScale(vocab)), example,
                               max_batch=4).fingerprint

        base = {"a": 0, "b": 1}
        assert fp(base) != fp({"a": 0, "c": 1})
        assert fp(base) != fp({"a": 0, "b": 1, "c": 2})
        assert fp(base) == fp({"b": 1, "a": 0})
        assert fp({"a": {"x", "y"}}) != fp({"a": {"x", "z"}})
        assert fp({"a": [1, {"k": 2}]}) != fp({"a": [1, {"k": 3}]})

    def test_tensor_tokens_read_content(self):
        a = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        b = a.clone()
        b[1, 2] = -1.0
        assert fingerprint_token(a) == fingerprint_token(a.clone())
        assert fingerprint_token(a) != fingerprint_token(b)
        assert fingerprint_token(a)["shape"] == [2, 3]
        assert fingerprint_token(a.to(torch.bfloat16))["dtype"] == "bfloat16"
        assert fingerprint_token(torch.empty(2, device="meta")) == "Tensor"
