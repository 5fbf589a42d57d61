"""Out-of-core ingestion in the port's typed Pipeline API, on the CPU (twins
of tests/test_outofcore_pipeline.py and of the kill-and-resume cases of
tests/test_chaos.py, then the slice against the JAX package): loaders
spill to disk shards instead of a resident array, a shard-backed Dataset
flows through ``Pipeline.fit``, the capacity selector routes a dataset
past the host budget through the disk tier with no flag, and a killed
disk fold resumes from its checkpoint.

Tolerances and why:
  - spill round trips, depth 0 against depth 2, resumed against
    uninterrupted fits: bits (the same segments fold in the same order);
  - disk fits against resident fits of the same rows: the reference's
    5e-4 (the fold's tile differs, so float32 sums round differently);
  - the port's shard-backed TIMIT-shaped pipeline against the reference's
    on the same shard directory: the reference test's 2e-3 (two float32
    pipelines, cosine polynomial against XLA's cos);
  - the selector's disk-tier prices against the reference's: 1e-12
    relative (the same float64 formulas).
"""

import os

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data import Dataset, LabeledData
from keystone_tpu_torch.data.durable import CheckpointSpec
from keystone_tpu_torch.data.loaders import csv_to_disk_shards
from keystone_tpu_torch.data.shards import DiskCOOShards, DiskDenseShards, DiskDenseShardWriter
from keystone_tpu_torch.ops.learning.cost import LeastSquaresEstimator
from keystone_tpu_torch.ops.learning.lbfgs import _resident_chunk_fn, run_lbfgs_gram_streamed
from keystone_tpu_torch.ops.learning.streaming_ls import (
    BlockStreamedLeastSquares,
    CosineBankFeaturize,
    StreamingLeastSquaresChoice,
)
from keystone_tpu_torch.ops.stats import CosineRandomFeatures
from keystone_tpu_torch.parallel import streaming
from keystone_tpu_torch.utils.faults import FaultPlan, FaultRule
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.graph import Graph
from keystone_tpu_torch.workflow.operators import DatasetOperator
from keystone_tpu_torch.workflow.rules import _collect_samples


@pytest.fixture(autouse=True)
def fast_retry(monkeypatch):
    monkeypatch.setenv("KEYSTONE_RETRY_BASE_S", "0.001")
    PipelineEnv.get_or_create().reset()
    yield
    PipelineEnv.get_or_create().reset()


def _spilled_problem(tmp_path, n=1000, d=24, k=3, shard_rows=128, seed=0):
    """shard_rows does not divide n: a ragged final shard."""
    assert n % shard_rows != 0
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    Y = rng.normal(size=(n, k)).astype(np.float32) + 0.3
    sld = LabeledData(X, Y).to_disk_shards(str(tmp_path / "shards"), shard_rows=shard_rows,
                                           tiles_per_segment=2)
    return X, Y, sld


def _preds(model, X):
    return model.batch_apply(Dataset.of(X)).to_numpy()


def _choice(**kw):
    return StreamingLeastSquaresChoice(device="cpu", **kw)


def _sample_of(est, sld):
    g = Graph()
    g, dn = g.add_node(DatasetOperator(sld.data), [])
    g, ln = g.add_node(DatasetOperator(sld.labels), [])
    g, en = g.add_node(est, [dn, ln])
    g, _ = g.add_sink(en)
    return _collect_samples(g, [en], samples_per_shard=3)[en]


class TestSpillPath:
    def test_loader_spill_roundtrips_rows(self, tmp_path):
        X, Y, sld = _spilled_problem(tmp_path)
        assert sld.data.is_shard_backed and sld.labels.is_shard_backed
        assert sld.data.n == X.shape[0]
        np.testing.assert_array_equal(sld.data.to_numpy(), X)
        np.testing.assert_array_equal(sld.labels.to_numpy(), Y)

    def test_csv_dir_to_disk_shards_roundtrip_fit(self, tmp_path):
        rng = np.random.default_rng(1)
        n, d, num_classes = 541, 12, 4
        X = rng.normal(size=(n, d))
        labels = rng.integers(0, num_classes, size=n)
        csv_dir = tmp_path / "csv"
        csv_dir.mkdir()
        splits = [0, 200, 437, n]  # ragged files
        for i in range(3):
            with open(csv_dir / f"part{i}.csv", "w") as f:
                for r in range(splits[i], splits[i + 1]):
                    f.write(",".join([str(labels[r])] + [f"{v:.6f}" for v in X[r]]) + "\n")
        (csv_dir / "part3_empty.csv").touch()  # _SUCCESS-marker semantics
        sld = csv_to_disk_shards(str(csv_dir), str(tmp_path / "spill"), shard_rows=128,
                                 tiles_per_segment=2, num_classes=num_classes)
        assert sld.data.n == n
        np.testing.assert_allclose(sld.data.to_numpy(), X.astype(np.float32), atol=1e-5)
        Y_expect = 2.0 * np.eye(num_classes, dtype=np.float32)[labels] - 1.0
        np.testing.assert_array_equal(sld.labels.to_numpy(), Y_expect)
        choice = _choice(num_iter=2, lam=1e-2, block_size_hint=12)
        m_disk = choice.fit(sld.data, sld.labels)
        m_res = choice.fit(Dataset.of(X.astype(np.float32)), Dataset.of(Y_expect))
        np.testing.assert_allclose(_preds(m_disk, X.astype(np.float32)),
                                   _preds(m_res, X.astype(np.float32)), atol=5e-4, rtol=5e-4)

    def test_csv_spill_preserves_float_labels(self, tmp_path):
        rng = np.random.default_rng(5)
        n, d = 40, 3
        X = rng.normal(size=(n, d))
        y = rng.uniform(0.1, 2.0, size=n)
        csv = tmp_path / "reg.csv"
        with open(csv, "w") as f:
            for r in range(n):
                f.write(",".join([f"{y[r]:.6f}"] + [f"{v:.6f}" for v in X[r]]) + "\n")
        sld = csv_to_disk_shards(str(csv), str(tmp_path / "regspill"), shard_rows=16)
        np.testing.assert_allclose(sld.labels.to_numpy().ravel(), y.astype(np.float32),
                                   atol=1e-5)

    def test_writer_overshoot_capacity_records_true_rows(self, tmp_path):
        w = DiskDenseShardWriter(str(tmp_path / "w"), capacity_rows=1000, d_in=4, k=1,
                                 tile_rows=64)
        rng = np.random.default_rng(2)
        blocks = [rng.normal(size=(m, 4)).astype(np.float32) for m in (100, 37, 240)]
        for b in blocks:
            w.append(b, np.ones((b.shape[0], 1), np.float32))
        shards = w.close()
        assert shards.n_true == 377 and shards.num_tiles == -(-377 // 64)
        np.testing.assert_allclose(shards.as_source().materialize()[0], np.concatenate(blocks))

    def test_csv_spill_equals_the_reference_spill(self, tmp_path):
        from keystone_tpu.data.loaders import csv_to_disk_shards as j_csv_to_disk_shards

        rng = np.random.default_rng(6)
        csv = tmp_path / "t.csv"
        with open(csv, "w") as f:
            for r in range(97):
                f.write(",".join([str(r % 5)] + [f"{v:.5f}" for v in rng.normal(size=7)])
                        + "\n")
        t = csv_to_disk_shards(str(csv), str(tmp_path / "t"), shard_rows=16, num_classes=5)
        j = j_csv_to_disk_shards(str(csv), str(tmp_path / "j"), shard_rows=16, num_classes=5)
        np.testing.assert_array_equal(t.data.to_numpy(), np.asarray(j.data.to_numpy()))
        np.testing.assert_array_equal(t.labels.to_numpy(), np.asarray(j.labels.to_numpy()))


class TestCapacitySelection:
    def test_over_host_budget_routes_to_disk_tier(self, tmp_path):
        X, Y, sld = _spilled_problem(tmp_path)
        est = LeastSquaresEstimator(lam=0.1, host_budget_bytes=16 << 10)
        s, ls = _sample_of(est, sld)
        assert getattr(s, "shard_backed", False)
        assert s.total_n == X.shape[0]
        chosen = est.optimize(s, ls)
        assert isinstance(chosen, StreamingLeastSquaresChoice)
        assert chosen.data_is_shard_backed
        assert est.last_decision["context"]["shard_backed"] is True

    def test_under_host_budget_keeps_resident_solver(self, tmp_path):
        X, Y, sld = _spilled_problem(tmp_path)
        est = LeastSquaresEstimator(lam=0.1, host_budget_bytes=1 << 30)
        s, ls = _sample_of(est, sld)
        assert not isinstance(est.optimize(s, ls), StreamingLeastSquaresChoice)

    def test_shard_backed_pricing_matches_gram_fold_execution(self):
        choice = StreamingLeastSquaresChoice(num_iter=2, lam=1e-2)
        choice.data_is_shard_backed = True
        choice.shard_segment_bytes = 1 << 20
        choice.budget_bytes = 1 << 30  # 8d² at d = 60k is far past the budget
        d = 60_000
        rb = choice.resident_bytes(10_000_000, d, 4, 1.0, 1)
        assert rb >= 8.0 * d * d
        assert rb == choice.resident_bytes(10, d, 4, 1.0, 1)  # no term in n

    def test_host_cut_applies_to_plain_resident_data_too(self):
        rng = np.random.default_rng(3)
        est = LeastSquaresEstimator(lam=0.1, hbm_bytes=8 << 30, host_budget_bytes=1 << 20)
        s = Dataset.of(rng.normal(size=(24, 512)).astype(np.float32))
        s.total_n = 10_000_000
        s.source_row_bytes = 2048.0
        ls = Dataset.of(rng.normal(size=(24, 4)).astype(np.float32))
        assert est.optimize(s, ls) is not None
        assert est.last_decision["reason"] == "least_resident_fallback"

    def test_sample_facts_and_prices_equal_the_reference(self, tmp_path, monkeypatch):
        from keystone_tpu.data import shards as jshards
        from keystone_tpu.ops.learning.cost import LeastSquaresEstimator as JLS
        from keystone_tpu.workflow.graph import Graph as JGraph
        from keystone_tpu.workflow.operators import DatasetOperator as JDatasetOperator
        from keystone_tpu.workflow.rules import _collect_samples as j_collect

        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", "ec2")
        X, Y, sld = _spilled_problem(tmp_path, n=1000, d=24, k=3)
        est = LeastSquaresEstimator(lam=0.1, hbm_bytes=4 << 30, host_budget_bytes=16 << 10)
        s, ls = _sample_of(est, sld)
        jsld = jshards.DiskDenseShards(str(tmp_path / "shards")).as_labeled_data()
        jest = JLS(lam=0.1, hbm_bytes=4 << 30, host_budget_bytes=16 << 10, num_machines=1)
        g = JGraph()
        g, dn = g.add_node(JDatasetOperator(jsld.data), [])
        g, ln = g.add_node(JDatasetOperator(jsld.labels), [])
        g, en = g.add_node(jest, [dn, ln])
        g, _ = g.add_sink(en)
        js, jls = j_collect(g, [en], samples_per_shard=3)[en]
        for key in ("total_n", "source_row_bytes", "shard_backed", "shard_segment_bytes"):
            assert getattr(s, key) == getattr(js, key), key
        np.testing.assert_array_equal(s.to_numpy(), np.asarray(js.array))
        est.optimize(s, ls)
        jest.optimize(js, jls)
        t_choice, j_choice = est._streaming_choice, jest._streaming_choice
        for n, d, k in ((1000, 24, 3), (2_200_000, 16384, 147)):
            t_rb = t_choice.resident_bytes(n, d, k, 1.0, 1)
            j_rb = j_choice.resident_bytes(n, d, k, 1.0, 1)
            assert t_rb == pytest.approx(j_rb, rel=1e-12)
        assert type(est.optimize(s, ls)).__name__ == type(jest.optimize(js, jls)).__name__


class TestOutOfCorePipelineFit:
    def test_pipeline_fit_over_host_budget_no_flag(self, tmp_path):
        rng = np.random.default_rng(0)
        n, d_in, d_feat, k = 4096, 16, 256, 4
        X = rng.normal(size=(n, d_in)).astype(np.float32)
        Y = rng.normal(size=(n, k)).astype(np.float32)
        sld = LabeledData(X, Y).to_disk_shards(str(tmp_path / "sh"), shard_rows=384,
                                               tiles_per_segment=2)
        crf = CosineRandomFeatures(d_in, d_feat, 0.2, seed=1, device="cpu")
        auto = LeastSquaresEstimator(lam=0.1, host_budget_bytes=64 << 10)
        p = crf.to_pipeline().and_then(auto, sld.data, sld.labels)
        res = p.apply(Dataset.of(X[:256]))
        preds = res.get().to_numpy()
        labels = [str(getattr(op, "label", type(op).__name__))
                  for op in res.executor.optimized_graph.operators.values()]
        assert any("StreamedFit" in label for label in labels), labels
        choice = auto._streaming_choice
        assert choice.data_is_shard_backed
        ref = choice.build_estimator(CosineBankFeaturize(crf.W, crf.b), d_feat).fit(
            Dataset.of(X), Dataset.of(Y))
        ref_preds = _preds(ref, X[:256])
        np.testing.assert_allclose(preds, ref_preds, atol=2e-3, rtol=2e-3)
        fitted = p.fit()
        np.testing.assert_allclose(fitted.apply(Dataset.of(X[:256])).to_numpy(), ref_preds,
                                   atol=2e-3, rtol=2e-3)

    def test_direct_choice_fit_from_shards_matches_resident(self, tmp_path):
        X, Y, sld = _spilled_problem(tmp_path, n=900, d=32, k=3)
        choice = _choice(num_iter=2, lam=1e-2, block_size_hint=16)
        m_disk = choice.fit(sld.data, sld.labels)
        m_res = choice.fit(Dataset.of(X), Dataset.of(Y))
        np.testing.assert_allclose(_preds(m_disk, X), _preds(m_res, X), atol=5e-4, rtol=5e-4)

    def test_mismatched_labels_against_paired_source_raise(self, tmp_path):
        X, Y, sld = _spilled_problem(tmp_path, n=500, d=8, k=2)
        data = Dataset.from_shards(DiskDenseShards(str(tmp_path / "shards")).as_source())
        choice = _choice(num_iter=1, lam=1e-2)
        with pytest.raises(ValueError, match="embeds its own labels"):
            choice.fit(data, Dataset.of(np.zeros((500, 2), np.float32)))
        assert choice.fit(data, sld.labels) is not None

    def test_label_view_loads_only_labels(self, tmp_path, monkeypatch):
        X, Y, sld = _spilled_problem(tmp_path, n=500, d=8, k=2)
        view = sld.labels.shard_source

        def no_rows(self, s):
            raise AssertionError("label view read the row file")

        monkeypatch.setattr(type(view.paired.shards), "segment_source_x", no_rows)
        assert view.load(0).shape[-1] == 2
        np.testing.assert_array_equal(view.materialize(), Y)

    def test_resident_labels_pair_with_shard_backed_rows(self, tmp_path):
        X, Y, sld = _spilled_problem(tmp_path, n=700, d=16, k=2)
        choice = _choice(num_iter=2, lam=1e-2, block_size_hint=16)
        m_mix = choice.fit(sld.data, Dataset.of(Y))
        m_disk = choice.fit(sld.data, sld.labels)
        np.testing.assert_array_equal(_preds(m_mix, X), _preds(m_disk, X))

    def test_block_streamed_accepts_shard_backed(self, tmp_path, monkeypatch):
        X, Y, sld = _spilled_problem(tmp_path, n=700, d=16, k=2)
        rng = np.random.default_rng(4)
        d_feat = 64
        bank = CosineBankFeaturize(
            torch.from_numpy(rng.normal(size=(d_feat, 16)).astype(np.float32) * 0.3),
            torch.from_numpy(rng.uniform(0, 6, d_feat).astype(np.float32)),
        )
        est = BlockStreamedLeastSquares(bank, d_feat=d_feat, block_size=16, num_iter=2,
                                        lam=1e-2)
        seen = []

        def spy(X_in, Y_in, Wrf, brf, **kw):
            seen.append((X_in.numpy().copy(), Y_in.numpy().copy()))
            return torch.zeros((4, 16, 2)), torch.zeros(d_feat), torch.zeros(2)

        monkeypatch.setattr(streaming, "streaming_block_bcd_mesh", spy)
        est.fit(sld.data, sld.labels)
        est.fit(Dataset.of(X), Dataset.of(Y))
        np.testing.assert_array_equal(seen[0][0], seen[1][0])
        np.testing.assert_array_equal(seen[0][1], seen[1][1])

    def test_timit_shaped_pipeline_against_the_reference(self, tmp_path, monkeypatch):
        """The acceptance case: a shard-backed TIMIT-width dataset past the
        host budget fits through the disk tier in both packages, from one
        shard directory, with the same cosine draws."""
        import jax.numpy as jnp

        from keystone_tpu.data import shards as jshards
        from keystone_tpu.data import Dataset as JDataset
        from keystone_tpu.ops.learning.cost import LeastSquaresEstimator as JLS
        from keystone_tpu.ops.stats import CosineRandomFeatures as JCRF
        from keystone_tpu.workflow import PipelineEnv as JPipelineEnv
        from keystone_tpu_torch import interop

        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", "ec2")
        JPipelineEnv.get_or_create().reset()
        rng = np.random.default_rng(12)
        n, d_in, classes, d_feat = 3000, 440, 147, 256
        labels = rng.integers(0, classes, size=n)
        X = (rng.normal(size=(classes, d_in))[labels] * 0.6
             + rng.normal(size=(n, d_in))).astype(np.float32)
        sld = LabeledData(X, labels).to_disk_shards(str(tmp_path / "timit"), shard_rows=256,
                                                    tiles_per_segment=2, num_classes=classes)
        jcrf = JCRF(d_in, d_feat, 0.05555, seed=3)
        crf = interop.cosine_features_model(np.asarray(jcrf.W), np.asarray(jcrf.b), device="cpu")
        budget = 256 << 10  # below the raw rows' 5.3 MB
        auto = LeastSquaresEstimator(lam=1e-3, host_budget_bytes=budget, block_size=128)
        fitted = crf.to_pipeline().and_then(auto, sld.data, sld.labels).fit()
        assert auto._streaming_choice.data_is_shard_backed
        assert auto.last_decision["winner"] == "StreamingLeastSquaresChoice"
        preds = fitted.apply(Dataset.of(X[:300])).to_numpy()
        jsld = jshards.DiskDenseShards(str(tmp_path / "timit")).as_labeled_data()
        jauto = JLS(lam=1e-3, host_budget_bytes=budget, block_size=128, num_machines=1)
        jfitted = jcrf.to_pipeline().and_then(jauto, jsld.data, jsld.labels).fit()
        assert jauto._streaming_choice.data_is_shard_backed
        jpreds = np.asarray(jfitted.apply(JDataset.of(jnp.asarray(X[:300]))).array)
        np.testing.assert_allclose(preds, jpreds, atol=2e-3, rtol=2e-3)
        JPipelineEnv.get_or_create().reset()


def _dense_problem(tmp_path, n=700, d_in=10, k=3, tile=64, tps=2):
    rng = np.random.default_rng(7)
    X = rng.normal(size=(n, d_in)).astype(np.float32)
    Y = rng.normal(size=(n, k)).astype(np.float32)
    shards = DiskDenseShards.write(str(tmp_path / "dense"), X, Y, tile_rows=tile,
                                   tiles_per_segment=tps)
    d_feat, bs = 32, 8
    bank = CosineBankFeaturize(
        torch.from_numpy(rng.normal(size=(d_feat, d_in)).astype(np.float32) * 0.3),
        torch.from_numpy(rng.uniform(0, 6, d_feat).astype(np.float32)),
    )

    def fit(bank=bank, **kw):
        return streaming.streaming_bcd_fit_segments(
            shards.as_source(), bank=bank, d_feat=d_feat, block_size=bs, lam=1e-2, num_iter=2,
            **kw)

    return shards, fit


class TestKillResume:
    """A disk fit killed through an injected fault and resumed from its
    checkpoint gives the uninterrupted fit's bits."""

    @pytest.mark.parametrize("depth", [2, 0])
    def test_dense_fit_killed_and_resumed_bit_identical(self, tmp_path, depth):
        shards, fit = _dense_problem(tmp_path)
        assert shards.num_segments >= 5
        want = fit(prefetch_depth=depth)
        ck = CheckpointSpec(str(tmp_path / "ck"), every_segments=2)
        # Segment 4's three load attempts: one prefetch.read a load, or,
        # serially, shard.load on its row read (two reads a segment).
        rule = (FaultRule("prefetch.read", "error", calls=[4, 5, 6]) if depth
                else FaultRule("shard.load", "error", calls=[8, 9, 10]))
        with FaultPlan([rule]):
            with pytest.raises(OSError):
                fit(checkpoint=ck, prefetch_depth=depth)
        assert ck.has_snapshot()
        got = fit(checkpoint=ck, prefetch_depth=depth)
        for a, b in zip(want, got):
            assert torch.equal(a, b)
        assert not ck.has_snapshot()

    def test_coo_gram_fit_killed_and_resumed_bit_identical(self, tmp_path):
        rng = np.random.default_rng(3)
        n, d, k, w_act, chunk = 900, 96, 2, 5, 128
        coo = DiskCOOShards.write(
            str(tmp_path / "coo"), rng.integers(0, d, size=(n, w_act)).astype(np.int32),
            rng.normal(size=(n, w_act)).astype(np.float32),
            rng.normal(size=(n, k)).astype(np.float32), chunk_rows=chunk, n_true=n, d=d)

        def fit(**kw):
            return run_lbfgs_gram_streamed(
                _resident_chunk_fn, coo.num_chunks, d, k, lam=1e-2, num_iterations=12, n=n,
                segment_source=coo.as_source(2), prefetch_depth=2, device="cpu", **kw)

        W0, loss0 = fit()
        ck = CheckpointSpec(str(tmp_path / "ck2"), every_segments=1)
        with FaultPlan([FaultRule("prefetch.read", "error", calls=[2, 3, 4])]):
            with pytest.raises(OSError):
                fit(checkpoint=ck)
        W1, loss1 = fit(checkpoint=ck)
        assert torch.equal(W0, W1) and torch.equal(loss0, loss1)

    def test_segmented_resident_fold_under_the_checkpoint_dir(self, tmp_path, monkeypatch):
        """``--checkpoint-dir`` (KEYSTONE_CHECKPOINT_DIR) insures a
        segmented fold over resident chunks: killed, it resumes."""
        rng = np.random.default_rng(5)
        nc, c, d, k = 6, 64, 48, 2
        ops = (torch.from_numpy(rng.integers(0, d, size=(nc, c, 4)).astype(np.int32)),
               torch.from_numpy(rng.normal(size=(nc, c, 4)).astype(np.float32)),
               torch.from_numpy(rng.normal(size=(nc, c, k)).astype(np.float32)))
        calls = {"n": 0}

        def chunk(cid, it, vt, yt):
            calls["n"] += 1
            if calls.get("kill") == calls["n"]:
                raise RuntimeError("killed")
            cid = min(cid, it.shape[0] - 1)
            return it[cid], vt[cid], yt[cid]

        kw = dict(lam=1e-2, num_iterations=10, n=nc * c, operands=ops, max_chunks_per_dispatch=2)
        W0, _ = run_lbfgs_gram_streamed(chunk, nc, d, k, **kw)
        monkeypatch.setenv("KEYSTONE_CHECKPOINT_DIR", str(tmp_path / "env"))
        monkeypatch.setenv("KEYSTONE_CHECKPOINT_EVERY", "1")
        # Each call resolves its own spec from the variable: synchronous
        # writes, so the killed run's snapshots are on disk when the next
        # run looks.
        monkeypatch.setenv("KEYSTONE_CHECKPOINT_SYNC", "1")
        calls.update(n=0, kill=5)
        with pytest.raises(RuntimeError, match="killed"):
            run_lbfgs_gram_streamed(chunk, nc, d, k, **kw)
        calls.update(n=0, kill=None)
        W1, _ = run_lbfgs_gram_streamed(chunk, nc, d, k, **kw)
        assert torch.equal(W0, W1)
        assert calls["n"] == 2  # resumed after two folded segments: one of two chunks left
        assert os.listdir(tmp_path / "env") == []

    def test_stale_checkpoint_from_different_bank_is_ignored(self, tmp_path):
        shards, fit = _dense_problem(tmp_path)
        rng = np.random.default_rng(99)
        other = CosineBankFeaturize(
            torch.from_numpy(rng.normal(size=(32, 10)).astype(np.float32) * 0.3),
            torch.from_numpy(rng.uniform(0, 6, 32).astype(np.float32)),
        )
        want = fit(bank=other)
        ck = CheckpointSpec(str(tmp_path / "ck"), every_segments=2)
        with FaultPlan([FaultRule("prefetch.read", "error", calls=[4, 5, 6])]):
            with pytest.raises(OSError):
                fit(checkpoint=ck)
        assert torch.equal(fit(bank=other, checkpoint=ck)[0], want[0])

    def test_checkpoint_needs_segmented_fit(self):
        ops = (torch.zeros((2, 8, 2), dtype=torch.int32), torch.zeros((2, 8, 2)),
               torch.zeros((2, 8, 1)))
        with pytest.raises(ValueError, match="segmented"):
            run_lbfgs_gram_streamed(_resident_chunk_fn, 2, 8, 1, n=16, operands=ops,
                                    checkpoint=CheckpointSpec("/tmp/never-used"))

    def test_resumed_snapshot_reads_across_packages(self, tmp_path):
        """A snapshot the port's disk fold leaves is the reference's format:
        the reference's CheckpointSpec loads it, arrays and cursor."""
        from keystone_tpu.data.durable import CheckpointSpec as JCheckpointSpec

        shards, fit = _dense_problem(tmp_path)
        ck = CheckpointSpec(str(tmp_path / "ck"), every_segments=2)
        with FaultPlan([FaultRule("prefetch.read", "error", calls=[4, 5, 6])]):
            with pytest.raises(OSError):
                fit(checkpoint=ck)
        assert ck.has_snapshot()  # waits out the write-behind snapshot
        fit_dirs = [e for e in os.listdir(tmp_path / "ck") if e.startswith("fit-")]
        assert len(fit_dirs) == 1
        import json

        with open(tmp_path / "ck" / fit_dirs[0] / "checkpoint.json") as f:
            fingerprint = json.load(f)["fingerprint"]
        arrays, cursor = ck.load(fingerprint)
        j_arrays, j_cursor = JCheckpointSpec(str(tmp_path / "ck")).load(fingerprint)
        assert cursor == j_cursor and cursor % 2 == 0
        for a, b in zip(arrays, j_arrays):
            np.testing.assert_array_equal(a, np.asarray(b))


class TestHostBudgetFlag:
    def test_flag_sets_the_variable_the_selector_reads(self, monkeypatch, tmp_path):
        from keystone_tpu_torch import run

        monkeypatch.setenv("KEYSTONE_HOST_BUDGET_BYTES", "")
        rest = run._extract_global_flags(["--host-budget-bytes=16384", "TimitPipeline",
                                          f"--checkpoint-dir={tmp_path}"])
        assert rest == ["TimitPipeline"]
        assert os.environ["KEYSTONE_HOST_BUDGET_BYTES"] == "16384"
        X, Y, sld = _spilled_problem(tmp_path)
        est = LeastSquaresEstimator(lam=0.1)
        s, ls = _sample_of(est, sld)
        assert isinstance(est.optimize(s, ls), StreamingLeastSquaresChoice)
        assert est.last_decision["context"]["host_budget_bytes"] == 16384.0
