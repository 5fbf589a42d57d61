"""The port's one-host mesh (``parallel/mesh.py``) and the sharded Dataset
against the JAX package's on its 8-device CPU mesh (tests/conftest.py
forces 8 host devices; ``data_mesh`` below is the reference's default
1-D mesh over them). The port's mesh here is 8 shards on the CPU.

Inputs come from seeded numpy generators and are float32 on both sides
(tests/conftest.py turns on x64, so arrays handed to JAX are cast to
float32 first).

Tolerances and why:
  - padding, shard layout, masks, splits, concatenations and the
    re-zeroed padding: exact (copies and zero fills);
  - the sharded cosine apply: 1e-6 absolute (the port's plain cosine is
    its kernel's polynomial, within 4e-7 of XLA's ``cos``);
  - StandardScaler on sharded rows: means 1e-6 relative (the psum
    reassociates the column sums of 8 shards); stds 1e-5, their
    sum(x²) − n·mean² cancels (rows of mean 3, unit spread) and magnifies
    the reassociation (measured 2e-6).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.parallel import mesh as jmesh
from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.parallel import mesh as tmesh

CPU8 = ["cpu"] * 8


@pytest.fixture()
def data_mesh():
    return jmesh.make_mesh()


@pytest.fixture()
def mesh8():
    return tmesh.make_mesh((8,), devices=CPU8)


def _rows(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _np(x):
    if isinstance(x, tmesh.ShardedRows):
        x = x.gather()
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class TestMesh:
    def test_axes_and_sizes_match_the_reference(self, data_mesh, mesh8):
        assert dict(mesh8.shape) == dict(data_mesh.shape) == {"data": 8}
        m42 = tmesh.make_mesh((4, 2), (tmesh.DATA_AXIS, tmesh.MODEL_AXIS), devices=CPU8)
        j42 = jmesh.make_mesh((4, 2), (jmesh.DATA_AXIS, jmesh.MODEL_AXIS))
        assert dict(m42.shape) == dict(j42.shape)
        for axis in ("data", "model", "absent"):
            assert tmesh.axis_size(m42, axis) == jmesh.axis_size(j42, axis)
        assert (tmesh.DATA_AXIS, tmesh.MODEL_AXIS) == (jmesh.DATA_AXIS, jmesh.MODEL_AXIS)

    def test_devices_repeat_to_fill_the_shape(self):
        mesh = tmesh.make_mesh((8,))
        assert mesh.size == 8 and {str(d) for d in mesh.devices.flat} == {"cpu"}
        with pytest.raises(ValueError, match="do not fill"):
            tmesh.make_mesh((4,), devices=["cpu"] * 3)

    def test_default_mesh_and_use_mesh(self, mesh8):
        tmesh.set_default_mesh(None)
        try:
            assert tmesh.default_mesh().shape == {"data": 1}  # one CPU here
            with tmesh.use_mesh(mesh8):
                assert tmesh.default_mesh() is mesh8
            assert tmesh.default_mesh() is not mesh8
        finally:
            tmesh.set_default_mesh(None)

    def test_hybrid_mesh_is_one_host_only(self):
        m = tmesh.make_hybrid_mesh((4, 2), (1, 1), ("data", "model"))
        j = jmesh.make_hybrid_mesh((4, 2), (1, 1), ("data", "model"))
        assert dict(m.shape) == dict(j.shape) == {"data": 4, "model": 2}
        # DCN axes span processes: without a process group they are refused
        # by name and number (tests/test_torch_multihost.py runs two).
        with pytest.raises(ValueError, match=r"DCN axes \(2, 1\) span 2 processes"):
            tmesh.make_hybrid_mesh((4, 1), (2, 1), ("data", "model"))
        tmesh.init_distributed()  # single process: a no-op, as the reference's
        assert not torch.distributed.is_initialized()

    @pytest.mark.parametrize("n", [16, 13, 1])
    def test_pad_rows_matches_the_reference(self, n):
        X = _rows(n, 3)
        got, n_got = tmesh.pad_rows(X, 8)
        want, n_want = jmesh.pad_rows(X, 8)
        assert n_got == n_want == n
        np.testing.assert_array_equal(got, want)
        t_got, _ = tmesh.pad_rows(torch.from_numpy(X), 8)
        np.testing.assert_array_equal(t_got.numpy(), want)

    def test_shard_rows_places_contiguous_shards(self, mesh8, data_mesh):
        X = _rows(16, 3)
        sh = tmesh.shard_rows(X, mesh8)
        jsh = jmesh.shard_rows(X, data_mesh)
        assert sh.num_shards == 8 and tuple(sh.shape) == jsh.shape
        jshards = sorted(jsh.addressable_shards, key=lambda s: s.index[0].start)
        for mine, theirs in zip(sh.shards, jshards):
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs.data))
        with pytest.raises(ValueError, match="pad them first"):
            tmesh.shard_rows(_rows(13, 3), mesh8)

    def test_shard_map_and_psum(self, mesh8):
        X = _rows(24, 4)
        sh = tmesh.shard_rows(X, mesh8)

        def body(x, w):
            assert 0 <= tmesh.axis_index("data") < 8
            return x @ w, x.T @ x

        w = torch.from_numpy(_rows(4, 2, seed=1))
        out, gram = tmesh.shard_map(body, mesh8, in_specs=("data", None),
                                    out_specs=("data", None))(sh, w)
        assert isinstance(out, tmesh.ShardedRows)
        np.testing.assert_allclose(_np(out), X @ w.numpy(), rtol=1e-6, atol=1e-6)
        want = sum(s.T @ s for s in sh.shards)  # the same order: bit for bit
        np.testing.assert_array_equal(gram.numpy(), want.numpy())
        with pytest.raises(RuntimeError, match="outside a shard_map"):
            tmesh.axis_index("data")

    def test_replicate(self, mesh8):
        copies = tmesh.replicate(np.ones(3, np.float32), mesh8)
        assert len(copies) == 8 and all(c.shape == (3,) for c in copies)


class TestShardedDataset:
    def test_shard_pads_to_the_mesh_multiple(self, mesh8, data_mesh):
        X = _rows(5, 2)
        ds, jds = TDataset.of(X).shard(mesh8), JDataset.of(X).shard(data_mesh)
        assert ds.n == jds.n == 5 and ds.num_padded == jds.num_padded == 8
        assert ds.mesh is mesh8 and ds.is_sharded
        np.testing.assert_array_equal(_np(ds.array), np.asarray(jds.array))
        np.testing.assert_array_equal(ds.to_numpy(), jds.to_numpy())
        np.testing.assert_array_equal(ds.valid_mask().numpy(),
                                      np.asarray(jds.valid_mask()))

    def test_map_batch_rezeroes_padding(self, mesh8, data_mesh):
        X = np.ones((5, 2), np.float32)
        out = TDataset.of(X).shard(mesh8).map_batch(lambda A: A + 7.0)
        jout = JDataset.of(X).shard(data_mesh).map_batch(lambda A: A + 7.0)
        assert out.is_sharded and out.mesh is mesh8
        np.testing.assert_array_equal(_np(out.array), np.asarray(jout.array))
        assert (_np(out.array)[5:] == 0).all()

    def test_tuple_payloads_shard_leaf_by_leaf(self, mesh8):
        a, b = _rows(11, 2), _rows(11, 3, seed=1)
        ds = TDataset((torch.from_numpy(a), torch.from_numpy(b))).shard(mesh8)
        assert all(isinstance(leaf, tmesh.ShardedRows) for leaf in ds.data)
        back = ds.to_list()
        assert len(back) == 11
        np.testing.assert_array_equal(back[10][1], b[10])

    def test_host_datasets_do_not_shard(self, mesh8):
        with pytest.raises(ValueError, match="Host datasets"):
            TDataset.of(["a", "b"]).shard(mesh8)

    def test_gather_carries_the_mesh(self, mesh8):
        a = TDataset.of(_rows(5, 2)).shard(mesh8)
        assert TDataset.gather([a, a]).mesh is mesh8


class TestShardedNodes:
    def test_cosine_apply_runs_on_each_shard(self, mesh8, data_mesh, monkeypatch):
        from keystone_tpu.ops.stats import CosineRandomFeaturesModel as JCos
        from keystone_tpu_torch.ops import cuda_ops
        from keystone_tpu_torch.ops.stats import CosineRandomFeaturesModel as TCos

        rng = np.random.default_rng(5)
        X = rng.normal(size=(61, 20)).astype(np.float32)
        W = (0.1 * rng.normal(size=(32, 20))).astype(np.float32)
        b = rng.uniform(0, 2 * np.pi, size=32).astype(np.float32)
        rows_seen = []
        real = cuda_ops.cosine_features

        def counting(Xs, *args, **kwargs):
            rows_seen.append(int(Xs.shape[0]))
            return real(Xs, *args, **kwargs)

        monkeypatch.setattr(cuda_ops, "cosine_features", counting)
        out = TCos(torch.from_numpy(W), torch.from_numpy(b)).batch_apply(
            TDataset.of(X).shard(mesh8))
        jout = JCos(jnp.asarray(W), jnp.asarray(b)).batch_apply(JDataset.of(X).shard(data_mesh))
        assert rows_seen == [8] * 8  # once a shard, on its rows
        assert out.is_sharded
        np.testing.assert_allclose(_np(out.array), np.asarray(jout.array), rtol=0, atol=1e-6)
        assert (_np(out.array)[61:] == 0).all()  # cos(b) re-zeroed on padding

    def test_standard_scaler_on_sharded_rows(self, mesh8, data_mesh):
        from keystone_tpu.ops.stats import StandardScaler as JScaler
        from keystone_tpu_torch.ops.stats import StandardScaler as TScaler

        X = 3.0 + _rows(37, 6)
        model = TScaler().fit(TDataset.of(X).shard(mesh8))
        jmodel = JScaler().fit(JDataset.of(X).shard(data_mesh))
        np.testing.assert_allclose(model.mean.numpy(), np.asarray(jmodel.mean), rtol=1e-6)
        np.testing.assert_allclose(model.std.numpy(), np.asarray(jmodel.std), rtol=1e-5)
        centred = model.batch_apply(TDataset.of(X).shard(mesh8))
        assert centred.is_sharded and (_np(centred.array)[37:] == 0).all()

    def test_splitter_combiner_labels_and_shuffler(self, mesh8, data_mesh):
        from keystone_tpu.ops.util import ClassLabelIndicatorsFromIntLabels as JLabels
        from keystone_tpu.ops.util import VectorSplitter as JSplit
        from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels as TLabels
        from keystone_tpu_torch.ops.util import Shuffler, VectorCombiner
        from keystone_tpu_torch.ops.util import VectorSplitter as TSplit

        X = _rows(13, 10)
        ds = TDataset.of(X).shard(mesh8)
        blocks = TSplit(4).apply(ds)
        jblocks = JSplit(4).apply(JDataset.of(X).shard(data_mesh))
        assert [tuple(b.array.shape) for b in blocks] == [b.array.shape for b in jblocks]
        for mine, theirs in zip(blocks, jblocks):
            assert mine.is_sharded and mine.mesh is mesh8
            np.testing.assert_array_equal(_np(mine.array), np.asarray(theirs.array))
        joined = VectorCombiner().batch_apply(TDataset.gather(blocks))
        assert joined.is_sharded
        np.testing.assert_array_equal(joined.to_numpy(), X)

        labels = np.arange(13) % 5
        enc = TLabels(5).batch_apply(TDataset.of(labels).shard(mesh8))
        jenc = JLabels(5).batch_apply(JDataset.of(labels).shard(data_mesh))
        assert enc.is_sharded
        np.testing.assert_array_equal(_np(enc.array), np.asarray(jenc.array))

        shuffled = Shuffler(seed=3).batch_apply(ds)
        assert shuffled.is_sharded and shuffled.num_padded == 16
        np.testing.assert_array_equal(np.sort(shuffled.to_numpy(), axis=0), np.sort(X, axis=0))

    def test_sample_collector_samples_per_shard(self, mesh8):
        # The optimizer's samples: samples_per_shard rows a data shard
        # (reference workflow/rules.py:259-266), the full n beside them.
        from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
        from keystone_tpu_torch.workflow.optimizable import OptimizableLabelEstimator

        seen = []

        class Probe(OptimizableLabelEstimator):
            @property
            def default(self):
                return BlockLeastSquaresEstimator(4, 1, 1e-2)

            def optimize(self, sample, labels_sample):
                seen.append((sample.n, sample.total_n, labels_sample.n))
                return None

        X, Y = _rows(100, 4), _rows(100, 2, seed=1)
        data, labels = TDataset.of(X).shard(mesh8), TDataset.of(Y).shard(mesh8)
        pipe = _identity_pipeline().and_then(Probe(), data, labels)
        pipe.fit()
        assert seen == [(24, 100, 24)]


def _identity_pipeline():
    from keystone_tpu_torch.workflow import Identity

    return Identity().to_pipeline()
