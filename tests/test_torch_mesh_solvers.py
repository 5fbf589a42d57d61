"""The port's mesh solvers on an 8-shard CPU mesh against the JAX
package's on its 8-device CPU mesh (tests/conftest.py forces 8 host
devices): ``bcd_least_squares(mesh=)`` and the block estimator on sharded
rows (the reference's ``_mesh_bcd_step``), the mesh ``tsqr_r``, the
streamed mesh folds (``gram_stats_mesh``, ``streaming_bcd_fit_mesh`` and
its centred form, through ``StreamingFeaturizedLeastSquares`` too), the
block-streamed program over a mesh (through ``BlockStreamedLeastSquares``
too) and its 2-D form on a 4 × 2 mesh, and a TIMIT-shaped pipeline fit on
sharded rows.

Inputs come from seeded numpy generators and are float32 on both sides
(tests/conftest.py turns on x64, so arrays handed to JAX are cast to
float32 first); the reference's featurizer is XLA's ``cos(X Wᵀ + b)``, the
port's its cosine kernel's plain version. Row counts that do not divide
by 8 are zero-padded and the true count passed, as the reference's
callers do. On the CPU the port's wrappers compute their kernels' plain
versions; which kernels the mesh path calls, and on which rows, is
counted by wrapping the wrappers.

Tolerances and why (relative Frobenius unless stated):
  - ``bcd_least_squares(mesh=)``, the block estimator, the TIMIT-shaped
    pipeline: 1e-5. The same Gauss-Seidel iterates; the psum of 8
    shards' Gramians and correlations reassociates the sums (measured at
    most 6.4e-7, against the reference and against the port's own
    one-device fit);
  - ``tsqr_r``: 1e-5 absolute on R with unit-scale rows, both R's rows
    signed to a non-negative diagonal (a QR is unique up to those signs;
    measured 1.9e-6);
  - the streamed folds' stats: 1e-5 (measured 1.6e-7); the fits' weights
    and means: 1e-4, the block-streamed bound of
    tests/test_torch_block_streamed.py (the cosine polynomial is within
    4e-7 of XLA's ``cos``, and the normal equations at λ 1e-2 amplify
    it: measured 2.4e-5 on the gram tier's weights, 7.2e-6 on the
    block-streamed ones).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.ops.learning import block as jblock
from keystone_tpu.ops.learning import streaming_ls as jsls
from keystone_tpu.parallel import linalg as jlinalg
from keystone_tpu.parallel import mesh as jmesh
from keystone_tpu.parallel import streaming as jstream
from keystone_tpu.workflow import PipelineEnv as JPipelineEnv
from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.ops import cuda_ops
from keystone_tpu_torch.ops.learning import block as tblock
from keystone_tpu_torch.ops.learning import streaming_ls as tsls
from keystone_tpu_torch.parallel import linalg as tlinalg
from keystone_tpu_torch.parallel import mesh as tmesh
from keystone_tpu_torch.parallel import streaming as tstream
from keystone_tpu_torch.workflow import PipelineEnv as TPipelineEnv

D_IN, K, BS, LAM = 12, 3, 32, 1e-2
D_FEAT = 4 * BS
N_PAD, N_TRUE = 200, 195
BCD_TOL, R_TOL, G_TOL, W_TOL = 1e-5, 1e-5, 1e-5, 1e-4


@pytest.fixture(autouse=True)
def clean_envs():
    TPipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()
    yield
    TPipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()


@pytest.fixture()
def data_mesh():
    return jmesh.make_mesh()


@pytest.fixture()
def mesh8():
    return tmesh.make_mesh((8,), devices=["cpu"] * 8)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _np(x):
    if isinstance(x, tmesh.ShardedRows):
        x = x.gather()
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _rel(got, want):
    got, want = np.asarray(_np(got), np.float64), np.asarray(_np(want), np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _rows(n, seed=1, d_in=D_IN, k=K):
    """Rows and labels that depend on them (a smooth map plus noise)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d_in)).astype(np.float32)
    A = 0.3 * np.random.default_rng(99).normal(size=(d_in, k))
    Y = (np.cos(X @ A) + 0.5 + 0.05 * rng.normal(size=(n, k))).astype(np.float32)
    return X, Y


def _bank(seed=0, d_feat=D_FEAT, d_in=D_IN):
    rng = np.random.default_rng(seed)
    Wrf = (0.3 * rng.normal(size=(d_feat, d_in))).astype(np.float32)
    brf = rng.uniform(0, 2 * np.pi, size=d_feat).astype(np.float32)
    return Wrf, brf


def _padded(n_true=N_TRUE, n_pad=N_PAD, seed=1):
    X, Y = _rows(n_true, seed=seed)
    pad = n_pad - n_true
    return np.pad(X, ((0, pad), (0, 0))), np.pad(Y, ((0, pad), (0, 0)))


def _jcos(Wrf, brf):
    W, b = jnp.asarray(Wrf), jnp.asarray(brf)
    return lambda X: jnp.cos(X @ W.T + b)


def _counting(monkeypatch, *names):
    """Wrap cuda_ops wrappers to record the rows each call gets (its
    feature operand's; the plan verifier's calls on meta operands are not
    counted)."""
    calls = {name: [] for name in names}
    for name in names:
        real = getattr(cuda_ops, name)
        rows_arg = 1 if name == "gram_sym_acc" else 0  # gram_sym_acc(G, F)

        def wrapper(*args, _real=real, _name=name, _i=rows_arg, **kwargs):
            if not args[_i].is_meta:
                calls[_name].append(int(args[_i].shape[0]))
            return _real(*args, **kwargs)

        monkeypatch.setattr(cuda_ops, name, wrapper)
    return calls


class TestMeshBCD:
    def test_bcd_least_squares_on_the_mesh(self, mesh8, data_mesh, monkeypatch):
        rng = np.random.default_rng(0)
        A = rng.normal(size=(256, 24)).astype(np.float32)
        B = rng.normal(size=(256, 3)).astype(np.float32)
        blocks = [A[:, i:i + 8] for i in range(0, 24, 8)]
        calls = _counting(monkeypatch, "gram_corr_sym")
        Ws = tlinalg.bcd_least_squares([tmesh.shard_rows(b, mesh8) for b in blocks],
                                       tmesh.shard_rows(B, mesh8), lam=1e-2, num_iter=3,
                                       mesh=mesh8)
        jWs = jlinalg.bcd_least_squares([jmesh.shard_rows(b, data_mesh) for b in blocks],
                                        jmesh.shard_rows(B, data_mesh), lam=1e-2, num_iter=3,
                                        mesh=data_mesh, use_pallas=False)
        one = tlinalg.bcd_least_squares([_t(b) for b in blocks], _t(B), lam=1e-2, num_iter=3)
        for w, jw, w1 in zip(Ws, jWs, one):
            assert _rel(w, jw) <= BCD_TOL and _rel(w, w1) <= BCD_TOL
        # Epoch 1's Gramian and correlation: one launch a shard a block,
        # on the shard's 32 rows; later epochs reuse the stashed Gramian.
        assert calls["gram_corr_sym"] == [32] * 8 * 3

    def test_padding_rows_add_nothing(self, mesh8):
        A, B = _padded()
        Ws = tlinalg.bcd_least_squares([tmesh.shard_rows(A[:, :6], mesh8)],
                                       tmesh.shard_rows(B, mesh8), lam=0.1, num_iter=1,
                                       mesh=mesh8)
        want = tlinalg.bcd_least_squares([_t(A[:N_TRUE, :6])], _t(B[:N_TRUE]), lam=0.1)
        assert _rel(Ws[0], want[0]) <= BCD_TOL

    def test_tsqr_r_on_the_mesh(self, mesh8, data_mesh):
        A = np.random.default_rng(2).normal(size=(256, 10)).astype(np.float32)
        R = tlinalg.tsqr_r(tmesh.shard_rows(A, mesh8))
        jR = jlinalg.tsqr_r(jmesh.shard_rows(A, data_mesh), data_mesh)
        assert (np.diag(_np(R)) >= 0).all()
        np.testing.assert_allclose(_np(R), np.asarray(jR), atol=R_TOL)
        np.testing.assert_allclose(_np(R), _np(tlinalg.tsqr_r(_t(A))), atol=R_TOL)

    def test_block_estimator_on_sharded_rows(self, mesh8, data_mesh):
        rng = np.random.default_rng(6)
        X = rng.normal(size=(77, 32)).astype(np.float32)
        Y = rng.normal(size=(77, 3)).astype(np.float32)
        model = tblock.BlockLeastSquaresEstimator(16, 2, lam=1e-3).fit(
            TDataset.of(X).shard(mesh8), TDataset.of(Y).shard(mesh8))
        jmodel = jblock.BlockLeastSquaresEstimator(16, 2, lam=1e-3).fit(
            JDataset.of(X).shard(data_mesh), JDataset.of(Y).shard(data_mesh))
        assert _rel(torch.cat(model.xs), np.concatenate([np.asarray(x) for x in jmodel.xs])) \
            <= BCD_TOL
        assert _rel(model.b_opt, jmodel.b_opt) <= BCD_TOL
        pred = model.batch_apply(TDataset.of(X).shard(mesh8))
        assert pred.is_sharded and (_np(pred.array)[77:] == 0).all()
        jpred = jmodel.batch_apply(JDataset.of(X).shard(data_mesh)).to_numpy()
        assert _rel(pred.to_numpy(), jpred) <= BCD_TOL

    def test_float64_host_rows_shard_as_float32(self, mesh8, monkeypatch):
        # Host float64 rows become float32 sharded as unsharded, so the
        # mesh fit runs the kernels, at the one-device fit's precision.
        rng = np.random.default_rng(9)
        X, Y = rng.normal(size=(77, 32)), rng.normal(size=(77, 3))
        data, labels = TDataset.of(X).shard(mesh8), TDataset.of(Y).shard(mesh8)
        assert all(s.dtype == torch.float32 for s in data.array.shards + labels.array.shards)
        assert tmesh.replicate(X, mesh8)[0].dtype == torch.float32
        calls = _counting(monkeypatch, "gram_corr_sym")
        model = tblock.BlockLeastSquaresEstimator(16, 1, lam=1e-3).fit(data, labels)
        assert calls["gram_corr_sym"] == [10] * 8 * 2  # 80 padded rows, 2 blocks
        one = tblock.BlockLeastSquaresEstimator(16, 1, lam=1e-3).fit(
            TDataset.of(X), TDataset.of(Y))
        assert model.xs[0].dtype == one.xs[0].dtype == torch.float32
        assert _rel(torch.cat(model.xs), torch.cat(one.xs)) <= BCD_TOL

    def test_timit_shaped_pipeline_on_sharded_rows(self, mesh8, data_mesh, monkeypatch):
        # Two cosine branches -> combiner -> BlockLeastSquares, fitted on
        # sharded rows in both packages with the same weights (the port's
        # fit-first route falls back from the fused flat fit on a mesh, as
        # the reference's does): per-shard cosine applies, the mesh BCD.
        from keystone_tpu.ops.stats import CosineRandomFeaturesModel as JCos
        from keystone_tpu.ops.util import VectorCombiner as JComb
        from keystone_tpu.workflow import Pipeline as JPipeline
        from keystone_tpu_torch.ops.stats import CosineRandomFeaturesModel as TCos
        from keystone_tpu_torch.ops.util import VectorCombiner as TComb
        from keystone_tpu_torch.workflow import Pipeline as TPipeline

        X, Y = _rows(150, seed=3)
        banks = [_bank(seed=s, d_feat=BS) for s in (4, 5)]
        calls = _counting(monkeypatch, "cosine_features", "gram_corr_sym",
                          "block_gram_sym", "block_corr", "block_residual_update")
        tpipe = TPipeline.gather([TCos(_t(W), _t(b)).to_pipeline() for W, b in banks]) \
            .and_then(TComb()).and_then(tblock.BlockLeastSquaresEstimator(BS, 2, LAM),
                                        TDataset.of(X).shard(mesh8), TDataset.of(Y).shard(mesh8))
        jpipe = JPipeline.gather([JCos(jnp.asarray(W), jnp.asarray(b)).to_pipeline()
                                  for W, b in banks]) \
            .and_then(JComb()).and_then(jblock.BlockLeastSquaresEstimator(BS, 2, LAM),
                                        JDataset.of(X).shard(data_mesh),
                                        JDataset.of(Y).shard(data_mesh))
        fitted, jfitted = tpipe.fit(), jpipe.fit()
        assert calls["cosine_features"] == [19] * 16  # 2 branches x 8 shards of 19 rows
        assert calls["gram_corr_sym"] == [19] * 16  # 2 blocks x 8 shards, epoch 1
        assert not (calls["block_gram_sym"] or calls["block_corr"]
                    or calls["block_residual_update"])  # not the fused flat fit
        got = fitted.apply(TDataset.of(X).shard(mesh8)).to_numpy()
        want = np.asarray(jfitted.apply(JDataset.of(X).shard(data_mesh)).to_numpy())
        one = TPipeline.gather([TCos(_t(W), _t(b)).to_pipeline() for W, b in banks]) \
            .and_then(TComb()).and_then(tblock.BlockLeastSquaresEstimator(BS, 2, LAM),
                                        TDataset.of(X), TDataset.of(Y)).fit()
        assert _rel(got, want) <= BCD_TOL
        assert _rel(got, one.apply(TDataset.of(X)).to_numpy()) <= BCD_TOL


class TestStreamedMeshFolds:
    def test_gram_stats_mesh(self, mesh8, data_mesh, monkeypatch):
        Wrf, brf = _bank()
        X, Y = _padded()
        calls = _counting(monkeypatch, "gram_sym_acc")
        stats = tstream.gram_stats_mesh(tmesh.shard_rows(X, mesh8), tmesh.shard_rows(Y, mesh8),
                                        tsls.CosineBankFeaturize(_t(Wrf), _t(brf)), D_FEAT, 16,
                                        mesh8, n_true=N_TRUE, moments=True)
        jstats = jstream.gram_stats_mesh(jmesh.shard_rows(X, data_mesh),
                                         jmesh.shard_rows(Y, data_mesh), _jcos(Wrf, brf),
                                         D_FEAT, 16, data_mesh, n_true=N_TRUE, moments=True)
        for got, want in zip(stats, jstats):
            assert _rel(got, want) <= G_TOL
        # Each shard's 25 rows in tiles of 16; the last shard's 20 valid
        # rows: 16 + 4 (its padding dropped after featurizing).
        assert calls["gram_sym_acc"] == [16, 9] * 7 + [16, 4]

    @pytest.mark.parametrize("center", [False, True])
    def test_streaming_bcd_fit_mesh(self, mesh8, data_mesh, center):
        Wrf, brf = _bank()
        X, Y = _padded()
        kw = dict(d_feat=D_FEAT, tile_rows=16, block_size=BS, lam=LAM, num_iter=2,
                  n_true=N_TRUE)
        tfn = tstream.streaming_bcd_fit_mesh_centered if center else tstream.streaming_bcd_fit_mesh
        jfn = jstream.streaming_bcd_fit_mesh_centered if center else jstream.streaming_bcd_fit_mesh
        out = tfn(tmesh.shard_rows(X, mesh8), tmesh.shard_rows(Y, mesh8),
                  featurize=tsls.CosineBankFeaturize(_t(Wrf), _t(brf)), mesh=mesh8, **kw)
        jout = jfn(jmesh.shard_rows(X, data_mesh), jmesh.shard_rows(Y, data_mesh),
                   featurize=_jcos(Wrf, brf), mesh=data_mesh, use_pallas=False, **kw)
        outs = out if center else (out,)
        jouts = jout if center else (jout,)
        for got, want in zip(outs, jouts):
            assert _rel(got, want) <= W_TOL
        # The one-device streamed fit on the true rows, in the port.
        one = tstream.streaming_bcd_fit_centered if center else tstream.streaming_bcd_fit
        ref = one(_t(X[:N_TRUE]), _t(Y[:N_TRUE]),
                  featurize=tsls.CosineBankFeaturize(_t(Wrf), _t(brf)), d_feat=D_FEAT,
                  tile_rows=16, block_size=BS, lam=LAM, num_iter=2)
        assert _rel(outs[0], ref[0]) <= W_TOL

    def test_streaming_bcd_fit_takes_a_mesh(self, mesh8, data_mesh):
        # streaming_bcd_fit(mesh=): the mesh fold, its train loss from the
        # psum'd stats; labelize is refused there, as in the reference.
        Wrf, brf = _bank()
        X, Y = _padded()
        kw = dict(d_feat=D_FEAT, tile_rows=16, block_size=BS, lam=LAM, num_iter=2,
                  valid=N_TRUE)
        W, loss, yty = tstream.streaming_bcd_fit(
            tmesh.shard_rows(X, mesh8), tmesh.shard_rows(Y, mesh8),
            featurize=tsls.CosineBankFeaturize(_t(Wrf), _t(brf)), mesh=mesh8, **kw)
        jW, jloss, jyty = jstream.streaming_bcd_fit(
            jmesh.shard_rows(X, data_mesh), jmesh.shard_rows(Y, data_mesh),
            featurize=_jcos(Wrf, brf), mesh=data_mesh, **kw)
        assert _rel(W, jW) <= W_TOL
        assert float(loss) == pytest.approx(float(jloss), rel=W_TOL)
        assert float(yty) == pytest.approx(float(jyty), rel=G_TOL)
        with pytest.raises(ValueError, match="labelize"):
            tstream.streaming_bcd_fit(_t(X), _t(Y), featurize=lambda x: x, mesh=mesh8,
                                      labelize=lambda y: y, **kw)

    def test_streaming_estimator_on_sharded_rows(self, mesh8, data_mesh):
        Wrf, brf = _bank()
        X, Y = _rows(N_TRUE)
        est = tsls.StreamingFeaturizedLeastSquares(
            tsls.CosineBankFeaturize(_t(Wrf), _t(brf)), D_FEAT, BS, num_iter=2, lam=LAM,
            tile_rows=16)
        jest = jsls.StreamingFeaturizedLeastSquares(
            jsls.CosineBankFeaturize(jnp.asarray(Wrf), jnp.asarray(brf)), D_FEAT, BS,
            num_iter=2, lam=LAM, tile_rows=16)
        model = est.fit(TDataset.of(X).shard(mesh8), TDataset.of(Y).shard(mesh8))
        jmodel = jest.fit(JDataset.of(X).shard(data_mesh), JDataset.of(Y).shard(data_mesh))
        assert _rel(model.W_stack, jmodel.W_stack) <= W_TOL
        assert _rel(model.fmean, jmodel.fmean) <= W_TOL

    @pytest.mark.parametrize("center", [False, True])
    def test_block_streamed_mesh(self, mesh8, data_mesh, monkeypatch, center):
        Wrf, brf = _bank()
        X, Y = _padded()
        calls = _counting(monkeypatch, "cosine_features", "gram_corr_sym", "block_corr",
                          "block_residual_update")
        kw = dict(block_size=BS, lam=LAM, num_iter=2, n_true=N_TRUE, center=center)
        out = tstream.streaming_block_bcd_mesh(
            tmesh.shard_rows(X, mesh8), tmesh.shard_rows(Y, mesh8), _t(Wrf), _t(brf),
            mesh=mesh8, **kw)
        jout = jstream.streaming_block_bcd_mesh(
            jmesh.shard_rows(X, data_mesh), jmesh.shard_rows(Y, data_mesh), jnp.asarray(Wrf),
            jnp.asarray(brf), mesh=data_mesh, **kw)
        outs = out if center else (out,)
        jouts = jout if center else (jout,)
        for got, want in zip(outs, jouts):
            assert _rel(got, want) <= W_TOL
        nb = D_FEAT // BS
        rows = [25] * 7 + [20]  # each shard's valid rows
        assert calls["cosine_features"] == rows * (2 * nb)
        assert calls["gram_corr_sym"] == rows * nb  # epoch 1
        assert calls["block_corr"] == rows * nb  # epoch 2
        assert calls["block_residual_update"] == rows * (2 * nb)
        # Against the one-device program on the true rows.
        one = tstream.streaming_block_bcd_mesh(_t(X[:N_TRUE]), _t(Y[:N_TRUE]), _t(Wrf),
                                               _t(brf), block_size=BS, lam=LAM, num_iter=2,
                                               center=center)
        assert _rel(outs[0], one[0] if center else one) <= W_TOL

    def test_a_shard_past_n_true_folds_nothing(self, mesh8):
        Wrf, brf = _bank()
        X, Y = _padded(n_true=170)  # shards 7 and 8 hold padding only
        out = tstream.streaming_block_bcd_mesh(
            tmesh.shard_rows(X, mesh8), tmesh.shard_rows(Y, mesh8), _t(Wrf), _t(brf),
            block_size=BS, lam=LAM, num_iter=1, mesh=mesh8, n_true=170)
        one = tstream.streaming_block_bcd_mesh(_t(X[:170]), _t(Y[:170]), _t(Wrf), _t(brf),
                                               block_size=BS, lam=LAM, num_iter=1)
        assert _rel(out, one) <= W_TOL

    def test_block_streamed_estimator_on_sharded_rows(self, mesh8, data_mesh):
        Wrf, brf = _bank()
        X, Y = _rows(N_TRUE)
        model = tsls.BlockStreamedLeastSquares(
            tsls.CosineBankFeaturize(_t(Wrf), _t(brf)), D_FEAT, BS, num_iter=2, lam=LAM,
        ).fit(TDataset.of(X).shard(mesh8), TDataset.of(Y).shard(mesh8))
        jmodel = jsls.BlockStreamedLeastSquares(
            jsls.CosineBankFeaturize(jnp.asarray(Wrf), jnp.asarray(brf)), D_FEAT, BS,
            num_iter=2, lam=LAM,
        ).fit(JDataset.of(X).shard(data_mesh), JDataset.of(Y).shard(data_mesh))
        assert _rel(model.W_stack, jmodel.W_stack) <= W_TOL
        assert _rel(model.ymean, jmodel.ymean) <= W_TOL

    @pytest.mark.parametrize("center", [False, True])
    def test_block_streamed_2d_mesh(self, center):
        mesh42 = tmesh.make_mesh((4, 2), (tmesh.DATA_AXIS, tmesh.MODEL_AXIS),
                                 devices=["cpu"] * 8)
        jmesh42 = jmesh.make_mesh((4, 2), (jmesh.DATA_AXIS, jmesh.MODEL_AXIS))
        Wrf, brf = _bank()
        X, Y = _padded()
        kw = dict(block_size=BS, lam=LAM, num_iter=2, n_true=N_TRUE, center=center)
        rows = NamedSharding(jmesh42, PartitionSpec((jmesh.DATA_AXIS, jmesh.MODEL_AXIS)))
        out = tstream.streaming_block_bcd_mesh_2d(_t(X), _t(Y), _t(Wrf), _t(brf), mesh=mesh42,
                                                  **kw)
        jout = jstream.streaming_block_bcd_mesh_2d(
            jax.device_put(X, rows), jax.device_put(Y, rows), jnp.asarray(Wrf),
            jnp.asarray(brf), mesh=jmesh42, **kw)
        outs = out if center else (out,)
        jouts = jout if center else (jout,)
        for got, want in zip(outs, jouts):
            assert _np(got).shape == np.asarray(want).shape
            assert _rel(got, want) <= W_TOL
        with pytest.raises(ValueError, match="model axis"):
            tstream.streaming_block_bcd_mesh_2d(
                _t(X), _t(Y), _t(Wrf[:3 * BS]), _t(brf[:3 * BS]), mesh=mesh42,
                block_size=BS, lam=LAM, num_iter=1)
