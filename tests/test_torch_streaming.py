"""The port's streamed least-squares tier against the JAX package, on the
CPU: the ``gram_sym_acc`` kernel's plain version, the tile fold, the solve
on the normal equations, tile-wise prediction, the streaming estimators,
the streamed-fit fusion rule and TIMIT ``--solver streaming``.

Inputs come from seeded numpy generators and are float32 on both sides
(tests/conftest.py turns on x64, so arrays handed to JAX are cast to
float32 first); cosine banks drawn on one side are carried to the other.
The reference's fold is held in both of its Gramian forms: XLA's ``FᵀF``
(``use_pallas=False``, what its pipeline runs) and the Pallas
``gram_sym_acc`` in interpret mode (``use_pallas=True`` with
``KEYSTONE_PALLAS=1``). The kernel itself runs only on a CUDA card: its
``cuda`` tests are in tests/test_torch_strided_ops.py, which the card,
having no JAX, can import.

Tolerances and why:
  - ``gram_sym_acc``: 1e-5 of the sums' scale |G₀| + Σ|fᵢ||fⱼ| (the upper
    triangle only; the lower tiles are undefined by contract). Both sides
    sum float32 products in float32 in different orders; over 512 terms
    that differs by ~1e-7 of the scale.
  - fold statistics (G, FY, fsum, ysum, yty): 1e-5 relative to each
    statistic's own scale (Σ|·| of its terms), the same float32 argument.
  - solves, fits and predictions: 1e-4 relative Frobenius. The same
    Gauss-Seidel iterates on well-conditioned 128-wide blocks in float32;
    reordered sums move them by ~1e-6.
  - predicted labels >= 99.5% identical; TIMIT errors within 0.5 points.
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch import interop
from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.data.loaders import synthetic_timit as t_synthetic_timit
from keystone_tpu_torch.ops import cuda_ops
from keystone_tpu_torch.ops.learning import streaming_ls as tsls
from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator as TBlockLS
from keystone_tpu_torch.ops.stats import CosineRandomFeatures as TCosineRandomFeatures
from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels as TLabels
from keystone_tpu_torch.ops.util import MaxClassifier as TMaxClassifier
from keystone_tpu_torch.ops.util import VectorCombiner as TVectorCombiner
from keystone_tpu_torch.parallel import streaming as tstream
from keystone_tpu_torch.pipelines import timit as t_timit
from keystone_tpu_torch.workflow import DefaultOptimizer as TDefaultOptimizer
from keystone_tpu_torch.workflow import PipelineEnv as TPipelineEnv
from keystone_tpu_torch.workflow import fusion as tfusion

import jax.numpy as jnp

from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.data.loaders import synthetic_timit as j_synthetic_timit
from keystone_tpu.ops import pallas_ops
from keystone_tpu.ops.learning import streaming_ls as jsls
from keystone_tpu.ops.stats import CosineRandomFeatures as JCosineRandomFeatures
from keystone_tpu.ops.util import ClassLabelIndicatorsFromIntLabels as JLabels
from keystone_tpu.ops.util import MaxClassifier as JMaxClassifier
from keystone_tpu.parallel import streaming as jstream
from keystone_tpu.pipelines import timit as j_timit
from keystone_tpu.workflow import PipelineEnv as JPipelineEnv
from keystone_tpu.workflow.optimizer import DefaultOptimizer as JDefaultOptimizer

D_IN, D_FEAT, K = 16, 256, 5


@pytest.fixture(autouse=True)
def clean_envs():
    TPipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()
    yield
    TPipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x))).to(dtype)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _banks(seed=0, d_in=D_IN, d_feat=D_FEAT):
    """One cosine bank on both sides, same float32 Wrf, brf."""
    rng = np.random.default_rng(seed)
    Wrf = (0.3 * rng.normal(size=(d_feat, d_in))).astype(np.float32)
    brf = rng.uniform(0, 2 * np.pi, size=d_feat).astype(np.float32)
    return (jsls.CosineBankFeaturize(jnp.asarray(Wrf), jnp.asarray(brf)),
            tsls.CosineBankFeaturize(_t(Wrf), _t(brf)))


def _problem(n, seed=1, d_in=D_IN, k=K):
    """Rows whose labels depend on them: class = argmax of a fixed linear map."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d_in)).astype(np.float32)
    labels = np.argmax(X @ np.random.default_rng(99).normal(size=(d_in, k)), axis=1)
    Y = (2.0 * np.eye(k, dtype=np.float32)[labels] - 1.0).astype(np.float32)
    return X, Y, labels


# ---------------------------------------------------------------------------
# The kernel's plain version
# ---------------------------------------------------------------------------


class TestGramSymAcc:
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_ref_against_pallas_interpret(self, dtype):
        rng = np.random.default_rng(0)
        F = rng.normal(size=(512, 1024)).astype(np.float32)
        G0 = rng.normal(size=(1024, 1024)).astype(np.float32)
        if dtype == "bf16":
            Ft, Fj = _t(F).to(torch.bfloat16), jnp.asarray(F, dtype=jnp.bfloat16)
        else:
            Ft, Fj = _t(F), jnp.asarray(F)
        assert pallas_ops.gram_acc_ok(Fj)
        want = np.asarray(pallas_ops.gram_sym_acc(jnp.asarray(G0), Fj, interpret=True))
        got = cuda_ops.gram_sym_acc_ref(_t(G0), Ft)
        assert got.shape == (1024, 1024) and got.dtype == torch.float32
        Fd = Ft.double()
        scale = np.abs(G0) + (Fd.abs().T @ Fd.abs()).numpy()
        err = np.triu(np.abs(got.numpy().astype(np.float64) - want) / scale)
        assert err.max() <= 1e-5

    def test_wrapper_takes_the_plain_version_on_cpu(self):
        rng = np.random.default_rng(1)
        F, G = _t(rng.normal(size=(37, 300))), _t(rng.normal(size=(300, 300)))
        before = dict(cuda_ops.launches)
        want = G + F.T @ F
        fresh = cuda_ops.gram_sym_acc(G, F)
        torch.testing.assert_close(fresh, want)
        out = G.clone()
        assert cuda_ops.gram_sym_acc(out, F, out=out) is out  # in place
        torch.testing.assert_close(out, want)
        assert cuda_ops.launches == before

    def test_gram_acc_ok(self):
        F = torch.zeros((37, 300))
        assert cuda_ops.gram_acc_ok(F)  # ragged rows and width: masked in the kernel
        assert cuda_ops.gram_acc_ok(F.to(torch.bfloat16))
        assert cuda_ops.gram_acc_ok(F[:5])
        assert not cuda_ops.gram_acc_ok(F.double())
        assert not cuda_ops.gram_acc_ok(F.T.contiguous().T)
        assert not cuda_ops.gram_acc_ok(torch.zeros(300))

    def test_non_cpu_non_cuda_tensors_raise(self):
        G = torch.empty((8, 8), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            cuda_ops.gram_sym_acc(G, torch.empty((4, 8), device="meta"))


# ---------------------------------------------------------------------------
# The fold
# ---------------------------------------------------------------------------


def _stats_close(got, want, terms):
    """Each statistic within 1e-5 of the scale of its summed terms."""
    for g, w, s in zip(got, want, terms):
        g = np.asarray(g, np.float64)
        w = np.asarray(w, np.float64)
        assert np.max(np.abs(g - w) / s) <= 1e-5


def _terms(F, Y):
    """Per-entry scales Σ|·| of (G, FY, yty, fsum, ysum) over rows F, Y."""
    F, Y = np.abs(np.asarray(F, np.float64)), np.abs(np.asarray(Y, np.float64))
    return (F.T @ F + 1e-30, F.T @ Y + 1e-30, (Y * Y).sum(), F.sum(0) + 1e-30, Y.sum(0))


class TestGramStats:
    @pytest.fixture(scope="class")
    def banks(self):
        return _banks()

    def test_ragged_rows_with_moments(self, banks):
        j_bank, t_bank = banks
        X, Y, _ = _problem(1300)
        want = jstream.gram_stats(jnp.asarray(X), jnp.asarray(Y), j_bank, D_FEAT, 512,
                                  moments=True)
        got = tstream.gram_stats(_t(X), _t(Y), t_bank, D_FEAT, 512, moments=True)
        assert got[0].shape == (D_FEAT, D_FEAT) and torch.equal(got[0], got[0].T)
        _stats_close(got, want, _terms(t_bank(_t(X)), Y))

    def test_static_valid_drops_garbage_padding_rows(self, banks):
        j_bank, t_bank = banks
        X, Y, _ = _problem(1300, seed=2)
        X[1000:], Y[1000:] = 50.0, 7.0  # garbage past the 1000 valid rows
        want = jstream.gram_stats(jnp.asarray(X), jnp.asarray(Y), j_bank, D_FEAT, 512,
                                  valid=1000, moments=True)
        got = tstream.gram_stats(_t(X), _t(Y), t_bank, D_FEAT, 512, valid=1000, moments=True)
        terms = _terms(t_bank(_t(X[:1000])), Y[:1000])
        _stats_close(got, want, terms)
        # The same as folding only the valid rows ...
        alone = tstream.gram_stats(_t(X[:1000]), _t(Y[:1000]), t_bank, D_FEAT, 512,
                                   moments=True)
        _stats_close(got, alone, terms)
        # ... and not what zero input rows give: cos(b) rows are not zero.
        X[1000:], Y[1000:] = 0.0, 0.0
        zeros = tstream.gram_stats(_t(X), _t(Y), t_bank, D_FEAT, 512, moments=True)
        assert not torch.allclose(zeros[3], got[3])

    def test_pre_tiled_x(self, banks):
        j_bank, t_bank = banks
        X, Y, _ = _problem(1024, seed=3)
        Xt, Yt = X.reshape(2, 512, D_IN), Y.reshape(2, 512, K)
        want = jstream.gram_stats(jnp.asarray(Xt), jnp.asarray(Yt), j_bank, D_FEAT, 512)
        got = tstream.gram_stats(_t(Xt), _t(Yt), t_bank, D_FEAT, 512)
        flat = tstream.gram_stats(_t(X), _t(Y), t_bank, D_FEAT, 512)
        terms = _terms(t_bank(_t(X)), Y)
        _stats_close(got, want, terms)
        _stats_close(got, flat, terms)

    def test_labelize(self, banks):
        j_bank, t_bank = banks
        X, Y, labels = _problem(1300, seed=4)
        want = jstream.gram_stats(
            jnp.asarray(X), jnp.asarray(labels, jnp.int32), j_bank, D_FEAT, 512,
            labelize=lambda y: 2.0 * jnp.eye(K, dtype=jnp.float32)[y] - 1.0, moments=True,
        )
        got = tstream.gram_stats(
            _t(X), _t(labels, torch.int64), t_bank, D_FEAT, 512,
            labelize=lambda y: 2.0 * torch.eye(K)[y] - 1.0, moments=True,
        )
        assert got[1].shape == (D_FEAT, K)
        _stats_close(got, want, _terms(t_bank(_t(X)), Y))

    def test_fold_takes_gram_sym_acc(self, banks, monkeypatch):
        calls = []
        orig = cuda_ops.gram_sym_acc

        def counted(G, F, out=None):
            calls.append((F.shape[0], out is G))
            return orig(G, F, out=out)

        monkeypatch.setattr(cuda_ops, "gram_sym_acc", counted)
        X, Y, _ = _problem(1300, seed=5)
        tstream.gram_stats(_t(X), _t(Y), banks[1], D_FEAT, 512, valid=1200)
        # Two full tiles and the ragged one, unpadded and masked, in place.
        assert calls == [(512, True), (512, True), (176, True)]


# ---------------------------------------------------------------------------
# Solve and predict
# ---------------------------------------------------------------------------


class TestSolve:
    def test_bcd_from_gram(self):
        rng = np.random.default_rng(6)
        F = rng.normal(size=(900, 256)).astype(np.float32)
        Y = rng.normal(size=(900, K)).astype(np.float32)
        G, FY = F.T @ F, F.T @ Y
        want = np.asarray(jstream.bcd_from_gram(jnp.asarray(G), jnp.asarray(FY), 128, 0.1, 3))
        got = tstream.bcd_from_gram(_t(G), _t(FY), 128, 0.1, 3)
        assert got.shape == (2, 128, K)
        assert _rel(got.numpy(), want) <= 1e-4

    def test_bcd_from_gram_rejects_bad_blocks(self):
        with pytest.raises(ValueError, match="divisible"):
            tstream.bcd_from_gram(torch.eye(10), torch.zeros((10, 2)), 4, 0.0, 1)
        with pytest.raises(ValueError, match="num_iter"):
            tstream.bcd_from_gram(torch.eye(8), torch.zeros((8, 2)), 4, 0.0, 0)

    @pytest.mark.parametrize("use_pallas", [False, True])
    @pytest.mark.parametrize("center", [False, True])
    def test_streamed_fit_against_both_reference_forms(self, use_pallas, center, monkeypatch):
        j_bank, t_bank = _banks(seed=7)
        X, Y, _ = _problem(1300, seed=8)
        kw = dict(d_feat=D_FEAT, tile_rows=512, block_size=128, lam=1e-3, num_iter=2,
                  valid=1250)
        if use_pallas:
            monkeypatch.setenv("KEYSTONE_PALLAS", "1")  # interpret-mode gram_sym_acc
        if center:
            want = jstream.streaming_bcd_fit_centered(
                jnp.asarray(X), jnp.asarray(Y), featurize=j_bank, use_pallas=use_pallas, **kw)
            got = tstream.streaming_bcd_fit_centered(_t(X), _t(Y), featurize=t_bank, **kw)
            (gW, gf, gy, gl), (wW, wf, wy, wl) = got, want
            assert _rel(gf.numpy(), wf) <= 1e-4 and _rel(gy.numpy(), wy) <= 1e-4
        else:
            want = jstream.streaming_bcd_fit(
                jnp.asarray(X), jnp.asarray(Y), featurize=j_bank, use_pallas=use_pallas, **kw)
            got = tstream.streaming_bcd_fit(_t(X), _t(Y), featurize=t_bank, **kw)
            (gW, gl, gyty), (wW, wl, wyty) = got, want
            assert _rel(gyty.numpy(), wyty) <= 1e-5
        assert gW.shape == (2, 128, K)
        assert _rel(gW.numpy(), wW) <= 1e-4
        assert _rel(gl.numpy(), wl) <= 1e-4

    def test_streaming_predict(self):
        j_bank, t_bank = _banks(seed=9)
        X, _, _ = _problem(1300, seed=10)
        W = np.random.default_rng(11).normal(size=(2, 128, K)).astype(np.float32)
        want = np.asarray(jstream.streaming_predict(jnp.asarray(X), jnp.asarray(W), j_bank, 512))
        got = tstream.streaming_predict(_t(X), _t(W), t_bank, 512)
        assert got.shape == (1300, K) and got.dtype == torch.float32
        assert _rel(got.numpy(), want) <= 1e-5
        tiled = tstream.streaming_predict(_t(X[:1024]).reshape(2, 512, D_IN), _t(W), t_bank, 512)
        torch.testing.assert_close(tiled, got[:1024])

    def test_predict_holds_one_slab_at_a_time(self):
        # Each tile's features are freed before the next tile is featurized
        # (two live slabs would double the apply's peak device memory).
        import weakref

        _, t_bank = _banks(seed=9)
        last = []

        def featurize(X_t):
            assert not last or last[-1]() is None, "previous slab still alive"
            F_t = t_bank(X_t)
            last.append(weakref.ref(F_t))
            return F_t

        X, _, _ = _problem(1300, seed=10)
        W = _t(np.random.default_rng(11).normal(size=(2, 128, K)))
        got = tstream.streaming_predict(_t(X), W, featurize, 512)
        assert len(last) == 3
        torch.testing.assert_close(got, tstream.streaming_predict(_t(X), W, t_bank, 512))

    def test_pick_tile_rows_and_block_size(self):
        for d in (16384, 4096, 300, 10 ** 7):
            assert tstream.pick_tile_rows(d, 4) == jstream.pick_tile_rows(d, 4)
        assert tstream.pick_tile_rows(16384, 4) == 32768
        for d, hint in ((16384, 4096), (1000, 300), (97, 10)):
            assert tsls.pick_block_size(d, hint) == jsls.pick_block_size(d, hint)


# ---------------------------------------------------------------------------
# Estimators
# ---------------------------------------------------------------------------


class TestEstimators:
    def test_streaming_featurized_least_squares_end_to_end(self):
        j_bank, t_bank = _banks(seed=12)
        X, Y, _ = _problem(1300, seed=13)
        Xte, _, _ = _problem(400, seed=14)
        kw = dict(d_feat=D_FEAT, block_size=128, num_iter=2, lam=1e-3, tile_rows=512)
        j_model = jsls.StreamingFeaturizedLeastSquares(j_bank, **kw).fit(
            JDataset.of(X), JDataset.of(Y))
        t_model = tsls.StreamingFeaturizedLeastSquares(t_bank, **kw).fit(
            TDataset.of(_t(X)), TDataset.of(_t(Y)))
        assert isinstance(t_model, tsls.StreamingFeaturizedLinearModel)
        want = np.asarray(j_model.batch_apply(JDataset.of(Xte)).array)
        got = t_model.batch_apply(TDataset.of(_t(Xte))).to_numpy()
        assert _rel(got, want) <= 1e-4
        assert np.mean(got.argmax(1) == want.argmax(1)) >= 0.995
        np.testing.assert_allclose(t_model.apply(_t(Xte[0])).numpy(), got[0], rtol=1e-4,
                                   atol=1e-5)
        # The reference's fitted model, carried into the port, predicts alike.
        carried = interop.params_from_jax({
            "W_stack": np.asarray(j_model.W_stack), "fmean": np.asarray(j_model.fmean),
            "ymean": np.asarray(j_model.ymean), "Wrf": np.asarray(j_bank.Wrf),
            "brf": np.asarray(j_bank.brf), "tile_rows": 512,
        }, device="cpu")
        assert _rel(carried.batch_apply(TDataset.of(_t(Xte))).to_numpy(), want) <= 1e-5

    def test_padded_dataset_masks_feature_rows(self):
        _, t_bank = _banks(seed=15)
        X, Y, _ = _problem(1000, seed=16)
        Xp = np.concatenate([X, np.zeros((24, D_IN), np.float32)])
        Yp = np.concatenate([Y, np.zeros((24, K), np.float32)])
        est = tsls.StreamingFeaturizedLeastSquares(t_bank, D_FEAT, 128, num_iter=2, lam=1e-3,
                                                   tile_rows=512)
        padded = est.fit(TDataset(_t(Xp), n=1000), TDataset(_t(Yp), n=1000))
        plain = est.fit(TDataset.of(_t(X)), TDataset.of(_t(Y)))
        torch.testing.assert_close(padded.W_stack, plain.W_stack)
        torch.testing.assert_close(padded.fmean, plain.fmean)
        out = padded.batch_apply(TDataset(_t(Xp), n=1000)).array
        assert torch.equal(out[1000:], torch.zeros((24, K)))

    def test_choice_direct_fit_matches_block_semantics(self):
        # The choice fit directly on featurized data (no fusable upstream):
        # the same centered model as BlockLeastSquaresEstimator.
        rng = np.random.default_rng(3)
        F = _t(rng.normal(size=(400, 128)).astype(np.float32) + 0.5)
        Y = _t(rng.normal(size=(400, 3)).astype(np.float32))
        choice = tsls.StreamingLeastSquaresChoice(num_iter=2, lam=1e-2, block_size_hint=32)
        m_stream = choice.fit(TDataset.of(F), TDataset.of(Y))
        m_block = TBlockLS(32, 2, lam=1e-2).fit(TDataset.of(F), TDataset.of(Y))
        p_s = m_stream.batch_apply(TDataset.of(F)).to_numpy()
        p_b = m_block.batch_apply(TDataset.of(F)).to_numpy()
        np.testing.assert_allclose(p_s, p_b, atol=5e-3, rtol=5e-3)

    def test_gather_tree_extracts_bank(self):
        rfs = [TCosineRandomFeatures(16, 64, 0.2, seed=i, device="cpu") for i in range(3)]
        fused = tfusion.FusedGatherTransformer([[rf] for rf in rfs], TVectorCombiner())
        bank = tsls._extract_bank([fused])
        assert isinstance(bank, tsls.CosineBankFeaturize)
        assert bank.Wrf.shape == (192, 16)
        X = _t(np.random.default_rng(1).normal(size=(8, 16)))
        expected = torch.cat([rf.apply(X) for rf in rfs], dim=1)
        torch.testing.assert_close(bank(X), expected, rtol=0, atol=1e-5)
        assert isinstance(tsls._extract_bank([rfs[0]]), tsls.CosineBankFeaturize)
        assert tsls._extract_bank(rfs) is None  # a chain, not one featurizer

    @pytest.mark.parametrize("d,hint", [(4096, 4096), (16384, 4096), (1000, 300),
                                        (65536, 2048)])
    def test_build_estimator_matches_reference(self, d, hint):
        # The gram tier the reference builds when no device budget is set.
        t = tsls.StreamingLeastSquaresChoice(2, 1e-3, hint, center=False)
        j = jsls.StreamingLeastSquaresChoice(2, 1e-3, hint, center=False)
        got = t.build_estimator(tsls._identity_featurize, d)
        want = j.build_estimator(jsls._identity_featurize, d)
        assert isinstance(got, tsls.StreamingFeaturizedLeastSquares)
        for attr in ("d_feat", "block_size", "num_iter", "lam", "tile_rows", "center"):
            assert getattr(got, attr) == getattr(want, attr), attr
        assert t.label == j.label == "StreamingLeastSquaresChoice(2,0.001)"

    def test_cosine_bank_matches_reference(self):
        j_bank, t_bank = _banks(seed=2)
        X, _, _ = _problem(300, seed=2)
        got = t_bank(_t(X))
        assert got.shape == (300, D_FEAT) and got.dtype == torch.float32
        assert _rel(got.numpy(), np.asarray(j_bank(jnp.asarray(X)))) <= 1e-5

    def test_estimator_fusion_binds_an_upstream_transformer(self):
        # A fusable transformer feeding the estimator: the fit-fusion
        # contract (device_fit_fn) fits on the transformer's output, with
        # the bank featurizing inside, as the unfused fit does.
        X, Y, _ = _problem(700, seed=17, d_in=440)
        rf = TCosineRandomFeatures(440, D_IN, 0.05, seed=3, device="cpu")
        _, bank = _banks(seed=18)
        est = tsls.StreamingFeaturizedLeastSquares(bank, D_FEAT, 128, num_iter=2, lam=1e-3,
                                                   tile_rows=256)
        pipe = rf.and_then(est, TDataset.of(_t(X)), TDataset.of(_t(Y)))
        labels = [op.label for op in TDefaultOptimizer().execute(
            pipe.executor.graph, {})[0].operators.values()]
        assert ("FusedFit[CosineRandomFeaturesModel -> StreamingFeaturizedLeastSquares]"
                in labels)
        fused = pipe.fit().apply(TDataset.of(_t(X))).to_numpy()
        model = est.fit(rf.batch_apply(TDataset.of(_t(X))), TDataset.of(_t(Y)))
        want = model.batch_apply(rf.batch_apply(TDataset.of(_t(X)))).to_numpy()
        assert _rel(fused, want) <= 1e-5

    def test_unported_tiers_name_their_roadmap_item(self, tmp_path):
        # Every tier is ported now: the disk tier (tests/test_torch_outofcore.py),
        # the one-host mesh forms (tests/test_torch_mesh_solvers.py) and the
        # multi-process mesh (tests/test_torch_multihost.py). A mesh whose
        # DCN axes span processes needs a process group, and a join whose
        # peer never comes fails within its stated timeout; it connects to
        # nothing (a file store in tmp_path).
        import time

        from keystone_tpu_torch.parallel import mesh as mesh_lib

        with pytest.raises(ValueError, match="no process group is initialized"):
            mesh_lib.make_hybrid_mesh((4, 1), (2, 1), ("data", "model"))
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError):
            mesh_lib.init_distributed(f"file://{tmp_path}/store", num_processes=2,
                                      process_id=0, backend="gloo", timeout_s=1)
        assert time.perf_counter() - t0 < 30
        assert not torch.distributed.is_initialized()
        with pytest.raises(TypeError, match="cannot stream a dense fit"):
            tsls._source_d_in(object())

    def test_streamed_fit_estimator_equals_the_bank_fit(self):
        train = t_synthetic_timit(700, seed=4, device="cpu")
        labels = TLabels(147)(train.labels)
        rfs = [TCosineRandomFeatures(440, 128, 0.05555, seed=i, device="cpu") for i in (1, 2)]
        gather = tfusion.FusedGatherTransformer([[rf] for rf in rfs], TVectorCombiner())
        choice = tsls.StreamingLeastSquaresChoice(num_iter=2, lam=1e-3, block_size_hint=128)
        fused = choice.fuse_with_members([gather])
        assert fused.can_serve_raw_input
        assert fused.label == ("StreamedFit[" + gather.label + " -> "
                               "StreamingLeastSquaresChoice(2,0.001)]")
        model = fused.fit(train.data, labels)
        assert model.d_in == 440
        bank = tsls.CosineBankFeaturize(torch.cat([rf.W for rf in rfs]),
                                        torch.cat([rf.b for rf in rfs]))
        want = choice.build_estimator(bank, 256).fit(train.data, labels)
        torch.testing.assert_close(model.W_stack, want.W_stack)
        # Width-adaptive: raw rows featurize, featurized rows do not.
        raw = model.batch_apply(train.data).array
        feats = model.batch_apply(TDataset.of(gather.device_fn()(train.data.array))).array
        torch.testing.assert_close(raw, feats, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# Plan parity: the port's optimizer makes the reference's rewrite
# ---------------------------------------------------------------------------


def _plan(optimizer, graph):
    plan, _ = optimizer.execute(graph, {})
    return {
        node.id: (
            plan.get_operator(node).label,
            tuple((type(d).__name__, d.id) for d in plan.get_dependencies(node)),
        )
        for node in plan.nodes
    }


def _compositions(package):
    """The three plans, built the same way with either package's API."""
    if package == "jax":
        synth, labels_of, Choice, Max = (
            j_synthetic_timit, JLabels, jsls.StreamingLeastSquaresChoice, JMaxClassifier)
        rf = JCosineRandomFeatures(440, 128, 0.05, seed=1)
        featurizer = j_timit.build_featurizer(j_timit.TimitConfig(num_cosines=3, block_size=64))
        train = synth(128, seed=2)
    else:
        synth, labels_of, Choice, Max = (
            t_synthetic_timit, TLabels, tsls.StreamingLeastSquaresChoice, TMaxClassifier)
        rf = TCosineRandomFeatures(440, 128, 0.05, seed=1, device="cpu")
        featurizer = t_timit.build_featurizer(
            t_timit.TimitConfig(num_cosines=3, block_size=64), device="cpu")
        train = synth(128, seed=2, device="cpu")
    labels = labels_of(147)(train.labels)
    one = rf.and_then(Choice(3, 0.0, 64), train.data, labels).and_then(Max())
    tim = featurizer.and_then(Choice(3, 0.0, 64), train.data, labels).and_then(Max())
    return {
        "cosine -> choice under fit()": one.executor.graph,
        "TIMIT gather -> choice under fit()": tim.executor.graph,
        "TIMIT gather -> choice under apply-first": tim.apply(train.data).executor.graph,
    }


class TestPlanParity:
    @pytest.fixture(scope="class")
    def plans(self):
        TPipelineEnv.get_or_create().reset()
        JPipelineEnv.get_or_create().reset()
        j = {k: _plan(JDefaultOptimizer(), g) for k, g in _compositions("jax").items()}
        t = {k: _plan(TDefaultOptimizer(), g) for k, g in _compositions("torch").items()}
        return j, t

    @pytest.mark.parametrize("which", ["cosine -> choice under fit()",
                                       "TIMIT gather -> choice under fit()",
                                       "TIMIT gather -> choice under apply-first"])
    def test_same_rewrite_node_for_node(self, plans, which):
        j, t = plans
        assert t[which] == j[which]
        labels = [label for label, _ in t[which].values()]
        assert sum(label.startswith("StreamedFit[") for label in labels) == 1
        # The featurizer is bound into the fit: no featurize node is left.
        assert not any(label.startswith(("CosineRandomFeaturesModel", "FusedGather"))
                       for label in labels)


# ---------------------------------------------------------------------------
# TIMIT --solver streaming
# ---------------------------------------------------------------------------

SLICE = dict(num_cosines=2, block_size=256, synthetic_n=2048, num_epochs=2)


@pytest.fixture(scope="module")
def timit_runs():
    """TIMIT --solver streaming on both packages with the same cosine draws."""
    JPipelineEnv.get_or_create().reset()
    j_cfg = j_timit.TimitConfig(solver="streaming", **SLICE)
    pipe, j_train, j_test = j_timit.run(j_cfg)
    (j_model,) = [o for o in pipe.fit().transformer_graph.operators.values()
                  if isinstance(o, jsls.StreamingFeaturizedLinearModel)]
    models = [
        interop.params_from_jax({"W": np.asarray(rf.W), "b": np.asarray(rf.b)}, device="cpu")
        for rf in (JCosineRandomFeatures(440, j_cfg.block_size, j_cfg.gamma, seed=j_cfg.seed + i)
                   for i in range(j_cfg.num_cosines))
    ]
    JPipelineEnv.get_or_create().reset()
    TPipelineEnv.get_or_create().reset()
    result = t_timit.run(t_timit.TimitConfig(solver="streaming", **SLICE), device="cpu",
                         cosine_models=models)
    (t_model,) = [o for o in result.fitted.transformer_graph.operators.values()
                  if isinstance(o, tsls.StreamingFeaturizedLinearModel)]
    TPipelineEnv.get_or_create().reset()
    return dict(j_W=np.asarray(j_model.W_stack), t_W=t_model.W_stack.numpy(),
                j_err=(j_train.total_error, j_test.total_error),
                t_err=(result.train_eval.total_error, result.test_eval.total_error))


class TestTimitStreaming:
    def test_weights(self, timit_runs):
        r = timit_runs
        assert r["t_W"].shape == r["j_W"].shape == (2, 256, 147)
        assert _rel(r["t_W"], r["j_W"]) <= 1e-4

    def test_train_and_test_error(self, timit_runs):
        for t_err, j_err in zip(timit_runs["t_err"], timit_runs["j_err"]):
            assert abs(t_err - j_err) <= 0.005

    def test_both_call_orders_fit_the_same_model(self):
        config = t_timit.TimitConfig(solver="streaming", num_cosines=1, block_size=64,
                                     synthetic_n=300, num_epochs=1)
        first = t_timit.run(config, device="cpu")
        TPipelineEnv.get_or_create().reset()
        second = t_timit.run(config, device="cpu", fit_first=False)
        assert first.train_eval.total_error == second.train_eval.total_error
        assert first.test_eval.total_error == second.test_eval.total_error

    def test_cli_streaming_on_the_cpu(self, capsys):
        from keystone_tpu_torch import run

        assert run.main(["TimitPipeline", "--solver", "streaming", "--numCosines", "1",
                         "--blockSize", "64", "--syntheticN", "256", "--numEpochs", "1",
                         "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "TRAIN Error is" in out and "TEST Error is" in out

    def test_auto_still_raises(self, monkeypatch):
        # --solver auto, once unported, is now held against the reference
        # past a forced device budget (56 MiB: only the streaming tier's
        # operands fit), where StreamedFitFusionRule binds the cosine bank
        # into the fit on both sides: weights within 1e-4.
        from tests.test_torch_cost import run_auto_both, weights_of

        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", "ec2")
        monkeypatch.delenv("KEYSTONE_HOST_BUDGET_BYTES", raising=False)
        run = run_auto_both(monkeypatch, 56 << 20, config=dict(
            num_cosines=2, block_size=512, synthetic_n=8192, num_epochs=2, lam=1e-3))
        route, t_W, j_W = weights_of(run)
        assert route == "streaming", run["decision"]
        assert t_W.shape == j_W.shape == (1, 1024, 147)
        assert _rel(t_W, j_W) <= 1e-4
        assert np.mean(run["t_pred"] == run["j_pred"]) >= 0.995
