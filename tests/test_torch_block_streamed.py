"""The port's block-streamed tier against the JAX package, on the CPU:
``streaming_block_bcd_mesh`` on one device (the reference's on a 1-device
mesh, where every ``psum`` is the identity), ``BlockStreamedLeastSquares``,
the streaming choice's tier decision, a TIMIT-shaped composition through
the cost-model selector past the gram tier's wall, the bf16 cosine bank
(``CosineBankFeaturize(feat_dtype=)``, ``cosine_bank_featurize``) and
``interop.streaming_linear_model`` over a bf16 bank.

Inputs come from seeded numpy generators and are float32 on both sides
(tests/conftest.py turns on x64, so arrays handed to JAX are cast to
float32 first); labels depend on the rows. On the CPU the port's wrappers
compute their kernels' plain versions; the kernels run on the card
(``chip_smoke.py`` phase 12, and the ``cuda`` test in
tests/test_torch_strided_ops.py).

Tolerances and why:
  - float32 block program and estimator: weights 1e-4 relative Frobenius,
    means 1e-5. The same Gauss-Seidel iterates on the same float32
    features up to the cosine (the port's is the reference kernel's
    polynomial, within 4e-7 of XLA's ``cos``) and reordered sums: measured
    at most 4e-6 on the weights.
  - bfloat16 block program: weights 5e-3, feature means 2e-5. Both round
    float32 features to bf16; features that agree to 4e-7 round to
    different bf16 values in ~0.02% of the entries (one bf16 step, up to
    2^-8). The program itself is that sensitive: in a float64 re-run of
    the reference's steps, moving X by 1e-7 relative moves its bf16
    weights by 1.2e-3 to 1.4e-3 (at λ 1e-2 and 10 alike), and the two
    packages differ by 1.5e-3 to 3.1e-3 over five seeds.
  - so the weights cannot tell a program that ignores feat_dtype: the
    port run with float32 slabs comes within 3.5e-3 to 4.0e-3 of the
    reference's bf16 weights (ragged rows, λ 1e-2; at λ 1 to 100 and
    three seeds the gap is still only 1.9x to 2.5x the bf16 pair's). Its
    centred feature means do fail (1.1e-4 against 2e-5), but the raw
    program returns W alone. So each slab the program makes is held
    against the reference's: float32 slabs within 1e-6 (measured 4.2e-7,
    fast_cos against cos), bf16 slabs of dtype bf16 with at most one bf16
    step (2^-7) in at most 0.1% of the entries (measured 0.018% to
    0.021%). The controls fail it: float32 slabs have the wrong dtype and
    differ in 99.97% of the entries; bf16 operands (the bank's Pallas
    form, not the program's) differ in 43% of them, by up to 1.6e-2.
  - bf16 bank features: one bf16 step at |x| < 1 (2^-7 absolute, the
    bound tests/test_torch_cuda_ops.py holds the bf16 output to), against
    the reference's Pallas form in interpret mode (``KEYSTONE_PALLAS=1``),
    which rounds the operands to bf16 as the port's kernel does.
  - predictions of a bf16 bank's model: 1e-2 of the predictions' scale,
    the bf16 output rounding (2^-9 relative) and one-step feature flips.
  - the TIMIT-shaped composition: the same winner and tier, weights 1e-4,
    predictions 1e-4 relative.
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch import interop
from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.ops import cuda_ops
from keystone_tpu_torch.ops.learning import block as tblock
from keystone_tpu_torch.ops.learning import cost as tcost
from keystone_tpu_torch.ops.learning import streaming_ls as tsls
from keystone_tpu_torch.ops.stats import CosineRandomFeaturesModel as TCosineModel
from keystone_tpu_torch.ops.util import VectorCombiner as TVectorCombiner
from keystone_tpu_torch.parallel import streaming as tstream
from keystone_tpu_torch.workflow import Pipeline as TPipeline
from keystone_tpu_torch.workflow import PipelineEnv as TPipelineEnv

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.ops.learning import cost as jcost
from keystone_tpu.ops.learning import streaming_ls as jsls
from keystone_tpu.ops.stats import CosineRandomFeaturesModel as JCosineModel
from keystone_tpu.ops.util import VectorCombiner as JVectorCombiner
from keystone_tpu.parallel import mesh as mesh_lib
from keystone_tpu.parallel import streaming as jstream
from keystone_tpu.workflow import Pipeline as JPipeline
from keystone_tpu.workflow import PipelineEnv as JPipelineEnv

D_IN, K, BS, LAM = 16, 5, 64, 1e-2
D_FEAT = 4 * BS
N_PAD, N_TRUE = 520, 509
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
W_TOL = {"f32": 1e-4, "bf16": 5e-3}
FMEAN_TOL = {"f32": 1e-5, "bf16": 2e-5}
SLAB_F32_TOL = 1e-6


@pytest.fixture(autouse=True)
def clean_envs():
    TPipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()
    yield
    TPipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _bank(seed=0, d_feat=D_FEAT, d_in=D_IN):
    rng = np.random.default_rng(seed)
    Wrf = (0.3 * rng.normal(size=(d_feat, d_in))).astype(np.float32)
    brf = rng.uniform(0, 2 * np.pi, size=d_feat).astype(np.float32)
    return Wrf, brf


def _rows(n, seed=1, d_in=D_IN, k=K):
    """Rows and labels that depend on them (a smooth map plus noise)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d_in)).astype(np.float32)
    A = 0.3 * np.random.default_rng(99).normal(size=(d_in, k))
    Y = (np.cos(X @ A) + 0.5 + 0.05 * rng.normal(size=(n, k))).astype(np.float32)
    return X, Y


def _padded(seed=1):
    """N_PAD rows of which the first N_TRUE are valid; the padding rows are
    far off, so that any leak into the fit shows."""
    X, Y = _rows(N_PAD, seed)
    X[N_TRUE:] += 9.0
    Y[N_TRUE:] = 9.0
    return X, Y


def _one_device(*arrays):
    """The arrays on the reference's 1-device mesh, rows sharded."""
    mesh = mesh_lib.make_mesh(devices=jax.devices()[:1])
    sharding = NamedSharding(mesh, PartitionSpec(mesh_lib.DATA_AXIS))
    return mesh, [jax.device_put(jnp.asarray(a), sharding) for a in arrays]


def _both(X, Y, Wrf, brf, dtype, **kw):
    t_dtype, j_dtype = DTYPES[dtype]
    mesh, (Xj, Yj) = _one_device(X, Y)
    want = jstream.streaming_block_bcd_mesh(
        Xj, Yj, jnp.asarray(Wrf), jnp.asarray(brf), mesh=mesh, feat_dtype=j_dtype, **kw)
    got = tstream.streaming_block_bcd_mesh(
        _t(X), _t(Y), _t(Wrf), _t(brf), feat_dtype=t_dtype, **kw)
    return got, want


# ---------------------------------------------------------------------------
# streaming_block_bcd_mesh, one device
# ---------------------------------------------------------------------------


class TestBlockProgram:
    @pytest.mark.parametrize("num_iter", [1, 3])
    @pytest.mark.parametrize("center", [False, True], ids=["raw", "centered"])
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_matches_reference_with_ragged_rows(self, dtype, center, num_iter):
        Wrf, brf = _bank()
        X, Y = _padded()
        got, want = _both(X, Y, Wrf, brf, dtype, block_size=BS, lam=LAM, num_iter=num_iter,
                          n_true=N_TRUE, center=center)
        if not center:
            got, want = (got,), (want,)
        W, W_ref = got[0], np.asarray(want[0])
        assert W.shape == W_ref.shape == (D_FEAT // BS, BS, K)
        assert W.dtype == torch.float32
        assert _rel(W, W_ref) <= W_TOL[dtype]
        if center:
            assert _rel(got[1], want[1]) <= FMEAN_TOL[dtype]
            assert _rel(got[2], want[2]) <= 1e-5

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_slabs_are_the_reference_features(self, monkeypatch, dtype):
        # The weights alone do not show that feat_dtype is honoured (see the
        # module docstring), so every slab the program makes is held against
        # the reference's cos(X Wbᵀ + bb) in float32, rounded to feat_dtype.
        slabs = []
        featurize = cuda_ops.cosine_features

        def recorded(*a, **kw):
            slabs.append(featurize(*a, **kw))
            return slabs[-1]

        monkeypatch.setattr(cuda_ops, "cosine_features", recorded)
        t_dtype, j_dtype = DTYPES[dtype]
        Wrf, brf = _bank()
        X, Y = _padded()
        tstream.streaming_block_bcd_mesh(_t(X), _t(Y), _t(Wrf), _t(brf), block_size=BS,
                                         lam=LAM, num_iter=2, n_true=N_TRUE,
                                         feat_dtype=t_dtype)
        nb = D_FEAT // BS
        assert len(slabs) == 2 * nb
        Xv = jnp.asarray(X[:N_TRUE])
        for i, F in enumerate(slabs):
            rows = slice(i % nb * BS, (i % nb + 1) * BS)
            want = jnp.cos(Xv @ jnp.asarray(Wrf[rows]).T + jnp.asarray(brf[rows]))
            want = np.asarray(want.astype(j_dtype).astype(jnp.float32))
            assert F.dtype == t_dtype and F.shape == (N_TRUE, BS)
            diff = np.abs(F.float().numpy() - want)
            if dtype == "f32":
                assert diff.max() <= SLAB_F32_TOL
            else:
                assert diff.max() <= 2**-7 and np.mean(diff > 0) <= 1e-3

    def test_whole_rows_match_reference(self):
        Wrf, brf = _bank(seed=3)
        X, Y = _rows(512, seed=4)
        (W, fmean, ymean), want = _both(X, Y, Wrf, brf, "f32", block_size=BS, lam=LAM,
                                        num_iter=2, center=True)
        for got, ref in zip((W, fmean, ymean), want):
            assert _rel(got, ref) <= 1e-4

    def test_padding_rows_are_dropped(self):
        # n_true views the first rows: the padding rows contribute nothing,
        # so the fit equals the fit of the valid rows alone, bit for bit.
        Wrf, brf = _bank()
        X, Y = _padded()
        kw = dict(block_size=BS, lam=LAM, num_iter=2, center=True)
        ragged = tstream.streaming_block_bcd_mesh(_t(X), _t(Y), _t(Wrf), _t(brf),
                                                  n_true=N_TRUE, **kw)
        valid = tstream.streaming_block_bcd_mesh(_t(X[:N_TRUE]), _t(Y[:N_TRUE]), _t(Wrf),
                                                 _t(brf), **kw)
        for a, b in zip(ragged, valid):
            assert torch.equal(a, b)

    def test_mesh_form_raises(self):
        Wrf, brf = _bank()
        X, Y = _rows(64)
        with pytest.raises(NotImplementedError, match="A.15"):
            tstream.streaming_block_bcd_mesh(_t(X), _t(Y), _t(Wrf), _t(brf), block_size=BS,
                                             lam=LAM, num_iter=1, mesh=object())
        with pytest.raises(ValueError, match="not divisible"):
            tstream.streaming_block_bcd_mesh(_t(X), _t(Y), _t(Wrf), _t(brf), block_size=100,
                                             lam=LAM, num_iter=1)

    @pytest.mark.parametrize("num_iter", [1, 3])
    def test_kernel_calls_per_step(self, monkeypatch, num_iter):
        # The calls the card launches (chip_smoke.py phase 12 counts them):
        # a cosine slab every step, one gram_corr_sym a block in epoch 1,
        # block_corr a block in later epochs, a residual update every step.
        # On CPU tensors no kernel launches.
        calls = {name: 0 for name in ("cosine_features", "gram_corr_sym", "block_corr",
                                      "block_residual_update")}
        for name in calls:
            fn = getattr(cuda_ops, name)

            def counted(*a, _fn=fn, _name=name, **kw):
                calls[_name] += 1
                return _fn(*a, **kw)

            monkeypatch.setattr(cuda_ops, name, counted)
        Wrf, brf = _bank()
        X, Y = _rows(256)
        before = dict(cuda_ops.launches)
        tstream.streaming_block_bcd_mesh(_t(X), _t(Y), _t(Wrf), _t(brf), block_size=BS,
                                         lam=LAM, num_iter=num_iter, center=True)
        nb = D_FEAT // BS
        assert calls == {"cosine_features": nb * num_iter, "gram_corr_sym": nb,
                         "block_corr": nb * (num_iter - 1),
                         "block_residual_update": nb * num_iter}
        assert cuda_ops.launches == before

    def test_float64_features_take_plain_contractions(self):
        Wrf, brf = _bank()
        X, Y = _rows(256)
        kw = dict(block_size=BS, lam=LAM, num_iter=2, center=True)
        W64, fmean64, _ = tstream.streaming_block_bcd_mesh(
            _t(X), _t(Y), _t(Wrf), _t(brf), feat_dtype=torch.float64, **kw)
        W32, _, _ = tstream.streaming_block_bcd_mesh(_t(X), _t(Y), _t(Wrf), _t(brf), **kw)
        assert W64.dtype == fmean64.dtype == torch.float64
        assert _rel(W64, W32) <= 1e-4


# ---------------------------------------------------------------------------
# BlockStreamedLeastSquares and the streaming choice's tier
# ---------------------------------------------------------------------------


def _choices(budget):
    port = tsls.StreamingLeastSquaresChoice(num_iter=3, lam=LAM, block_size_hint=BS)
    ref = jsls.StreamingLeastSquaresChoice(num_iter=3, lam=LAM, block_size_hint=BS)
    port.budget_bytes = ref.budget_bytes = budget
    return port, ref


class TestBlockStreamedEstimator:
    def test_tier_under_a_small_and_a_large_budget(self):
        Wrf, brf = _bank(seed=5)
        t_bank = tsls.CosineBankFeaturize(_t(Wrf), _t(brf))
        j_bank = jsls.CosineBankFeaturize(jnp.asarray(Wrf), jnp.asarray(brf))
        # Below the 8d² Gramian stash: the block tier, its block size capped
        # by the stash budget (a quarter of it).
        port, ref = _choices(2.0 * D_FEAT * D_FEAT)
        t_est, j_est = port.build_estimator(t_bank, D_FEAT), ref.build_estimator(j_bank, D_FEAT)
        assert isinstance(t_est, tsls.BlockStreamedLeastSquares)
        assert type(t_est).__name__ == type(j_est).__name__
        assert t_est.block_size == j_est.block_size < BS
        assert t_est.label == j_est.label and t_est.weight == j_est.weight
        # A generic featurizer cannot drive block slices: the gram tier.
        generic = port.build_estimator(tsls._identity_featurize, D_FEAT)
        assert isinstance(generic, tsls.StreamingFeaturizedLeastSquares)
        # A Gramian that fits keeps the gram tier.
        port, ref = _choices(1e12)
        t_est, j_est = port.build_estimator(t_bank, D_FEAT), ref.build_estimator(j_bank, D_FEAT)
        assert isinstance(t_est, tsls.StreamingFeaturizedLeastSquares)
        assert isinstance(j_est, jsls.StreamingFeaturizedLeastSquares)
        assert (t_est.block_size, t_est.tile_rows) == (j_est.block_size, j_est.tile_rows)

    def test_fit_and_apply_match_reference(self):
        # The port of tests/test_northstar.py's block-tier estimator test:
        # the fit against the reference's, and against the block solver on
        # the same features at the same block size.
        Wrf, brf = _bank(seed=5)
        port, ref = _choices(4.0 * D_FEAT * D_FEAT)
        t_est = port.build_estimator(tsls.cosine_bank_featurize(_t(Wrf), _t(brf)), D_FEAT)
        j_est = ref.build_estimator(
            jsls.cosine_bank_featurize(jnp.asarray(Wrf), jnp.asarray(brf)), D_FEAT)
        assert isinstance(t_est, tsls.BlockStreamedLeastSquares)
        assert t_est.block_size == j_est.block_size <= BS
        X, Y = _rows(512, seed=3)
        t_model = t_est.fit(TDataset(_t(X)), TDataset(_t(Y)))
        j_model = j_est.fit(JDataset.of(jnp.asarray(X)), JDataset.of(jnp.asarray(Y)))
        assert isinstance(t_model, tsls.StreamingFeaturizedLinearModel)
        assert t_model.tile_rows == j_model.tile_rows
        for name in ("W_stack", "fmean", "ymean"):
            assert _rel(getattr(t_model, name), getattr(j_model, name)) <= 1e-4, name
        Xt, _ = _rows(300, seed=8)
        p_t = t_model.batch_apply(TDataset(_t(Xt))).array.numpy()
        p_j = np.asarray(j_model.batch_apply(JDataset.of(jnp.asarray(Xt))).array)
        assert _rel(p_t, p_j) <= 1e-4
        F = tsls.CosineBankFeaturize(_t(Wrf), _t(brf))(_t(X))
        block = tblock.BlockLeastSquaresEstimator(t_est.block_size, 3, lam=LAM).fit(
            TDataset(F), TDataset(_t(Y)))
        p_b = block.batch_apply(TDataset(tsls.CosineBankFeaturize(_t(Wrf), _t(brf))(_t(Xt))))
        assert _rel(p_t, p_b.array.numpy()) <= 1e-4

    def test_raw_fit_and_ragged_rows(self):
        Wrf, brf = _bank(seed=6)
        X, Y = _padded(seed=7)
        kw = dict(d_feat=D_FEAT, block_size=BS, num_iter=2, lam=LAM, center=False)
        t_model = tsls.BlockStreamedLeastSquares(
            tsls.CosineBankFeaturize(_t(Wrf), _t(brf)), **kw
        ).fit(TDataset(_t(X), n=N_TRUE), TDataset(_t(Y), n=N_TRUE))
        assert t_model.fmean is None and t_model.offset is None
        mesh, (Xj, Yj) = _one_device(X, Y)
        W_ref = jstream.streaming_block_bcd_mesh(
            Xj, Yj, jnp.asarray(Wrf), jnp.asarray(brf), block_size=BS, lam=LAM, num_iter=2,
            mesh=mesh, n_true=N_TRUE)
        assert _rel(t_model.W_stack, W_ref) <= 1e-4

    def test_checks(self):
        Wrf, brf = _bank()
        with pytest.raises(TypeError, match="CosineBankFeaturize"):
            tsls.BlockStreamedLeastSquares(tsls._identity_featurize, D_FEAT, BS)
        with pytest.raises(ValueError, match="bank rows"):
            tsls.BlockStreamedLeastSquares(tsls.CosineBankFeaturize(_t(Wrf), _t(brf)),
                                           D_FEAT + BS, BS)

    def test_bf16_bank_fits_bf16_features(self):
        Wrf, brf = _bank(seed=5)
        X, Y = _rows(512, seed=3)
        t_model = tsls.BlockStreamedLeastSquares(
            tsls.cosine_bank_featurize(_t(Wrf), _t(brf), torch.bfloat16), D_FEAT, BS,
            lam=LAM,
        ).fit(TDataset(_t(X)), TDataset(_t(Y)))
        mesh, (Xj, Yj) = _one_device(X, Y)
        W_ref, fmean_ref, ymean_ref = jstream.streaming_block_bcd_mesh(
            Xj, Yj, jnp.asarray(Wrf), jnp.asarray(brf), block_size=BS, lam=LAM, num_iter=3,
            mesh=mesh, center=True, feat_dtype=jnp.bfloat16)
        assert _rel(t_model.W_stack, W_ref) <= W_TOL["bf16"]
        assert _rel(t_model.fmean, fmean_ref) <= FMEAN_TOL["bf16"]
        assert _rel(t_model.ymean, ymean_ref) <= 1e-5


# ---------------------------------------------------------------------------
# A TIMIT-shaped composition through the selector, past the gram tier's wall
# ---------------------------------------------------------------------------

# Four branches of 64 cosines (d = 256) over 16 inputs, 1,024 rows, k = 5.
# At this device budget every resident candidate is over it (the features
# alone are 1 MiB) and so is the gram tier (its 8d² stash 512 KiB and a
# slab); the streaming choice fits through the block tier at block 32.
COMPOSED_N, COMPOSED_HBM = 1024, 470_000


def _composition(pkg, branches, X, Y, hbm_bytes):
    if pkg == "port":
        models = [TCosineModel(_t(W), _t(b)) for W, b in branches]
        est = tcost.LeastSquaresEstimator(lam=LAM, hbm_bytes=hbm_bytes, block_size=BS)
        data, labels = TDataset(_t(X)), TDataset(_t(Y))
        pipe = TPipeline.gather([m.to_pipeline() for m in models]).and_then(TVectorCombiner())
    else:
        models = [JCosineModel(jnp.asarray(W), jnp.asarray(b)) for W, b in branches]
        est = jcost.LeastSquaresEstimator(lam=LAM, hbm_bytes=hbm_bytes, block_size=BS,
                                          num_machines=1)
        data, labels = JDataset.of(jnp.asarray(X)), JDataset.of(jnp.asarray(Y))
        pipe = JPipeline.gather([m.to_pipeline() for m in models]).and_then(JVectorCombiner())
    return est, pipe.and_then(est, data, labels)


class TestComposedPastTheWall:
    @pytest.fixture(scope="class")
    def runs(self):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("KEYSTONE_COST_WEIGHTS", "ec2")
            mp.delenv("KEYSTONE_HOST_BUDGET_BYTES", raising=False)
            branches = [_bank(seed=20 + i, d_feat=BS) for i in range(4)]
            X, Y = _rows(COMPOSED_N, seed=11)
            Xt, _ = _rows(200, seed=12)
            out = {}
            for pkg in ("port", "reference"):
                TPipelineEnv.get_or_create().reset()
                JPipelineEnv.get_or_create().reset()
                est, pipe = _composition(pkg, branches, X, Y, COMPOSED_HBM)
                fitted = pipe.fit()
                if pkg == "port":
                    pred = fitted.apply(TDataset(_t(Xt))).to_numpy()
                    cls = tsls.StreamingFeaturizedLinearModel
                else:
                    pred = np.asarray(fitted.apply(JDataset.of(jnp.asarray(Xt))).to_numpy())
                    cls = jsls.StreamingFeaturizedLinearModel
                (model,) = [op for op in fitted.transformer_graph.operators.values()
                            if isinstance(op, cls)]
                out[pkg] = dict(est=est, pred=pred, model=model)
            TPipelineEnv.get_or_create().reset()
            JPipelineEnv.get_or_create().reset()
            return out

    def test_same_winner_and_tier(self, runs):
        t_dec = runs["port"]["est"].last_decision
        assert t_dec["winner"] == "StreamingLeastSquaresChoice"
        assert all(not c["feasible"] for c in t_dec["candidates"]
                   if c["label"] != "StreamingLeastSquaresChoice")
        port_choice = runs["port"]["est"]._streaming_choice
        ref_choice = runs["reference"]["est"]._streaming_choice
        assert not port_choice._gram_tier_ok(4 * BS)
        assert not ref_choice._gram_tier_ok(4 * BS)
        assert port_choice._block_tier_bs(4 * BS) == ref_choice._block_tier_bs(4 * BS) == 32
        for pkg in ("port", "reference"):
            assert runs[pkg]["model"].W_stack.shape == (8, 32, K)

    def test_same_model_and_predictions(self, runs):
        t_model, j_model = runs["port"]["model"], runs["reference"]["model"]
        for name in ("W_stack", "fmean", "ymean"):
            assert _rel(getattr(t_model, name), getattr(j_model, name)) <= 1e-4, name
        assert runs["port"]["pred"].shape == runs["reference"]["pred"].shape == (200, K)
        assert _rel(runs["port"]["pred"], runs["reference"]["pred"]) <= 1e-4


# ---------------------------------------------------------------------------
# The bf16 cosine bank and its model carried across
# ---------------------------------------------------------------------------


class TestBf16Bank:
    @pytest.fixture
    def pallas(self, monkeypatch):
        # The reference's bank takes its Pallas kernel (in interpret mode off
        # a TPU), which rounds the operands to feat_dtype as the port does.
        monkeypatch.setenv("KEYSTONE_PALLAS", "1")

    @pytest.mark.parametrize("factory", ["class", "function"])
    def test_features_match_reference(self, pallas, factory):
        Wrf, brf = _bank(seed=2)
        X, _ = _rows(300, seed=2)
        if factory == "class":
            t_bank = tsls.CosineBankFeaturize(_t(Wrf), _t(brf), feat_dtype=torch.bfloat16)
            j_bank = jsls.CosineBankFeaturize(jnp.asarray(Wrf), jnp.asarray(brf),
                                              feat_dtype=jnp.bfloat16)
        else:
            t_bank = tsls.cosine_bank_featurize(_t(Wrf), _t(brf), torch.bfloat16)
            j_bank = jsls.cosine_bank_featurize(jnp.asarray(Wrf), jnp.asarray(brf),
                                                jnp.bfloat16)
        assert j_bank.use_pallas
        got = t_bank(_t(X))
        want = np.asarray(j_bank(jnp.asarray(X)).astype(jnp.float32))
        assert got.dtype == torch.bfloat16 and got.shape == (300, D_FEAT)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2**-7)

    def test_float32_bank_is_the_default(self):
        Wrf, brf = _bank(seed=2)
        X, _ = _rows(50, seed=2)
        bank = tsls.cosine_bank_featurize(_t(Wrf), _t(brf))
        assert bank.feat_dtype == torch.float32
        assert torch.equal(bank(_t(X)), cuda_ops.cosine_features_ref(_t(X), _t(Wrf), _t(brf)))

    def test_feat_itemsize_sizes_the_tiles(self):
        # The port takes the element size from the featurizer (a bank's
        # feat_dtype, else float32); the reference is told it.
        Wrf, brf = _bank(seed=2)
        cases = [(tsls._identity_featurize, 4),
                 (tsls.CosineBankFeaturize(_t(Wrf), _t(brf)), 4),
                 (tsls.cosine_bank_featurize(_t(Wrf), _t(brf), torch.bfloat16), 2)]
        for featurize, itemsize in cases:
            port = tsls.StreamingFeaturizedLeastSquares(featurize, 16_384, 4096)
            ref = jsls.StreamingFeaturizedLeastSquares(
                jsls._identity_featurize, 16_384, 4096, feat_itemsize=itemsize)
            assert port.tile_rows == ref.tile_rows == 65_536 * 4 // (2 * itemsize)

    def test_interop_model_over_a_bf16_bank(self, pallas):
        Wrf, brf = _bank(seed=4)
        X, Y = _rows(512, seed=5)
        j_bank = jsls.CosineBankFeaturize(jnp.asarray(Wrf), jnp.asarray(brf),
                                          feat_dtype=jnp.bfloat16)
        j_model = jsls.BlockStreamedLeastSquares(j_bank, D_FEAT, BS, lam=LAM).fit(
            JDataset.of(jnp.asarray(X)), JDataset.of(jnp.asarray(Y)))
        params = {name: np.asarray(getattr(j_model, name))
                  for name in ("W_stack", "fmean", "ymean")}
        params.update(Wrf=Wrf, brf=brf, tile_rows=j_model.tile_rows,
                      feat_dtype=j_bank.feat_dtype)
        t_model = interop.params_from_jax(params, device="cpu")
        assert isinstance(t_model, tsls.StreamingFeaturizedLinearModel)
        assert t_model.featurize.feat_dtype == torch.bfloat16
        assert t_model.tile_rows == j_model.tile_rows
        Xt, _ = _rows(300, seed=6)
        got = t_model.batch_apply(TDataset(_t(Xt))).array.numpy()
        want = np.asarray(j_model.batch_apply(JDataset.of(jnp.asarray(Xt))).array)
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
        for dtype in ("bfloat16", torch.bfloat16):
            model = interop.streaming_linear_model(
                params["W_stack"], None, None, Wrf, brf, 256, device="cpu", feat_dtype=dtype)
            assert model.featurize.feat_dtype == torch.bfloat16
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            interop.streaming_linear_model(params["W_stack"], None, None, Wrf, brf, 256,
                                           device="cpu", feat_dtype="float16")


# ---------------------------------------------------------------------------
# The block tier against the stacked solve (--solver block, apply first)
# ---------------------------------------------------------------------------


class TestGapToTheStackedSolve:
    """ROADMAP C.5: on TIMIT-shaped rows (synthetic_timit, four cosine
    branches, 3 epochs, λ 0) the block tier's weights differ from the
    stacked solve's on the same features, which centres them explicitly
    where the tier corrects its Gramian by a rank-1 term. In float32 the
    gap is 1.5e-6 here (2.3e-6 at phase 2's 65,536 rows and blocks of
    4,096, on the CPU); with float64 features it shrinks 5.5x (7x at phase
    2's size), and what stays is the tier's float32 column sums (its
    feature means 5e-8 from the stacked solve's): the gap is rounding,
    not two programs."""

    def _gap(self, dtype):
        from keystone_tpu_torch.data.loaders import synthetic_timit
        from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels
        from keystone_tpu_torch.parallel import linalg
        from keystone_tpu_torch.pipelines import timit

        n, nb, bs, k = 8192, 4, 1024, 147
        config = timit.TimitConfig(num_cosines=nb, block_size=bs, synthetic_n=n)
        train = synthetic_timit(n, seed=config.seed, device="cpu")
        X = train.data.array
        Y = ClassLabelIndicatorsFromIntLabels(k)(train.labels).array
        rfs = timit._cosine_models(config, "cpu")
        Wrf, brf = torch.cat([rf.W for rf in rfs]), torch.cat([rf.b for rf in rfs])
        F = cuda_ops.cosine_features(X, Wrf, brf).to(dtype)
        Fc = (F - F.mean(dim=0)).reshape(n, nb, bs).permute(1, 0, 2).contiguous()
        ymean = Y.to(dtype).mean(dim=0)
        stacked = linalg.bcd_least_squares_fused(Fc, Y.to(dtype) - ymean, lam=0.0, num_iter=3)
        tier, _, _ = tstream.streaming_block_bcd_mesh(
            X, Y, Wrf, brf, block_size=bs, lam=0.0, num_iter=3, feat_dtype=dtype, center=True)
        return torch.stack(list(stacked)).double(), tier.double()

    def test_the_gap_is_rounding(self):
        s32, t32 = self._gap(torch.float32)
        s64, t64 = self._gap(torch.float64)
        gap32, gap64 = _rel(t32, s32), _rel(t64, s64)
        assert 1e-7 < gap32 <= 1e-5
        assert gap64 <= gap32 / 3
        # Each program moves by about the gap between float32 and float64.
        assert _rel(s32, s64) >= gap32 / 3 and _rel(t32, t64) >= gap32 / 3
