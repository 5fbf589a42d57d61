"""The port's L-BFGS solvers against the JAX package, on the CPU: the dense
and sparse ``run_lbfgs`` and the quad loop's iterates, ``DenseLBFGSwithL2``,
``SparseLBFGSwithL2`` by every engine (gather, gram with f32 and bf16
slabs, compressed-resident), the streamed fit whole and segmented, the
constructor raises and the options still to port, and the cost model.

Inputs come from seeded numpy generators and are float32 on both sides
(tests/conftest.py turns on x64, and the reference's ``run_lbfgs`` follows
``result_type``, so arrays handed to JAX are float32). The reference's gram
engine runs its XLA fold on the CPU (``use_pallas`` follows
``pallas_direct_ok``, false off-TPU); its interpret-mode Pallas fold is
held against the port's in tests/test_torch_sparse.py.

Tolerances and why:
  - weights and intercepts against the reference: 1e-4 relative Frobenius
    (the target the slice set; the engines measure ~3e-7, summation order
    in float32 over at most 25 iterations);
  - losses: 1e-5 relative;
  - gram against gather: the reference's own ``rtol=5e-3, atol=5e-4``
    (tests/test_sparse_gram.py:110);
  - compressed against bf16 gram, segmented against single, pipeline on
    against off: bit for bit.
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.data import resident as tres
from keystone_tpu_torch.ops import sparse as tsp
from keystone_tpu_torch.ops.learning import lbfgs as tl
from keystone_tpu_torch.workflow import PipelineEnv as TPipelineEnv

import jax.numpy as jnp

from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.ops.learning import lbfgs as jl
from keystone_tpu.workflow import PipelineEnv as JPipelineEnv

N, D, W_NNZ, K, CHUNK, LAM = 3000, 300, 8, 2, 512, 1e-3


@pytest.fixture(autouse=True)
def clean_envs():
    TPipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()
    yield
    TPipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _problem(n=N, d=D, w=W_NNZ, k=K, seed=0):
    """Rows with a planted model (so the fit has signal), -1 lanes, and
    duplicate columns within a row; ±1 one-hot labels."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(n, w)).astype(np.int32)
    idx[rng.random(size=(n, w)) < 0.05] = -1
    vals = rng.normal(size=(n, w)).astype(np.float32)
    truth = rng.normal(size=d).astype(np.float32)
    score = (vals * np.where(idx >= 0, truth[idx], 0.0)).sum(1) + rng.normal(size=n)
    Y = (2.0 * np.eye(k, dtype=np.float32)[(score > 0).astype(int) % k] - 1.0)
    return idx, vals, Y


def _datasets(idx, vals, Y, n=None):
    n = idx.shape[0] if n is None else n
    t = (TDataset({"indices": _t(idx), "values": _t(vals)}, n=n), TDataset(_t(Y)))
    j = (JDataset({"indices": jnp.asarray(idx), "values": jnp.asarray(vals)}, n=n),
         JDataset.of(jnp.asarray(Y)))
    return t, j


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------


class TestRunLBFGS:
    def test_dense(self):
        rng = np.random.default_rng(1)
        X = rng.normal(size=(400, 30)).astype(np.float32)
        Y = rng.normal(size=(400, 3)).astype(np.float32)
        got = tl.run_lbfgs(_t(X), _t(Y), lam=0.1, num_iterations=30, n=400)
        want = jl.run_lbfgs(jnp.asarray(X), jnp.asarray(Y), lam=0.1, num_iterations=30, n=400)
        assert got.dtype == torch.float32 and _rel(got, want) <= 1e-4

    def test_sparse(self):
        idx, vals, Y = _problem(seed=2)
        W0 = np.zeros((D, K), np.float32)
        got = tl.run_lbfgs({"indices": _t(idx), "values": _t(vals)}, _t(Y), lam=LAM,
                           num_iterations=20, n=N, W_init=_t(W0))
        want = jl.run_lbfgs({"indices": jnp.asarray(idx), "values": jnp.asarray(vals)},
                            jnp.asarray(Y), lam=LAM, num_iterations=20, n=N,
                            W_init=jnp.asarray(W0))
        assert _rel(got, want) <= 1e-4
        with pytest.raises(ValueError, match="W_init"):
            tl.run_lbfgs({"indices": _t(idx), "values": _t(vals)}, _t(Y))

    @pytest.mark.parametrize("iters", [0, 1, 2, 5, 10, 12, 25, 40])
    def test_quad_loop_iterates(self, iters):
        # 12, 25 and 40 iterations wrap the 10-pair circular history. The
        # problem is moderately conditioned (five columns scaled by 3): the
        # history matters, and float32 rounding is not amplified past 1e-5
        # (a condition number of ~1e3 would let the two orders of summation
        # drift apart by 1e-2 mid-run).
        rng = np.random.default_rng(3)
        A = rng.normal(size=(400, 40)).astype(np.float32)
        A[:, :5] *= 3.0
        G, B = A.T @ A, rng.normal(size=(40, 2)).astype(np.float32)
        W0 = np.zeros((40, 2), np.float32)
        got = tl._lbfgs_quad_loop(lambda P: _t(G) @ P / 400 + 0.01 * P, _t(B), _t(W0), iters,
                                  1e-12)
        import jax

        want = jl._lbfgs_quad_loop(
            lambda P: jnp.dot(jnp.asarray(G), P, precision=jax.lax.Precision.HIGHEST) / 400
            + 0.01 * P, jnp.asarray(B), jnp.asarray(W0), 0.01, iters, 1e-12)
        assert _rel(got, want) <= 1e-4 if iters else float(got.abs().max()) == 0.0

    def test_loss_through_the_gram_equals_the_data_pass(self):
        idx, vals, Y = _problem(seed=4)
        X = {"indices": _t(idx), "values": _t(vals)}
        tiles = tres.raw_chunk_tiles(_t(idx), _t(vals), _t(Y), CHUNK)
        G, AtY, yty = tsp.sparse_gram_stream(lambda cid: tl._resident_chunk_fn(cid, *tiles),
                                             int(tiles[0].shape[0]), D, K)
        W = _t(np.random.default_rng(5).normal(size=(D, K)).astype(np.float32)) * 0.1
        W_g, loss_g = tl._lbfgs_gram_core(G, AtY, yty, W, LAM, 0, 1e-4, N)
        assert torch.equal(W_g, W)
        want = tl.least_squares_loss(W, X, _t(Y), LAM, N)
        assert float(loss_g) == pytest.approx(float(want), rel=1e-5)


class TestDenseLBFGS:
    def test_fit_matches_the_reference(self):
        rng = np.random.default_rng(6)
        X = rng.normal(size=(500, 20)).astype(np.float32) + 2.0
        Y = (X @ rng.normal(size=(20, 3)) + 1.5).astype(np.float32)
        got = tl.DenseLBFGSwithL2(lam=0.01, num_iterations=40).fit(TDataset(_t(X)),
                                                                  TDataset(_t(Y)))
        want = jl.DenseLBFGSwithL2(lam=0.01, num_iterations=40).fit(JDataset.of(jnp.asarray(X)),
                                                                   JDataset.of(jnp.asarray(Y)))
        assert _rel(got.x, want.x) <= 1e-4 and _rel(got.b_opt, want.b_opt) <= 1e-5
        assert _rel(got.feature_scaler.mean, want.feature_scaler.mean) <= 1e-6
        Xt = rng.normal(size=(50, 20)).astype(np.float32)
        assert _rel(got.batch_apply(TDataset(_t(Xt))).array,
                    want.batch_apply(JDataset.of(jnp.asarray(Xt))).array) <= 1e-4

    def test_device_fit_fn_matches_fit_and_masks_padding(self):
        rng = np.random.default_rng(7)
        X = rng.normal(size=(300, 16)).astype(np.float32) + 1.0
        Y = rng.normal(size=(300, 2)).astype(np.float32)
        est = tl.DenseLBFGSwithL2(lam=0.05, num_iterations=30)
        fitted = est.fit(TDataset(_t(X)), TDataset(_t(Y)))
        pad = np.concatenate([X, np.full((20, 16), 7.0, np.float32)])  # featurize(0) != 0
        Ypad = np.concatenate([Y, np.full((20, 2), 3.0, np.float32)])
        dev = est.device_fit_fn()
        model = dev.build(dev.fit(_t(pad), _t(Ypad), 300))
        assert _rel(model.x, fitted.x.numpy()) <= 1e-5
        assert _rel(model.b_opt, fitted.b_opt.numpy()) <= 1e-6

    def test_cost_and_capacity_match_the_reference(self):
        args = (1e6, 4096, 10, 1.0, 1)
        for lam, iters in ((0.0, 20), (1e-3, 100)):
            ours, ref = tl.DenseLBFGSwithL2(lam, iters), jl.DenseLBFGSwithL2(lam, iters)
            assert ours.cost(*args, 3.8e-4, 2.9e-1, 1.32) == pytest.approx(
                ref.cost(*args, 3.8e-4, 2.9e-1, 1.32))
            assert ours.resident_bytes(*args) == ref.resident_bytes(*args)
            assert ours.weight == ref.weight


ENGINES = {
    "gather": dict(),
    "gram f32": dict(solver="gram", gram_chunk_rows=CHUNK),
    "gram bf16": dict(solver="gram", gram_chunk_rows=CHUNK, gram_dtype="bf16"),
    "compressed": dict(solver="gram", gram_chunk_rows=CHUNK, compress="int16_bf16"),
}


class TestSparseLBFGS:
    @pytest.mark.parametrize("engine", list(ENGINES))
    def test_engine_matches_the_reference(self, engine):
        idx, vals, Y = _problem(seed=8)
        (td, tlab), (jd, jlab) = _datasets(idx, vals, Y, n=N - 40)
        kw = dict(lam=LAM, num_iterations=20, num_features=D, **ENGINES[engine])
        got = tl.SparseLBFGSwithL2(**kw).fit(td, tlab)
        want = jl.SparseLBFGSwithL2(**kw).fit(jd, jlab)
        assert got.x.shape == (D, K) and got.b_opt.shape == (K,)
        # The solver's unknown is W₁ = [x; b] (the intercept is the
        # append-ones lane's weight): held whole, since b alone is ~1e-3 of
        # x's scale with these balanced labels.
        W1 = torch.cat([got.x, got.b_opt[None]])
        assert _rel(W1, np.concatenate([np.asarray(want.x), np.asarray(want.b_opt)[None]])) <= 1e-4

    def test_gram_matches_gather(self):
        idx, vals, Y = _problem(seed=9)
        (td, tlab), _ = _datasets(idx, vals, Y)
        gather = tl.SparseLBFGSwithL2(lam=LAM, num_iterations=25, num_features=D).fit(td, tlab)
        gram = tl.SparseLBFGSwithL2(lam=LAM, num_iterations=25, num_features=D, solver="gram",
                                    gram_chunk_rows=CHUNK).fit(td, tlab)
        np.testing.assert_allclose(gram.x.numpy(), gather.x.numpy(), rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(gram.b_opt.numpy(), gather.b_opt.numpy(), rtol=5e-3,
                                   atol=5e-4)

    def test_compressed_has_the_bits_of_bf16_gram(self):
        idx, vals, Y = _problem(seed=10)
        (td, tlab), _ = _datasets(idx, vals, Y)
        kw = dict(lam=LAM, num_iterations=20, num_features=D, solver="gram",
                  gram_chunk_rows=CHUNK)
        m16 = tl.SparseLBFGSwithL2(gram_dtype="bf16", **kw).fit(td, tlab)
        mc = tl.SparseLBFGSwithL2(compress="int16_bf16", **kw).fit(td, tlab)
        assert torch.equal(m16.x, mc.x) and torch.equal(m16.b_opt, mc.b_opt)

    def test_bf16_values_fold_in_bf16(self):
        idx, vals, Y = _problem(seed=11)
        data = TDataset({"indices": _t(idx), "values": _t(vals).to(torch.bfloat16)})
        kw = dict(lam=LAM, num_iterations=15, num_features=D, solver="gram",
                  gram_chunk_rows=CHUNK)
        m_in = tl.SparseLBFGSwithL2(**kw).fit(data, TDataset(_t(Y)))
        m16 = tl.SparseLBFGSwithL2(gram_dtype="bf16", **kw).fit(
            TDataset({"indices": _t(idx), "values": _t(vals)}), TDataset(_t(Y)))
        assert torch.equal(m_in.x, m16.x)

    def test_dense_input_takes_the_dense_core(self):
        rng = np.random.default_rng(12)
        X = rng.normal(size=(300, 12)).astype(np.float32)
        Y = rng.normal(size=(300, 2)).astype(np.float32)
        got = tl.SparseLBFGSwithL2(lam=LAM, num_iterations=20).fit(TDataset(_t(X)),
                                                                   TDataset(_t(Y)))
        want = jl.SparseLBFGSwithL2(lam=LAM, num_iterations=20).fit(JDataset.of(jnp.asarray(X)),
                                                                    JDataset.of(jnp.asarray(Y)))
        assert _rel(got.x, want.x) <= 1e-4 and _rel(got.b_opt, want.b_opt) <= 1e-4

    def test_sparsify_pipeline_matches_the_reference(self):
        from keystone_tpu.ops.sparse import Sparsify as JSparsify

        idx, vals, Y = _problem(seed=13)
        (td, tlab), (jd, jlab) = _datasets(idx, vals, Y)
        kw = dict(lam=LAM, num_iterations=20, num_features=D, solver="gram",
                  gram_chunk_rows=CHUNK)
        got = tsp.Sparsify().and_then(tl.SparseLBFGSwithL2(**kw), td, tlab).fit()
        want = JSparsify().and_then(jl.SparseLBFGSwithL2(**kw), jd, jlab).fit()
        pi, pv, _ = _problem(n=200, seed=14)
        (tp, _), (jp, _) = _datasets(pi, pv, Y[:200])
        assert _rel(got.apply(tp).array, want.apply(jp).array) <= 1e-4


class TestStreamed:
    def _tiles(self, seed):
        idx, vals, Y = _problem(n=3000, seed=seed)
        c = 500
        return [_t(a).reshape(3000 // c, c, -1) for a in (idx, vals, Y)], [
            jnp.asarray(a).reshape(3000 // c, c, -1) for a in (idx, vals, Y)]

    @staticmethod
    def _chunk(cid, it, vt, yt):
        cid = min(int(cid), it.shape[0] - 1)  # ids past the end slice safely
        return it[cid], vt[cid], yt[cid]

    def test_segmented_equals_single_and_the_reference(self):
        tt, jt = self._tiles(15)
        kw = dict(lam=LAM, num_iterations=20, n=3000)
        W1, l1 = tl.run_lbfgs_gram_streamed(self._chunk, 6, D, K, operands=tt, **kw)
        W4, l4 = tl.run_lbfgs_gram_streamed(self._chunk, 6, D, K, operands=tt,
                                            max_chunks_per_dispatch=4, **kw)
        W5, l5 = tl.run_lbfgs_gram_streamed(self._chunk, 6, D, K, operands=tt, pipeline=False,
                                            max_chunks_per_dispatch=5, **kw)
        assert torch.equal(W1, W4) and torch.equal(l1, l4)
        assert torch.equal(W1, W5) and torch.equal(l1, l5)

        def jchunk(cid, it, vt, yt):
            cid = jnp.minimum(cid, it.shape[0] - 1)
            return it[cid], vt[cid], yt[cid]

        Wj, lj = jl.run_lbfgs_gram_streamed(jchunk, 6, D, K, operands=tuple(jt),
                                            max_chunks_per_dispatch=4, **kw)
        assert _rel(W1, Wj) <= 1e-4 and float(l1) == pytest.approx(float(lj), rel=1e-5)

    def test_unported_options_raise_naming_the_roadmap(self):
        tt, _ = self._tiles(16)
        kw = dict(n=3000, operands=tt)
        with pytest.raises(ValueError, match="n"):
            tl.run_lbfgs_gram_streamed(self._chunk, 6, D, K, operands=tt)
        with pytest.raises(NotImplementedError, match="A.15"):
            tl.run_lbfgs_gram_streamed(self._chunk, 6, D, K, mesh=object(), **kw)
        # The disk tier's options are ported (tests/test_torch_outofcore.py);
        # misused, they raise the reference's contract errors.
        for option, match in ((dict(segment_source=lambda c, s: None), "max_chunks"),
                              (dict(checkpoint="/nonexistent"), "segmented")):
            with pytest.raises(ValueError, match=match):
                tl.run_lbfgs_gram_streamed(self._chunk, 6, D, K, **option, **kw)


class TestContract:
    @pytest.mark.parametrize("kw,match", [
        (dict(solver="newton"), "solver"),
        (dict(gram_dtype="f16"), "gram_dtype"),
        (dict(solver="gram", compress="zstd"), "compress"),
        (dict(solver="gather", compress="int16_bf16"), "gram"),
        (dict(solver="gram", compress="int16_bf16", gram_dtype="f32"), "f32"),
    ])
    def test_constructor_raises_as_the_reference_does(self, kw, match):
        with pytest.raises(ValueError, match=match):
            tl.SparseLBFGSwithL2(**kw)
        with pytest.raises(ValueError, match=match):
            jl.SparseLBFGSwithL2(**kw)

    def test_compressed_fit_past_the_int16_boundary_raises(self):
        idx = np.array([[0, 5], [40000, 2]], np.int32)
        data = TDataset({"indices": _t(idx), "values": _t(np.ones((2, 2), np.float32))})
        est = tl.SparseLBFGSwithL2(solver="gram", compress="int16_bf16", num_iterations=2)
        with pytest.raises(ValueError, match="int16"):
            est.fit(data, TDataset(_t(np.ones((2, 1), np.float32))))

    @pytest.mark.parametrize("engine", list(ENGINES))
    def test_cost_and_capacity_match_the_reference_ec2_weights(self, engine, monkeypatch):
        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", "ec2")
        kw = {k: v for k, v in ENGINES[engine].items() if k != "gram_chunk_rows"}
        ours = tl.SparseLBFGSwithL2(num_iterations=20, **kw)
        ref = jl.SparseLBFGSwithL2(num_iterations=20, **kw)
        for n, d, k, sp, m in ((1e6, 16384, 2, 82 / 16384, 1), (65e6, 16384, 2, 0.005, 16),
                               (1e6, 40000, 2, 1e-3, 1)):
            args = (n, d, k, sp, m)
            assert ours.cost(*args, 3.8e-4, 2.9e-1, 1.32) == pytest.approx(
                ref.cost(*args, 3.8e-4, 2.9e-1, 1.32))
            assert ours.resident_bytes(*args) == ref.resident_bytes(*args)
        assert ours.weight == ref.weight

    def test_gather_overhead_is_the_reference_ec2_value_never_the_tpu_one(self, monkeypatch):
        from keystone_tpu.ops.learning import cost as jcost

        from keystone_tpu_torch.ops.learning import cost as tcost

        monkeypatch.delenv("KEYSTONE_COST_WEIGHTS", raising=False)
        overhead = tl.SparseLBFGSwithL2()._sparse_overhead
        assert overhead == tcost.EC2_SPARSE_GATHER_OVERHEAD == jcost.EC2_SPARSE_GATHER_OVERHEAD
        assert overhead != jcost.TPU_SPARSE_GATHER_OVERHEAD
