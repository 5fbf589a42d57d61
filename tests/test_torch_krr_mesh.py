"""Kernel ridge regression on a mesh and the last options of
``ops/learning/kernel.py``: the mesh sweep (the reference's
``_krr_mesh_program``), the ring apply, checkpoint resume on a mesh,
``profile=True`` (the stepwise path) and ``kernel_dtype="bf16x3"``.

The port runs on an 8-shard CPU mesh, the reference (``keystone_tpu``) on
its own 8-device CPU mesh (tests/conftest.py), on the same numpy-seeded
float32 inputs. Twins of tests/test_ring.py's mapper and fit cases,
tests/test_krr_checkpoint.py's mesh resume and tests/test_kernel_bf16.py.

Tolerances (the reference tests' own):
  - the mesh fit's weights against the reference's mesh fit and the
    port's one-device fit: 1e-4 relative Frobenius (the psum reassociates
    each step's residual over 8 shards);
  - the ring apply against the one-device apply: 1e-4 absolute;
  - the fused mesh sweep against the stepwise path: 2e-4 absolute;
  - a resumed mesh fit against an uninterrupted one: bit for bit (the same
    steps on the same inputs; the reference allows 1e-5);
  - bf16x3 kernel entries: 1e-3 of f32's (test_kernel_bf16.py), 1e-6 of a
    float64 evaluation of the same three products; its fit's accuracy
    within 1 point of f32's (test_kernel_bf16.py), its predictions 1% of
    f32's scale at λ = 0.1 and 5% at the reference test's λ = 1e-3 (see
    test_bf16x3_fit_tracks_f32), its mesh weights 1e-4 of its one-device
    weights.
"""

import logging
import os
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.ops.learning import kernel as jkernel
from keystone_tpu.parallel import mesh as jmesh
from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.ops import cuda_ops
from keystone_tpu_torch.ops.learning import kernel as tkernel
from keystone_tpu_torch.parallel import mesh as tmesh

CPU8 = ["cpu"] * 8
N, D, K, BS, EPOCHS = 70, 6, 3, 16, 2  # 70 rows: 5 blocks, the last 6 rows; 72 padded
GAMMA, LAM = 0.15, 1e-3


@pytest.fixture()
def jm():
    m = jmesh.make_mesh((8,), (jmesh.DATA_AXIS,))
    with jmesh.use_mesh(m):
        yield m


@pytest.fixture()
def tm():
    return tmesh.make_mesh((8,), devices=CPU8)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _problem(seed=0, n=N, d=D, k=K):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(n, k)).astype(np.float32))


def _t_est(gamma=GAMMA, lam=LAM, bs=BS, epochs=EPOCHS, kernel_dtype="f32", **kw):
    return tkernel.KernelRidgeRegression(
        tkernel.GaussianKernelGenerator(gamma, kernel_dtype), lam, bs, epochs, **kw)


def _j_est(gamma=GAMMA, lam=LAM, bs=BS, epochs=EPOCHS, kernel_dtype="f32", **kw):
    return jkernel.KernelRidgeRegression(
        jkernel.GaussianKernelGenerator(gamma, kernel_dtype), lam, bs, epochs, **kw)


def _t_sharded(X, Y, mesh):
    return TDataset(_t(X)).shard(mesh), TDataset(_t(Y)).shard(mesh)


def _weights(model):
    return np.stack([np.asarray(w.cpu() if isinstance(w, torch.Tensor) else w)
                     for w in model.w_locals])


class TestMeshFit:
    @pytest.mark.parametrize("permuter", [None, 3])
    def test_against_the_reference_mesh_fit(self, jm, tm, permuter):
        X, Y = _problem()
        want = _weights(_j_est(block_permuter=permuter).fit(
            JDataset.of(X).shard(jm), JDataset.of(Y).shard(jm)))
        got = _weights(_t_est(block_permuter=permuter).fit(*_t_sharded(X, Y, tm)))
        assert got.shape == want.shape == (5, BS, K)
        assert _rel(got, want) < 1e-4
        # The ragged last block's ghost rows solve to exactly zero.
        assert np.all(got[-1, N - 4 * BS:] == 0.0)

    def test_against_the_one_device_fit(self, tm):
        X, Y = _problem(seed=1)
        one = _weights(_t_est().fit(TDataset(_t(X)), TDataset(_t(Y))))
        mesh = _weights(_t_est().fit(*_t_sharded(X, Y, tm)))
        assert _rel(mesh, one) < 1e-4

    def test_runs_the_mesh_sweep_and_never_gathers(self, tm, monkeypatch):
        """n = 70 does not divide by 8: the last shard holds 7 rows and 2
        padding rows (zero X, zero W), which must add nothing."""
        X, Y = _problem(seed=2)
        data, labels = _t_sharded(X, Y, tm)
        assert data.array.shard_rows == 9

        def refuse(*a, **k):
            raise AssertionError("the mesh fit left the mesh")

        shapes = []
        real = cuda_ops.gaussian_resid_block
        monkeypatch.setattr(tmesh.ShardedRows, "gather", refuse)
        monkeypatch.setattr(cuda_ops, "gaussian_resid_block",
                            lambda *a, **k: shapes.append(tuple(a[0].shape)) or real(*a, **k))
        model = _t_est().fit(data, labels)
        monkeypatch.undo()
        # One launch a shard a block step, on the shard's own 9 rows (a sweep
        # of the gathered rows would launch once a step on all 70).
        assert shapes == [(9, D)] * (8 * 5 * EPOCHS)
        want = _weights(_t_est().fit(TDataset(_t(X)), TDataset(_t(Y))))
        assert _rel(_weights(model), want) < 1e-4

    def test_padding_rows_carry_zero_weights(self, tm):
        X, Y = _problem(seed=3)
        data, labels = _t_sharded(X, Y, tm)
        est = _t_est()
        xs = tkernel._on_mesh(data.array, tm)
        assert xs.shape[0] == 72
        gathered = tmesh.all_gather(list(xs.shards))
        t = est.kernel_generator.fit(TDataset(gathered[0][:N]))
        sweep = tkernel._Sweep(t, _t(Y), BS, xs, gathered)
        grams, chols = tkernel._diag_factor_prepass(t, LAM, BS, 5)
        stack = sweep.run(list(range(5)), grams, chols, LAM, torch.zeros(5, BS, K))
        W = sweep.weights_from_stack(stack)
        assert torch.equal(W[-1][7:], torch.zeros(2, K))  # padding rows 70 and 71
        assert torch.equal(torch.cat(W)[:N], stack.reshape(-1, K)[:N])


class TestRingApply:
    def test_sharded_apply_matches_single_device(self, jm, tm):
        X, Y = _problem(seed=4, n=40, d=5)
        Xte = np.random.default_rng(5).normal(size=(16, 5)).astype(np.float32)
        est = _t_est(gamma=0.2, epochs=2)
        model = est.fit(TDataset(_t(X)), TDataset(_t(Y)))
        dense = model.batch_apply(TDataset(_t(Xte))).to_numpy()
        ringed = model.batch_apply(TDataset(_t(Xte)).shard(tm))
        assert ringed.mesh is tm and isinstance(ringed.array, tmesh.ShardedRows)
        np.testing.assert_allclose(ringed.to_numpy(), dense, atol=1e-4)
        jmodel = _j_est(gamma=0.2, epochs=2).fit(JDataset.of(X), JDataset.of(Y))
        want = np.asarray(jmodel.batch_apply(JDataset.of(Xte).shard(jm)).to_numpy())
        np.testing.assert_allclose(ringed.to_numpy(), want, atol=1e-4)

    def test_sharded_operands_cached_and_never_pickled(self, tm, monkeypatch):
        X, Y = _problem(seed=6)
        model = _t_est().fit(TDataset(_t(X)), TDataset(_t(Y)))
        test = TDataset(_t(X[:20])).shard(tm)
        calls = []
        real = tmesh.shard_rows
        monkeypatch.setattr(tmesh, "shard_rows", lambda *a, **k: calls.append(1) or real(*a, **k))
        first = model.batch_apply(test).to_numpy()
        second = model.batch_apply(test).to_numpy()
        assert len(calls) == 2  # train rows and W, once for the (model, mesh) pair
        np.testing.assert_array_equal(first, second)
        assert model._ring_operands[0] is tm
        clone = pickle.loads(pickle.dumps(model))
        assert clone._ring_operands is None
        np.testing.assert_array_equal(clone.batch_apply(test).to_numpy(), first)

    def test_sharded_fit_and_apply_match_single_device(self, jm, tm):
        X, Y = _problem(seed=7, n=64, d=8)
        ref = _t_est(gamma=0.1, lam=1e-3, bs=16, epochs=2).fit(
            TDataset(_t(X)), TDataset(_t(Y))).batch_apply(TDataset(_t(X))).to_numpy()
        data, labels = _t_sharded(X, Y, tm)
        out = _t_est(gamma=0.1, lam=1e-3, bs=16, epochs=2).fit(data, labels).batch_apply(
            data).to_numpy()
        np.testing.assert_allclose(out, ref, atol=1e-4)
        jmodel = _j_est(gamma=0.1, lam=1e-3, bs=16, epochs=2).fit(
            JDataset.of(X).shard(jm), JDataset.of(Y).shard(jm))
        want = np.asarray(jmodel.batch_apply(JDataset.of(X).shard(jm)).to_numpy())
        np.testing.assert_allclose(out, want, atol=1e-4)


class _PreemptAfter:
    """os.replace wrapper that completes the Nth checkpoint save, then
    'preempts' (the reference's tests/test_krr_checkpoint.py helper)."""

    def __init__(self, monkeypatch, n_saves: int, path: str):
        self.remaining = n_saves
        self.path = str(path)
        self._real = os.replace
        monkeypatch.setattr(os, "replace", self)

    def __call__(self, src, dst):
        self._real(src, dst)
        if str(dst) != self.path:
            return
        self.remaining -= 1
        if self.remaining == 0:
            raise KeyboardInterrupt("simulated preemption after save")


class TestMeshCheckpoint:
    def test_mesh_fit_resumes_to_same_model(self, tmp_path, monkeypatch, tm):
        X, Y = _problem(seed=8, n=300, d=12, k=4)
        data, labels = _t_sharded(X, Y, tm)

        def est(**kw):
            return _t_est(gamma=0.05, lam=0.2, bs=64, epochs=3, **kw)

        ref = _weights(est().fit(data, labels))
        path = str(tmp_path / "krr_mesh.ckpt")
        _PreemptAfter(monkeypatch, n_saves=2, path=path)
        with pytest.raises(KeyboardInterrupt):
            est(checkpoint_path=path, checkpoint_every_blocks=3).fit(data, labels)
        monkeypatch.undo()
        with np.load(path, allow_pickle=False) as ck:
            assert int(ck["pos"]) == 6
        out = _weights(est(checkpoint_path=path, checkpoint_every_blocks=3).fit(data, labels))
        np.testing.assert_array_equal(out, ref)
        assert not os.path.exists(path)

    def test_mesh_and_one_device_checkpoints_share_a_fingerprint(self, tmp_path, monkeypatch,
                                                                tm):
        # The fingerprint samples stored rows, so it does not depend on the
        # layout: a one-device fit resumes a mesh fit's checkpoint.
        X, Y = _problem(seed=9, n=300, d=12, k=4)
        path = str(tmp_path / "krr.ckpt")
        _PreemptAfter(monkeypatch, n_saves=1, path=path)
        with pytest.raises(KeyboardInterrupt):
            _t_est(bs=64, checkpoint_path=path, checkpoint_every_blocks=2).fit(
                *_t_sharded(X, Y, tm))
        monkeypatch.undo()
        resumed = _weights(_t_est(bs=64, checkpoint_path=path, checkpoint_every_blocks=2).fit(
            TDataset(_t(X)), TDataset(_t(Y))))
        assert _rel(resumed, _weights(_t_est(bs=64).fit(TDataset(_t(X)), TDataset(_t(Y))))) \
            < 1e-4


class TestProfilePath:
    def test_fused_mesh_sweep_matches_stepwise(self, tm):
        X, Y = _problem(seed=10, n=72)  # ragged last block (72 = 4 x 16 + 8)
        data, labels = _t_sharded(X, Y, tm)
        fused = _t_est(lam=1e-3, epochs=2).fit(data, labels)
        stepwise = _t_est(lam=1e-3, epochs=2, profile=True).fit(data, labels)
        for wf, ws in zip(fused.w_locals, stepwise.w_locals):
            np.testing.assert_allclose(wf.numpy(), ws.numpy(), atol=2e-4)

    def test_logs_each_block_and_the_phases(self, caplog):
        X, Y = _problem(seed=11)
        with caplog.at_level(logging.INFO, logger="keystone_tpu_torch"):
            model = _t_est(profile=True, block_permuter=5).fit(TDataset(_t(X)), TDataset(_t(Y)))
        lines = [r.getMessage() for r in caplog.records]
        blocks = [m for m in lines if m.startswith("EPOCH_")]
        assert len(blocks) == 5 * EPOCHS
        assert {m.split(" took")[0] for m in blocks} == {
            f"EPOCH_{e}_BLOCK_{b}" for e in range(EPOCHS) for b in range(5)}
        (summary,) = [m for m in lines if m.startswith("krr_fit:")]
        assert "kernel_gen=" in summary and "block_solve=" in summary
        assert f"/{5 * EPOCHS}x" in summary
        fused = _t_est(block_permuter=5).fit(TDataset(_t(X)), TDataset(_t(Y)))
        np.testing.assert_allclose(_weights(model), _weights(fused), atol=2e-4)

    def test_against_the_reference_stepwise(self):
        X, Y = _problem(seed=12)
        want = _weights(_j_est(profile=True).fit(JDataset.of(X), JDataset.of(Y)))
        got = _weights(_t_est(profile=True).fit(TDataset(_t(X)), TDataset(_t(Y))))
        assert _rel(got, want) < 1e-4

    def test_profile_and_checkpoint_conflict(self):
        with pytest.raises(ValueError, match="pick one"):
            _t_est(checkpoint_path="/tmp/x", profile=True)


def _xor(n=400, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
    y = ((X[:, 0] > 0) ^ (X[:, 1] > 0)).astype(int)
    Y = (2.0 * np.eye(2)[y] - 1.0).astype(np.float32)
    return X, y, Y


def _kernel(kd, X):
    return tkernel.GaussianKernelGenerator(0.05, kernel_dtype=kd).fit(
        TDataset(_t(X))).column_block(0, X.shape[0]).numpy()


def _fit_preds(kd, X, Y, lam=1e-3, gamma=5.0, mesh=None):
    data, labels = TDataset(_t(X)), TDataset(_t(Y))
    if mesh is not None:
        data, labels = data.shard(mesh), labels.shard(mesh)
    m = _t_est(gamma=gamma, lam=lam, bs=128, epochs=2, kernel_dtype=kd).fit(data, labels)
    return m.batch_apply(data).to_numpy()


class TestBf16x3:
    def test_bf16x3_block_matches_f32_tightly(self):
        X = np.random.default_rng(1).normal(size=(256, 64)).astype(np.float32)
        err = np.abs(_kernel("bf16x3", X) - _kernel("f32", X)).max()
        assert err < 1e-3, err
        want = np.asarray(jkernel.GaussianKernelGenerator(0.05, kernel_dtype="bf16x3").fit(
            JDataset.of(X)).column_block(0, 256))
        assert np.abs(_kernel("bf16x3", X) - want).max() < 1e-4

    def test_bf16x3_cross_term_is_three_bf16_products(self):
        X = torch.from_numpy(np.random.default_rng(2).normal(size=(9, 5)).astype(np.float32))
        hi, lo = tkernel._bf16_parts(X)
        assert hi.dtype == lo.dtype == torch.bfloat16
        assert (hi.float() + lo.float() - X).abs().max() <= 2.0 ** -16 * X.abs().max()
        xn = (X * X).sum(1)
        got = tkernel.gaussian_block_bf16x3(X, X, xn, xn, 0.3)
        dot = hi.double() @ hi.double().T + hi.double() @ lo.double().T \
            + lo.double() @ hi.double().T
        want = torch.exp(-0.3 * torch.clamp_min(xn.double()[:, None] + xn.double()[None, :]
                                                - 2 * dot, 0.0))
        assert got.dtype == torch.float32
        torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-6)

    def test_bf16x3_fit_tracks_f32(self):
        """The reference's contract at its own λ = 1e-3: accuracy within a
        point of f32's. Its predictions sit 2.8% of their scale from f32's
        there, not within the reference test's 1%: XLA's CPU backend
        computes Precision.HIGH in float32, so that test never runs a
        3-pass product. The 3-pass entries sit 1.2e-4 from float64's on
        these rows (γ = 5, |x|² ≤ 2: about 2⁻¹⁶ of γ·2x·y), and K + 1e-3·I
        magnifies them; at λ = 0.1 the 1% holds (measured 1.7e-4)."""
        X, y, Y = _xor()
        p32 = _fit_preds("f32", X, Y)
        p3 = _fit_preds("bf16x3", X, Y)
        acc32 = (np.argmax(p32, 1) == y).mean()
        acc3 = (np.argmax(p3, 1) == y).mean()
        assert acc32 >= 0.95, acc32
        assert abs(acc3 - acc32) <= 0.01, (acc3, acc32)
        assert np.abs(p3 - p32).max() / np.abs(p32).max() < 0.05
        p32, p3 = _fit_preds("f32", X, Y, lam=0.1), _fit_preds("bf16x3", X, Y, lam=0.1)
        assert np.abs(p3 - p32).max() / np.abs(p32).max() < 0.01

    def test_bf16x3_fit_against_the_reference(self):
        # The reference's bf16x3 on its CPU is its float32 fit (see above),
        # so the port's 3-pass fit is held to it where the 1% holds.
        X, y, Y = _xor(seed=3)
        jm = _j_est(gamma=5.0, lam=0.1, bs=128, kernel_dtype="bf16x3").fit(
            JDataset.of(jnp.asarray(X)), JDataset.of(jnp.asarray(Y)))
        want = np.asarray(jm.batch_apply(JDataset.of(jnp.asarray(X))).array)
        got = _fit_preds("bf16x3", X, Y, lam=0.1)
        assert np.abs(got - want).max() / np.abs(want).max() < 0.01

    def test_bf16x3_on_a_mesh_and_stepwise(self, tm):
        X, y, Y = _xor(n=300, seed=4)
        data, labels = TDataset(_t(X)), TDataset(_t(Y))

        def est(**kw):
            return _t_est(gamma=5.0, lam=0.1, bs=128, kernel_dtype="bf16x3", **kw)

        fused = _weights(est().fit(data, labels))
        mesh = _weights(est().fit(data.shard(tm), labels.shard(tm)))
        assert _rel(mesh, fused) < 1e-4
        np.testing.assert_allclose(_weights(est(profile=True).fit(data, labels)), fused,
                                   atol=2e-4)

    def test_bf16x3_never_launches_the_kernels(self, monkeypatch):
        monkeypatch.setattr(cuda_ops, "gaussian_kernel_block", None)
        monkeypatch.setattr(cuda_ops, "gaussian_resid_block", None)
        X, y, Y = _xor(n=200, seed=5)
        _fit_preds("bf16x3", X, Y, lam=0.1)

    def test_invalid_dtype_rejected(self):
        with pytest.raises(ValueError, match="kernel_dtype"):
            tkernel.GaussianKernelGenerator(0.1, kernel_dtype="fp8")
