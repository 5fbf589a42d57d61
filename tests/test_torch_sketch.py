"""The port's sketched least-squares tier against the JAX package, on the
CPU: the padded-FFT helpers, the CountSketch kernel's plain version, the
SRHT and Iterative Hessian Sketch fits (sparse, compressed and dense), the
dense sketch-and-solve estimator, the local solver, the guard, seeds, the
cost model, and the block update's ``sym=False`` route through
``gram_corr``'s plain version.

Inputs come from seeded numpy generators and are float32 on both sides
(tests/conftest.py turns on x64). The reference draws its signs, bins and
buckets from ``jax.random``; the parity tests make the same draws with the
reference's own key derivation (``key``, ``fold_in``, ``split``) and hand
them to the port through its ``draws=`` injection point
(``interop.numpy_draws``), so both packages fit on the same sketch.

Tolerances and why:
  - the stats helpers: 1e-5 of the output's scale (float32 FFTs of
    different libraries);
  - ``countsketch_scatter_ref`` against the Pallas kernel in interpret
    mode: the reference test's own ``rtol=1e-5`` (the kernel sums in tiled
    matrix-unit order); against a sequential float32 loop: bit for bit;
  - fits against the reference on the same draws: 1e-4 relative Frobenius
    (float32 sums, QR and Cholesky in other orders);
  - fits against the exact ridge solution: the reference tests' own
    tolerances (tests/test_sketch.py);
  - the local solver: 1e-6 relative (both float64 LAPACK, the port's model
    then float32);
  - ``gram_corr_ref`` and the ``sym=False`` block update against the
    reference's interpret-mode ``gram_corr``: 1e-5 relative.
"""

import logging
import re

import numpy as np
import pytest
import torch

from keystone_tpu_torch import interop
from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.ops import cuda_ops
from keystone_tpu_torch.ops import stats as tstats
from keystone_tpu_torch.ops.learning import linear as tlin
from keystone_tpu_torch.ops.learning import sketch as tsk
from keystone_tpu_torch.parallel import linalg as tlinalg

import jax
import jax.numpy as jnp

from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.data import one_hot_pm1
from keystone_tpu.ops import pallas_ops as po
from keystone_tpu.ops import stats as jstats
from keystone_tpu.ops.learning import linear as jlin
from keystone_tpu.ops.learning import sketch as jsk
from keystone_tpu.parallel import linalg as jlinalg

N, D, NNZ, K = 400, 12, 5, 2
LAM = 1e-2


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _problem(seed=3, n=N, d=D, nnz=NNZ, k=K, lam=LAM):
    """tests/test_sketch.py's problem: sorted uniform indices (duplicates in
    a row add), normal values, ±1 one-hot labels, the exact ridge solution
    with the intercept from float64 normal equations."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(n, nnz)).astype(np.int32)
    idx.sort(axis=1)
    vals = rng.normal(size=(n, nnz)).astype(np.float32)
    Y = one_hot_pm1(rng.integers(0, k, size=n), k).astype(np.float32)
    A = np.zeros((n, d), np.float64)
    for r in range(n):
        for j in range(nnz):
            A[r, idx[r, j]] += vals[r, j]
    A1 = np.concatenate([A, np.ones((n, 1))], axis=1)
    W_ref = np.linalg.solve(A1.T @ A1 / n + lam * np.eye(d + 1), A1.T @ Y / n)
    return idx, vals, A, Y, W_ref


def _sparse(idx, vals, Y, n=N):
    return (
        TDataset({"indices": _t(idx), "values": _t(vals)}, n=n), TDataset(_t(Y)),
        JDataset({"indices": jnp.asarray(idx), "values": jnp.asarray(vals)}, n=n),
        JDataset.of(jnp.asarray(Y)),
    )


def _dense(A, Y):
    A32 = A.astype(np.float32)
    return (TDataset(_t(A32)), TDataset(_t(Y)), JDataset.of(jnp.asarray(A32)),
            JDataset.of(jnp.asarray(Y)))


def _w1(model):
    x, b = model.x, model.b_opt
    if isinstance(x, torch.Tensor):
        return torch.cat([x, b[None]]).double().numpy()
    return np.concatenate([np.asarray(x), np.asarray(b)[None]], axis=0).astype(np.float64)


# ---------------------------------------------------------------------------
# The reference's draws, by its own key derivation
# ---------------------------------------------------------------------------


def srht_draws(seed, c, m_pc, half):
    """sketch.py:211-220: fold_in(key, cid), split into (ks, kb)."""
    key = jax.random.key(seed)

    def fn(cid):
        ks, kb = jax.random.split(jax.random.fold_in(key, cid))
        return (np.asarray(jax.random.rademacher(ks, (c,), dtype=jnp.float32)),
                np.asarray(jax.random.randint(kb, (m_pc,), 0, half)))

    return interop.numpy_draws(fn)


def ihs_sparse_draws(seed, c, m):
    """sketch.py:453-456: fold_in(fold_in(key, t), cid), split."""
    key = jax.random.key(seed)

    def fn(t, cid):
        ks, kb = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, t), cid))
        return (np.asarray(jax.random.randint(kb, (c,), 0, m)),
                np.asarray(jax.random.rademacher(ks, (c,), dtype=jnp.float32)))

    return interop.numpy_draws(fn)


def ihs_dense_draws(seed, rows, m):
    """sketch.py:520-523: fold_in(key, t), split."""
    key = jax.random.key(seed)

    def fn(t):
        ks, kb = jax.random.split(jax.random.fold_in(key, t))
        return (np.asarray(jax.random.randint(kb, (rows,), 0, m)),
                np.asarray(jax.random.rademacher(ks, (rows,), dtype=jnp.float32)))

    return interop.numpy_draws(fn)


def estimator_draws(seed, rows, m):
    """linear.py:245-248: split(key) into (kb, ks)."""
    kb, ks = jax.random.split(jax.random.key(seed))
    return interop.numpy_draws(lambda: (
        np.asarray(jax.random.randint(kb, (rows,), 0, m)),
        np.asarray(jax.random.rademacher(ks, (rows,), dtype=jnp.float32)),
    ))


def _srht_geometry(rows, chunk_rows, m):
    c = min(chunk_rows, rows)
    nchunks = -(-rows // c)
    p = tstats.padded_pow2(c)
    return c, max(1, min(-(-m // nchunks), p // 2)), p // 2


# ---------------------------------------------------------------------------
# Padded real FFT helpers
# ---------------------------------------------------------------------------


class TestStatsHelpers:
    @pytest.mark.parametrize("n", [1, 2, 3, 8, 9, 100, 1024, 1025])
    def test_padded_pow2(self, n):
        assert tstats.padded_pow2(n) == jstats.padded_pow2(n)

    @pytest.mark.parametrize("shape,dim", [((16, 5), 0), ((3, 32), -1), ((64, 7), 0)])
    def test_rfft_real_half(self, shape, dim):
        x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
        p = x.shape[dim]
        got = tstats.rfft_real_half(_t(x), p, dim=dim)
        want = np.asarray(jstats.rfft_real_half(jnp.asarray(x), p, axis=dim))
        assert tuple(got.shape) == want.shape
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(x).sum(axis=dim).max()

    @pytest.mark.parametrize("c", [100, 128, 37])
    def test_srht_chunk_sketch(self, c):
        rng = np.random.default_rng(c)
        dense = rng.normal(size=(c, 9)).astype(np.float32)
        signs = rng.choice([-1.0, 1.0], size=c).astype(np.float32)
        half = tstats.padded_pow2(c) // 2
        bins = rng.integers(0, half, size=11)
        got = tstats.srht_chunk_sketch(_t(dense), _t(signs), _t(bins), 0.3)
        want = np.asarray(jstats.srht_chunk_sketch(
            jnp.asarray(dense), jnp.asarray(signs), jnp.asarray(bins), 0.3))
        assert got.dtype == torch.float32 and tuple(got.shape) == (11, 9)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * 0.3 * np.abs(dense).sum(0).max()


# ---------------------------------------------------------------------------
# The CountSketch kernel's plain version
# ---------------------------------------------------------------------------


def _cs_chunk(c, s, m, d1, seed, duplicate_cols=False):
    """tests/test_pallas_ops.py's chunk maker: masked ragged tails of slots."""
    r = np.random.default_rng(seed)
    idx = r.integers(0, d1, size=(c, s)).astype(np.int32)
    if duplicate_cols:
        idx[:, 1::2] = idx[:, ::2][:, : idx[:, 1::2].shape[1]]
    val = r.normal(size=(c, s)).astype(np.float32)
    drop = r.random(size=(c, s)) < 0.3
    idx = np.where(drop, -1, idx)
    val = np.where(drop, 0.0, val).astype(np.float32)
    bucket = r.integers(0, m, size=(c,)).astype(np.int32)
    sign = r.choice([-1.0, 1.0], size=(c,)).astype(np.float32)
    return idx, val, bucket, sign


def _sequential(idx, val, bucket, sign, m, d1, out=None):
    """A float32 loop adding lane after lane in (row, slot) order."""
    SA = np.zeros((m, d1), np.float32) if out is None else out.copy()
    for i in range(idx.shape[0]):
        if not 0 <= bucket[i] < m:
            continue
        for t in range(idx.shape[1]):
            j = idx[i, t]
            if 0 <= j < d1:
                SA[bucket[i], j] = np.float32(SA[bucket[i], j] + np.float32(sign[i] * val[i, t]))
    return SA


class TestCountSketchPlainVersion:
    @pytest.mark.parametrize("case", ["plain", "duplicate columns", "multi tile"])
    def test_against_the_pallas_kernel(self, case):
        c, s, m, d1, seed, dup = {
            "plain": (50, 4, 13, 37, 0, False),
            "duplicate columns": (24, 6, 7, 19, 1, True),
            "multi tile": (300, 3, 600, 300, 2, False),
        }[case]
        idx, val, bucket, sign = _cs_chunk(c, s, m, d1, seed, dup)
        got = cuda_ops.countsketch_scatter_ref(_t(idx), _t(val), _t(bucket), _t(sign), m, d1)
        want = np.asarray(po.countsketch_scatter(idx, val, bucket, sign, m, d1, interpret=True))
        assert tuple(got.shape) == (m, d1) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    def test_fold_composition_over_four_chunks(self):
        m, d1 = 11, 23
        acc = torch.zeros((m, d1))
        want = np.zeros((m, d1), np.float32)
        for i in range(4):
            idx, val, bucket, sign = _cs_chunk(16, 3, m, d1, seed=10 + i)
            cuda_ops.countsketch_scatter(_t(idx), _t(val), _t(bucket), _t(sign), m, d1, out=acc)
            want += np.asarray(po.countsketch_scatter(idx, val, bucket, sign, m, d1,
                                                      interpret=True))
        np.testing.assert_allclose(acc.numpy(), want, rtol=1e-5, atol=1e-5)

    def test_adds_in_row_then_slot_order(self):
        """The plain version on the CPU has the bits of a sequential loop in
        (row, slot) order — the order the card kernel adds in."""
        m, d1 = 5, 9
        idx, val, bucket, sign = _cs_chunk(400, 7, m, d1, seed=4, duplicate_cols=True)
        bucket[::13] = m + 2  # out-of-range buckets add nothing
        idx[3, 2] = d1 + 5  # and so do out-of-range columns
        out0 = np.random.default_rng(5).normal(size=(m, d1)).astype(np.float32)
        got = cuda_ops.countsketch_scatter(_t(idx), _t(val), _t(bucket), _t(sign), m, d1,
                                           out=_t(out0.copy()))
        assert np.array_equal(got.numpy(), _sequential(idx, val, bucket, sign, m, d1, out0))

    def test_cpu_wrapper_takes_the_plain_version_in_place(self):
        m, d1 = 7, 11
        idx, val, bucket, sign = (_t(a) for a in _cs_chunk(30, 4, m, d1, seed=6))
        before = dict(cuda_ops.launches)
        fresh = cuda_ops.countsketch_scatter(idx, val, bucket, sign, m, d1)
        acc = torch.zeros((m, d1))
        out = cuda_ops.countsketch_scatter(idx, val, bucket, sign, m, d1, out=acc)
        assert out is acc and torch.equal(acc, fresh)
        assert cuda_ops.launches == before

    def test_order_groups_rows_by_bucket_stably(self):
        bucket = torch.tensor([2, 0, 2, 5, 1, 0, -1, 2], dtype=torch.int32)
        order, starts = cuda_ops.countsketch_order(bucket, 3)
        assert order.dtype == torch.int32 and starts.dtype == torch.int32
        assert order[: int(starts[3])].tolist() == [1, 5, 4, 0, 2, 7]
        assert starts.tolist() == [0, 2, 3, 6]

    def test_non_cpu_non_cuda_tensors_raise(self):
        def meta(*shape, dtype=torch.float32):
            return torch.empty(shape, device="meta", dtype=dtype)

        with pytest.raises(ValueError, match="CUDA"):
            cuda_ops.countsketch_scatter(meta(4, 2, dtype=torch.int32), meta(4, 2),
                                         meta(4, dtype=torch.int32), meta(4), 3, 5)


# ---------------------------------------------------------------------------
# SketchedLeastSquares (SRHT)
# ---------------------------------------------------------------------------


class TestSketchedLeastSquares:
    KW = dict(lam=LAM, sketch_factor=4, pcg_iters=40, chunk_rows=128, seed=0)

    def _pair(self, rows, dense=False, **kw):
        kw = {**self.KW, **kw}
        m = kw["sketch_factor"] * (D + 1)
        draws = srht_draws(kw["seed"], *_srht_geometry(rows, kw["chunk_rows"], m))
        extra = {} if dense else {"num_features": D}
        return tsk.SketchedLeastSquares(draws=draws, **kw, **extra), jsk.SketchedLeastSquares(
            **kw, **extra)

    def test_sparse_matches_reference_on_its_draws(self):
        idx, vals, _, Y, W_ref = _problem()
        tdata, tlab, jdata, jlab = _sparse(idx, vals, Y)
        port, ref = self._pair(N)
        got, want = port.fit(tdata, tlab), ref.fit(jdata, jlab)
        assert isinstance(got, tlin.SparseLinearMapper)
        assert _rel(_w1(got), _w1(want)) <= 1e-4
        np.testing.assert_allclose(_w1(got), W_ref, atol=1e-4)

    def test_dense_matches_reference_on_its_draws(self):
        _, _, A, Y, W_ref = _problem()
        tdata, tlab, jdata, jlab = _dense(A, Y)
        port, ref = self._pair(N, dense=True)
        got, want = port.fit(tdata, tlab), ref.fit(jdata, jlab)
        assert isinstance(got, tlin.LinearMapper)
        assert _rel(_w1(got), _w1(want)) <= 1e-4
        np.testing.assert_allclose(_w1(got), W_ref, atol=1e-4)

    def test_few_iterations_follow_the_reference(self):
        """At 4 PCG iterations the fit is far from converged: agreement then
        shows the same sketch, preconditioner and iterates, not just the
        same optimum."""
        idx, vals, _, Y, W_ref = _problem(seed=5)
        tdata, tlab, jdata, jlab = _sparse(idx, vals, Y)
        port, ref = self._pair(N, pcg_iters=2, sketch_factor=2)
        got, want = _w1(port.fit(tdata, tlab)), _w1(ref.fit(jdata, jlab))
        assert _rel(got, W_ref) > 1e-3
        assert _rel(got, want) <= 1e-4

    def test_own_draws_match_exact_ridge_and_reproduce_bitwise(self):
        idx, vals, A, Y, W_ref = _problem()
        tdata, tlab, *_ = _sparse(idx, vals, Y)
        kw = dict(self.KW, num_features=D, seed=11)
        m1 = tsk.SketchedLeastSquares(**kw).fit(tdata, tlab)
        m2 = tsk.SketchedLeastSquares(**kw).fit(tdata, tlab)
        np.testing.assert_allclose(_w1(m1), W_ref, atol=1e-4)
        assert torch.equal(m1.x, m2.x) and torch.equal(m1.b_opt, m2.b_opt)
        dense = tsk.SketchedLeastSquares(**self.KW).fit(*_dense(A, Y)[:2])
        np.testing.assert_allclose(_w1(dense), _w1(m1), atol=2e-4)


# ---------------------------------------------------------------------------
# IterativeHessianSketch
# ---------------------------------------------------------------------------


class TestIterativeHessianSketch:
    KW = dict(lam=LAM, sketch_factor=8, outer_iters=8, chunk_rows=128, seed=0)

    def _sparse_pair(self, rows=N, **kw):
        kw = {**self.KW, **kw}
        m = kw.get("sketch_size") or kw["sketch_factor"] * (D + 1)
        draws = ihs_sparse_draws(kw["seed"], min(kw["chunk_rows"], rows), m)
        return (tsk.IterativeHessianSketch(num_features=D, draws=draws, **kw),
                jsk.IterativeHessianSketch(num_features=D, **kw))

    @pytest.mark.parametrize("compress", [None, "int16_bf16"])
    def test_sparse_matches_reference_on_its_draws(self, compress):
        idx, vals, _, Y, W_ref = _problem()
        tdata, tlab, jdata, jlab = _sparse(idx, vals, Y)
        port, ref = self._sparse_pair(compress=compress)
        got, want = port.fit(tdata, tlab), ref.fit(jdata, jlab)
        assert isinstance(got, tlin.SparseLinearMapper)
        assert _rel(_w1(got), _w1(want)) <= 1e-4
        np.testing.assert_allclose(_w1(got), W_ref, atol=5e-3 if compress is None else 1e-2)

    def test_dense_matches_reference_on_its_draws(self):
        _, _, A, Y, W_ref = _problem()
        tdata, tlab, jdata, jlab = _dense(A, Y)
        kw = dict(lam=LAM, sketch_factor=8, outer_iters=8, seed=0)
        port = tsk.IterativeHessianSketch(draws=ihs_dense_draws(0, N, 8 * (D + 1)), **kw)
        got, want = port.fit(tdata, tlab), jsk.IterativeHessianSketch(**kw).fit(jdata, jlab)
        assert isinstance(got, tlin.LinearMapper)
        assert _rel(_w1(got), _w1(want)) <= 1e-4
        np.testing.assert_allclose(_w1(got), W_ref, atol=5e-3)

    def test_ragged_chunks_and_padding_rows(self):
        """Chunks of 96 over 400 rows (a ragged last chunk) and a dataset
        whose last 30 rows are padding."""
        idx, vals, _, Y, _ = _problem(seed=8)
        idx[-30:], vals[-30:], Y[-30:] = -1, 0.0, 0.0
        tdata, tlab, jdata, jlab = _sparse(idx, vals, Y, n=N - 30)
        port, ref = self._sparse_pair(chunk_rows=96, outer_iters=3, sketch_factor=4)
        assert _rel(_w1(port.fit(tdata, tlab)), _w1(ref.fit(jdata, jlab))) <= 1e-4

    def test_own_draws_converge_and_reproduce_bitwise(self):
        idx, vals, A, Y, W_ref = _problem()
        tdata, tlab, *_ = _sparse(idx, vals, Y)
        kw = dict(self.KW, num_features=D)
        m1 = tsk.IterativeHessianSketch(**kw).fit(tdata, tlab)
        np.testing.assert_allclose(_w1(m1), W_ref, atol=5e-3)
        kw3 = dict(kw, outer_iters=3, seed=11)
        a = tsk.IterativeHessianSketch(**kw3).fit(tdata, tlab)
        b = tsk.IterativeHessianSketch(**kw3).fit(tdata, tlab)
        assert torch.equal(a.x, b.x) and torch.equal(a.b_opt, b.b_opt)
        comp = tsk.IterativeHessianSketch(compress="int16_bf16", **kw).fit(tdata, tlab)
        np.testing.assert_allclose(_w1(comp), W_ref, atol=1e-2)
        dense = tsk.IterativeHessianSketch(lam=LAM, sketch_factor=8, outer_iters=8).fit(
            *_dense(A, Y)[:2])
        np.testing.assert_allclose(_w1(dense), W_ref, atol=5e-3)

    @pytest.mark.parametrize("sketch_size,seed", [(4, 0), (4, 1), (20, 1), (32, 0)])
    def test_guard_rolls_back_where_the_reference_does(self, sketch_size, seed, caplog):
        """Sketches of 4 rows (below d₁ = 13) and of 20 and 32 (a little above
        it, far below the default 4·d₁): the guard rolls back
        the step that raised the gradient norm at the same outer iteration
        as the reference's (the first cases at outer 1, to the zero model;
        the last two at outer 2, to the first step), and the fit reports its
        passes."""
        idx, vals, _, Y, W_ref = _problem()
        tdata, tlab, jdata, jlab = _sparse(idx, vals, Y)
        port, ref = self._sparse_pair(sketch_size=sketch_size, outer_iters=6, seed=seed)
        with caplog.at_level(logging.INFO, logger="keystone_tpu.sketch"):
            want = ref.fit(jdata, jlab)
        outer = [int(re.search(r"at outer (\d+)", r.getMessage()).group(1))
                 for r in caplog.records if r.name == "keystone_tpu.sketch"]
        got = port.fit(tdata, tlab)
        assert port.passes == (outer[0] + 1 if outer else 6)
        assert port.steps == (outer[0] - 1 if outer else 6)
        if port.steps == 0:
            assert not got.x.any() and not got.b_opt.any()  # rolled back to the zero model
        assert _rel(_w1(got), _w1(want)) <= 1e-4
        W1 = _w1(got)
        assert np.all(np.isfinite(W1))
        assert np.linalg.norm(W1 - W_ref) <= np.linalg.norm(W_ref) + 1e-6

    def test_rollback_at_a_quarter_of_the_amazon_geometry(self, caplog):
        """chip_smoke.py's Amazon rows cut to a quarter (n 125,000, d 4,096,
        20 active a row, planted labels, λ 1e-3) at m = 2(d+1), seed 7: the
        first Newton step raises the exact gradient norm in the reference
        (it logs both norms) and in the port on its draws, and both return
        the zero model after two passes."""
        n, d, nnz, m = 125_000, 4096, 20, 2 * 4097
        rng = np.random.default_rng(2)
        w_true = (rng.normal(size=d) * (rng.random(d) < 0.05)).astype(np.float32)
        rng = np.random.default_rng(1)
        idx = np.sort(rng.integers(0, d, size=(n, nnz)).astype(np.int32), axis=1)
        vals = rng.normal(size=(n, nnz)).astype(np.float32)
        score = (vals * w_true[idx]).sum(axis=1) + 0.5 * rng.normal(size=n).astype(np.float32)
        Y = 2.0 * np.eye(2, dtype=np.float32)[(score > 0).astype(np.int64)] - 1.0
        tdata, tlab, jdata, jlab = _sparse(idx, vals, Y, n=n)
        kw = dict(lam=1e-3, sketch_size=m, outer_iters=3, seed=7, num_features=d,
                  chunk_rows=16_384)
        port = tsk.IterativeHessianSketch(draws=ihs_sparse_draws(7, 16_384, m), **kw)
        with caplog.at_level(logging.INFO, logger="keystone_tpu.sketch"):
            want = jsk.IterativeHessianSketch(**kw).fit(jdata, jlab)
        guard = [r.getMessage() for r in caplog.records if "IHS guard" in r.getMessage()]
        assert len(guard) == 1 and "at outer 1" in guard[0]
        got = port.fit(tdata, tlab)
        assert port.passes == 2 and port.steps == 0
        assert not got.x.any() and not got.b_opt.any() and not np.asarray(want.x).any()

    def test_one_kernel_call_per_chunk_and_pass(self, monkeypatch):
        calls = []
        real = cuda_ops.countsketch_scatter

        def counting(*args, **kw):
            calls.append(kw.get("out") is not None)
            return real(*args, **kw)

        monkeypatch.setattr(cuda_ops, "countsketch_scatter", counting)
        idx, vals, _, Y, _ = _problem()
        est = tsk.IterativeHessianSketch(lam=LAM, sketch_factor=8, outer_iters=3,
                                         chunk_rows=96, num_features=D)
        est.fit(*_sparse(idx, vals, Y)[:2])
        assert est.passes == est.steps == 3 and len(calls) == 5 * 3 and all(calls)

    def test_rejects_unknown_compress(self):
        with pytest.raises(ValueError, match="int16_bf16"):
            tsk.IterativeHessianSketch(compress="zstd")

    def test_port_draws_depend_on_seed_and_step_only(self):
        a = tsk.bucket_sign_draws(3, (1, 2), 50, 7)
        b = tsk.bucket_sign_draws(3, (1, 2), 50, 7)
        c = tsk.bucket_sign_draws(3, (2, 1), 50, 7)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert not torch.equal(a[0], c[0])
        assert int(a[0].min()) >= 0 and int(a[0].max()) < 7
        assert set(a[1].tolist()) <= {-1.0, 1.0}


# ---------------------------------------------------------------------------
# The estimators of linear.py
# ---------------------------------------------------------------------------


class TestLinearEstimators:
    def _dense_problem(self, n=300, d=10, k=3, seed=2):
        rng = np.random.default_rng(seed)
        A = rng.normal(size=(n, d)).astype(np.float32) + 0.5
        W = rng.normal(size=(d, k))
        B = (A @ W + 0.1 * rng.normal(size=(n, k)) + 2.0).astype(np.float32)
        return A, B

    @pytest.mark.parametrize("lam,refine", [(0.0, 2), (1e-1, 0), (1e-2, 4)])
    def test_sketched_estimator_matches_reference(self, lam, refine):
        A, B = self._dense_problem()
        n, d = A.shape
        m = min(max(8 * d, d + 1), max(n, d + 1))
        port = tlin.SketchedLeastSquaresEstimator(lam=lam, refine_iters=refine, seed=4,
                                                  draws=estimator_draws(4, n, m))
        ref = jlin.SketchedLeastSquaresEstimator(lam=lam, refine_iters=refine, seed=4)
        got = port.fit(TDataset(_t(A)), TDataset(_t(B)))
        want = ref.fit(JDataset.of(jnp.asarray(A)), JDataset.of(jnp.asarray(B)))
        assert _rel(got.x, want.x) <= 1e-4 and _rel(got.b_opt, want.b_opt) <= 1e-4
        assert _rel(got.feature_scaler.mean, want.feature_scaler.mean) <= 1e-6
        X = A[:7]
        assert _rel(got.apply(_t(X)), want.apply(jnp.asarray(X))) <= 1e-4

    def test_sketched_estimator_own_draws_refine_and_reproduce(self):
        """With the port's own draws: the same seed gives the same bits, one
        refinement step shrinks the exact gradient norm of the sketched
        solve, and the fit lands within 5% of the exact least-squares model.
        (As in the reference, the guard tests the norm before each step, so
        the last step taken is kept even where it raised the norm: on this
        problem the second step does, and the fit stops there.)"""
        A, B = self._dense_problem()
        exact = tlin.LocalLeastSquaresEstimator(lam=0.0).fit(TDataset(_t(A)), TDataset(_t(B)))

        def fit(refine):
            return tlin.SketchedLeastSquaresEstimator(refine_iters=refine, seed=9).fit(
                TDataset(_t(A)), TDataset(_t(B)))

        def gnorm(model):
            Ac, Bc = A - A.mean(0), B - B.mean(0)
            x = model.x.double().numpy()
            return np.linalg.norm(Ac.T @ (Ac @ x - Bc))

        a, b, plain = fit(6), fit(6), fit(0)
        assert torch.equal(a.x, b.x)
        assert gnorm(fit(1)) < gnorm(plain) < gnorm(a)
        assert torch.equal(fit(2).x, a.x)
        assert _rel(a.x, exact.x.double().numpy()) <= 0.05

    @pytest.mark.parametrize("lam", [0.0, 0.5])
    def test_local_estimator_matches_reference(self, lam):
        A, B = self._dense_problem(seed=7)
        got = tlin.LocalLeastSquaresEstimator(lam=lam).fit(TDataset(_t(A)), TDataset(_t(B)))
        want = jlin.LocalLeastSquaresEstimator(lam=lam).fit(
            JDataset.of(jnp.asarray(A)), JDataset.of(jnp.asarray(B)))
        assert got.x.dtype == torch.float32 and got.x.device == torch.device("cpu")
        assert _rel(got.x, want.x) <= 1e-6 and _rel(got.b_opt, want.b_opt) <= 1e-6
        assert _rel(got.feature_scaler.mean, want.feature_scaler.mean) <= 1e-6

    def test_learning_package_exports_the_estimators(self):
        from keystone_tpu_torch.ops import learning

        for name in ("SketchedLeastSquares", "IterativeHessianSketch",
                     "SketchedLeastSquaresEstimator", "LocalLeastSquaresEstimator"):
            assert name in learning.__all__ and hasattr(learning, name)


# ---------------------------------------------------------------------------
# cost and resident_bytes under the EC2 weights
# ---------------------------------------------------------------------------


GEOMETRIES = [
    dict(n=500_000, d=16_384, k=2, sparsity=82 / 16_384, num_machines=1),  # Amazon row
    dict(n=2_000, d=100, k=3, sparsity=0.1, num_machines=4),
    dict(n=10**7, d=40_000, k=10, sparsity=1e-3, num_machines=8),
]
WEIGHTS = dict(cpu_weight=3.8e-4, mem_weight=2.9e-1, network_weight=1.32)


class TestCostModel:
    @pytest.fixture(autouse=True)
    def ec2(self, monkeypatch):
        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", "ec2")

    @pytest.mark.parametrize("geometry", GEOMETRIES, ids=["amazon", "small", "wide"])
    @pytest.mark.parametrize("engine", ["srht", "ihs", "ihs compressed", "estimator"])
    def test_equal_to_the_reference(self, engine, geometry):
        kw = {
            "srht": dict(lam=1e-3, sketch_size=32_770, pcg_iters=12),
            "ihs": dict(lam=1e-3, sketch_factor=4, outer_iters=3),
            "ihs compressed": dict(lam=1e-3, compress="int16_bf16"),
            "estimator": dict(lam=1e-3, refine_iters=2),
        }[engine]
        port, ref = {
            "srht": (tsk.SketchedLeastSquares, jsk.SketchedLeastSquares),
            "ihs": (tsk.IterativeHessianSketch, jsk.IterativeHessianSketch),
            "ihs compressed": (tsk.IterativeHessianSketch, jsk.IterativeHessianSketch),
            "estimator": (tlin.SketchedLeastSquaresEstimator,
                          jlin.SketchedLeastSquaresEstimator),
        }[engine]
        p, r = port(**kw), ref(**kw)
        assert p.cost(**geometry, **WEIGHTS) == pytest.approx(r.cost(**geometry, **WEIGHTS),
                                                              rel=1e-12)
        res = {key: v for key, v in geometry.items()}
        assert p.resident_bytes(**res) == r.resident_bytes(**res)

    def test_private_overheads_are_the_ec2_constants(self):
        from keystone_tpu.ops.learning import cost as jcost

        assert tsk.SketchedLeastSquares()._sketch_overhead == jcost.EC2_SRHT_SKETCH_OVERHEAD
        assert tsk.IterativeHessianSketch()._cs_overhead == jcost.EC2_COUNTSKETCH_OVERHEAD
        assert tsk.SketchedLeastSquares()._gather_overhead == jcost.EC2_SPARSE_GATHER_OVERHEAD
        assert tsk.IterativeHessianSketch()._gather_overhead == jcost.EC2_SPARSE_GATHER_OVERHEAD
        assert tsk.IterativeHessianSketch().weight == jsk.IterativeHessianSketch().weight


# ---------------------------------------------------------------------------
# gram_corr and the sym switch of the block update
# ---------------------------------------------------------------------------


class TestGramCorr:
    @pytest.mark.parametrize("shape", [(90, 70, 11), (64, 700, 5), (33, 130, 1)])
    def test_plain_version_against_the_pallas_kernel(self, shape):
        n, d, k = shape
        rng = np.random.default_rng(d)
        A = rng.normal(size=(n, d)).astype(np.float32)
        R = rng.normal(size=(n, k)).astype(np.float32)
        gram, corr = cuda_ops.gram_corr(_t(A), _t(R))
        g_ref, c_ref = po.gram_corr(A, R, interpret=True)
        assert _rel(gram, g_ref) <= 1e-5 and _rel(corr, c_ref) <= 1e-5
        assert torch.equal(gram, gram.T)

    def test_bf16_a_against_the_pallas_kernel(self):
        rng = np.random.default_rng(1)
        A = rng.normal(size=(40, 20)).astype(np.float32)
        R = rng.normal(size=(40, 3)).astype(np.float32)
        A16 = torch.from_numpy(A).to(torch.bfloat16)
        gram, corr = cuda_ops.gram_corr(A16, _t(R))
        g_ref, _ = po.gram_corr(jnp.asarray(A, dtype=jnp.bfloat16), R, interpret=True)
        assert gram.dtype == torch.float32
        assert _rel(gram, g_ref) <= 1e-5
        assert _rel(corr, A16.float().double().numpy().T @ R) <= 1e-5

    @pytest.mark.parametrize("lam", [0.0, 1e-2])
    def test_block_update_sym_false_against_the_reference(self, lam):
        rng = np.random.default_rng(3)
        n, db, k = 200, 48, 5
        Ab = rng.normal(size=(n, db)).astype(np.float32)
        R = rng.normal(size=(n, k)).astype(np.float32)
        Wb = (0.1 * rng.normal(size=(db, k))).astype(np.float32)
        got = tlinalg._bcd_block_update(_t(Ab), _t(R), _t(Wb), lam, sym=False)
        want = jlinalg._bcd_block_update(jnp.asarray(Ab), jnp.asarray(R), jnp.asarray(Wb),
                                         lam, True, False)
        for g, w in zip(got, want):
            assert _rel(g, w) <= 1e-5
        sym = tlinalg._bcd_block_update(_t(Ab), _t(R), _t(Wb), lam)
        for a, b in zip(got[:2], sym[:2]):
            assert _rel(a, b.double().numpy()) <= 1e-6

    def test_switch_picks_the_kernel(self, monkeypatch):
        seen = []
        for name in ("gram_corr", "gram_corr_sym"):
            real = getattr(cuda_ops, name)
            monkeypatch.setattr(cuda_ops, name,
                                lambda A, R, _n=name, _f=real: seen.append(_n) or _f(A, R))
        Ab, R, Wb = torch.randn(20, 6), torch.randn(20, 2), torch.zeros(6, 2)
        tlinalg._bcd_block_update(Ab, R, Wb, 0.1, sym=False)
        tlinalg._bcd_block_update(Ab, R, Wb, 0.1)
        tlinalg.bcd_least_squares_fused(torch.randn(2, 20, 6), R, lam=0.1)
        assert seen == ["gram_corr", "gram_corr_sym", "gram_corr_sym", "gram_corr_sym"]
