"""The port's ring tier (``parallel/ring.py``) and the mesh collectives it
runs on (``mesh.ppermute`` / ``all_gather`` / ``psum_scatter``) against the
JAX package's ``parallel/ring.py`` on its 8-device CPU mesh
(tests/conftest.py forces 8 host devices). The port's mesh is 8 shards on
the CPU. Twins of tests/test_ring.py and of the ring kernel and attention
cases of tests/test_pallas_mesh.py (the reference on its XLA path).

Inputs come from seeded numpy generators, cast to one dtype for both
sides: float32, or float64 where the reference test runs in x64.

Tolerances (the reference tests' own):
  - ring pairwise kernel: 1e-5 absolute against the dense kernel, 5e-6
    against the reference's ring (the port's plain kernel block and XLA's
    both sum 12 float32 products);
  - ring apply: 1e-4 (test_ring.py), 5e-5 (test_pallas_mesh.py);
  - ring Gramian: 1e-4 absolute (64 float32 rows summed in two orders);
  - float64 kernel and attention: 1e-12 / 1e-10 absolute;
  - bf16 attention: 8e-3 absolute (one bf16 ulp at O(1) outputs) against
    both; and, the port alone, within 0.51 bf16 ulps of float64 attention
    (one final rounding), where a control with bf16 state lands beyond 10.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keystone_tpu.parallel import mesh as jmesh
from keystone_tpu.parallel import ring as jring
from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.ops import cuda_ops
from keystone_tpu_torch.parallel import mesh as tmesh
from keystone_tpu_torch.parallel import ring as tring

CPU8 = ["cpu"] * 8


@pytest.fixture()
def jm():
    m = jmesh.make_mesh((8,), (jmesh.DATA_AXIS,))
    with jmesh.use_mesh(m):
        yield m


@pytest.fixture()
def tm():
    return tmesh.make_mesh((8,), devices=CPU8)


def _np(x):
    if isinstance(x, tmesh.ShardedRows):
        x = x.gather()
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def _dense_gaussian(X, Y, gamma):
    sq = (X ** 2).sum(1)[:, None] + (Y ** 2).sum(1)[None, :] - 2 * X @ Y.T
    return np.exp(-gamma * np.maximum(sq, 0))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


class TestCollectives:
    def test_ppermute_rotates_and_shares_storage_on_one_device(self):
        parts = [torch.full((2, 3), float(i)) for i in range(8)]
        out = tmesh.ppermute(parts, tmesh.ring_perm(8))
        for i in range(8):
            assert torch.equal(out[(i + 1) % 8], parts[i])
            assert out[(i + 1) % 8] is parts[i]  # one device: no copy
        # A shard nobody sends to receives zeros, as in JAX.
        out = tmesh.ppermute(parts, [(0, 1)])
        assert torch.equal(out[1], parts[0]) and torch.equal(out[5], torch.zeros(2, 3))
        with pytest.raises(ValueError, match="receives twice"):
            tmesh.ppermute(parts, [(0, 1), (2, 1)])

    def test_all_gather_once_a_device(self):
        parts = [torch.full((2, 3), float(i)) for i in range(8)]
        out = tmesh.all_gather(parts)
        assert len(out) == 8 and all(o is out[0] for o in out)
        assert torch.equal(out[0], torch.cat(parts))

    def test_psum_scatter_matches_psum_bits(self):
        rng = np.random.default_rng(3)
        parts = [_t(rng.normal(size=(16, 5))) for _ in range(8)]
        stripes = tmesh.psum_scatter(parts)
        assert [tuple(s.shape) for s in stripes] == [(2, 5)] * 8
        assert torch.equal(torch.cat(stripes), tmesh.psum(parts))
        with pytest.raises(ValueError, match="stripes"):
            tmesh.psum_scatter([p[:7] for p in parts])


class TestRingPairwise:
    def test_matches_dense_kernel(self, jm, tm):
        X = np.random.default_rng(7).normal(size=(64, 12)).astype(np.float32)
        K = tring.ring_pairwise_gaussian(tmesh.shard_rows(X, tm), 0.1, mesh=tm)
        np.testing.assert_allclose(_np(K), _dense_gaussian(X, X, 0.1), atol=1e-5)
        want = np.asarray(jring.ring_pairwise_gaussian(jmesh.shard_rows(X, jm), 0.1, mesh=jm))
        np.testing.assert_allclose(_np(K), want, atol=5e-6)

    def test_output_stays_sharded(self, tm):
        X = np.random.default_rng(8).normal(size=(32, 4)).astype(np.float32)
        K = tring.ring_pairwise_gaussian(tmesh.shard_rows(X, tm), 1.0, mesh=tm)
        assert tuple(K.shape) == (32, 32)
        assert K.num_shards == 8 and {tuple(s.shape) for s in K.shards} == {(4, 32)}

    def test_one_kernel_launch_a_shard_a_step(self, tm, monkeypatch):
        calls = []
        real = cuda_ops.gaussian_kernel_block
        monkeypatch.setattr(cuda_ops, "gaussian_kernel_block",
                            lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
        X = np.random.default_rng(9).normal(size=(64, 6)).astype(np.float32)
        tring.ring_pairwise_gaussian(tmesh.shard_rows(X, tm), 0.3, mesh=tm)
        assert calls == [(8, 6)] * 64

    def test_ring_f64_keeps_the_plain_float64_block(self, jm, tm, monkeypatch):
        # x64 rows must not drop to the float32 kernel (the reference keeps
        # XLA for them).
        monkeypatch.setattr(cuda_ops, "gaussian_kernel_block", None)
        X = np.random.default_rng(4).normal(size=(32, 6))
        K = tring.ring_pairwise_gaussian(tmesh.shard_rows(_t(X, torch.float64), tm), 0.5, tm)
        assert K.dtype == torch.float64
        want = np.asarray(jring.ring_pairwise_gaussian(jmesh.shard_rows(X, jm), 0.5, jm))
        np.testing.assert_allclose(_np(K), want, rtol=0, atol=1e-12)


class TestRingKernelApply:
    def test_matches_dense_apply(self, jm, tm):
        rng = np.random.default_rng(7)
        Xtr = rng.normal(size=(48, 6)).astype(np.float32)
        Xte = rng.normal(size=(24, 6)).astype(np.float32)
        W = rng.normal(size=(48, 3)).astype(np.float32)
        out = tring.ring_kernel_apply(tmesh.shard_rows(Xte, tm), tmesh.shard_rows(Xtr, tm),
                                      tmesh.shard_rows(W, tm), 0.05, mesh=tm)
        np.testing.assert_allclose(_np(out), _dense_gaussian(Xte, Xtr, 0.05) @ W, atol=1e-4)
        want = np.asarray(jring.ring_kernel_apply(
            jmesh.shard_rows(Xte, jm), jmesh.shard_rows(Xtr, jm), jmesh.shard_rows(W, jm),
            0.05, mesh=jm))
        np.testing.assert_allclose(_np(out), want, atol=1e-4)

    def test_against_the_reference_ring(self, jm, tm, monkeypatch):
        rng = np.random.default_rng(3)
        Xtr = rng.normal(size=(64, 10)).astype(np.float32)
        Xte = rng.normal(size=(32, 10)).astype(np.float32)
        W = rng.normal(size=(64, 4)).astype(np.float32)
        calls = []
        real = cuda_ops.gaussian_resid_block
        monkeypatch.setattr(cuda_ops, "gaussian_resid_block",
                            lambda *a, **k: calls.append((a[0].shape, a[1].shape)) or real(*a, **k))
        got = tring.ring_kernel_apply(tmesh.shard_rows(Xte, tm), tmesh.shard_rows(Xtr, tm),
                                      tmesh.shard_rows(W, tm), 0.2, tm)
        # One launch a shard a step, the train shard first: K(train, test)ᵀ W.
        assert calls == [((8, 10), (4, 10))] * 64
        K = np.asarray(jring._gaussian_xla(jnp.asarray(Xte), jnp.asarray(Xtr), 0.2))
        np.testing.assert_allclose(_np(got), K @ W, rtol=0, atol=5e-5)
        want = np.asarray(jring.ring_kernel_apply(
            jmesh.shard_rows(Xte, jm), jmesh.shard_rows(Xtr, jm), jmesh.shard_rows(W, jm),
            0.2, jm))
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=5e-5)


class TestRingGram:
    def test_matches_dense_gram(self, jm, tm):
        A = np.random.default_rng(7).normal(size=(64, 16)).astype(np.float32)
        g = tring.ring_gram(tmesh.shard_rows(A, tm), mesh=tm)
        np.testing.assert_allclose(_np(g), A.T @ A, atol=1e-4)
        want = np.asarray(jring.ring_gram(jmesh.shard_rows(A, jm), mesh=jm))
        np.testing.assert_allclose(_np(g), want, atol=1e-4)

    def test_result_scattered(self, tm):
        A = np.random.default_rng(8).normal(size=(32, 8)).astype(np.float32)
        g = tring.ring_gram(tmesh.shard_rows(A, tm), mesh=tm)
        assert {tuple(s.shape) for s in g.shards} == {(1, 8)}

    def test_indivisible_raises(self, jm, tm):
        A = np.random.default_rng(9).normal(size=(16, 9)).astype(np.float32)
        with pytest.raises(ValueError, match="not divisible"):
            tring.ring_gram(tmesh.shard_rows(A, tm), mesh=tm)
        with pytest.raises(ValueError):
            jring.ring_gram(jmesh.shard_rows(A, jm), mesh=jm)


def _attention(Q, K, V, causal):
    s = (Q @ K.T) / np.sqrt(Q.shape[1])
    if causal:
        n = Q.shape[0]
        s = np.where(np.tril(np.ones((n, n), bool)), s, -np.inf)
    p = np.exp(s - s.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    return p @ V


class TestRingAttention:
    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_unsharded_attention(self, jm, tm, causal):
        rng = np.random.default_rng(8)
        Q, K, V = (rng.normal(size=(64, 16)) for _ in range(3))
        out = tring.ring_attention(*(tmesh.shard_rows(_t(a, torch.float64), tm)
                                     for a in (Q, K, V)), mesh=tm, causal=causal)
        assert out.dtype == torch.float64
        np.testing.assert_allclose(_np(out), _attention(Q, K, V, causal), atol=1e-10)
        want = np.asarray(jring.ring_attention(*(jmesh.shard_rows(a, jm) for a in (Q, K, V)),
                                               mesh=jm, causal=causal))
        np.testing.assert_allclose(_np(out), want, atol=1e-10)

    def test_padded_rows_masked_by_n_valid(self, tm):
        rng = np.random.default_rng(10)
        n = 500  # pads to 504 over 8 shards
        Q, K, V = (rng.normal(size=(n, 8)) for _ in range(3))
        padded = [tmesh.shard_rows(tmesh.pad_rows(_t(a, torch.float64), 8)[0], tm)
                  for a in (Q, K, V)]
        out = _np(tring.ring_attention(*padded, mesh=tm, n_valid=n))
        np.testing.assert_allclose(out[:n], _attention(Q, K, V, False), atol=1e-10)
        np.testing.assert_allclose(out[n:], 0.0, atol=0)

    def test_bf16_operands_f32_state(self, jm, tm):
        Q = np.random.default_rng(11).normal(size=(512, 16)).astype(np.float32)
        q16 = _t(Q).to(torch.bfloat16)
        sh = tmesh.shard_rows(q16, tm)
        out = tring.ring_attention(sh, sh, sh, mesh=tm)
        assert out.dtype == torch.bfloat16
        Qb = q16.to(torch.float64).numpy()
        assert np.abs(_np(out) - _attention(Qb, Qb, Qb, False)).max() < 8e-3
        jq = jmesh.shard_rows(jnp.asarray(Q, jnp.bfloat16), jm)
        want = np.asarray(jring.ring_attention(jq, jq, jq, mesh=jm).astype(jnp.float32))
        assert np.abs(_np(out) - want).max() < 8e-3

    def test_bf16_operands_round_once_at_the_end(self, tm):
        """Float32 state and one final cast put each output within half a
        bf16 ulp of float64 attention on the same bf16 operands; state
        rounded to bf16 after every block (the control) lands tens of ulps
        off. Ulps floored at that of 2^-8 of max|out|."""
        Q, K, V = (_t(np.random.default_rng(s).normal(size=(512, 16)).astype(np.float32))
                   .to(torch.bfloat16) for s in (14, 15, 16))
        out = tring.ring_attention(*(tmesh.shard_rows(a, tm) for a in (Q, K, V)), mesh=tm)
        want = torch.from_numpy(_attention(*(a.to(torch.float64).numpy() for a in (Q, K, V)),
                                           False))

        def ulps(got):
            mag = torch.clamp_min(want.abs(), want.abs().max().item() * 2.0 ** -8)
            ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
            return ((got.to(torch.float64) - want).abs() / ulp).max().item()

        ln, sc = 64, 16 ** -0.5
        control = []
        for me in range(8):
            q = Q[me * ln:(me + 1) * ln].float()
            m, l_, acc = torch.full((ln,), -1e30), torch.zeros(ln), torch.zeros((ln, 16))
            for src in ((me - step) % 8 for step in range(8)):
                s = (q @ K[src * ln:(src + 1) * ln].float().T) * sc
                m_new = torch.maximum(m, s.max(dim=1).values).bfloat16().float()
                alpha, p_blk = torch.exp(m - m_new), torch.exp(s - m_new[:, None])
                l_ = (l_ * alpha + p_blk.sum(dim=1)).bfloat16().float()
                acc = (acc * alpha[:, None] + p_blk @ V[src * ln:(src + 1) * ln].float()
                       ).bfloat16().float()
                m = m_new
            control.append(acc / l_[:, None])
        assert ulps(out.gather()) <= 0.51
        assert ulps(torch.cat(control).bfloat16()) > 10

    def test_mixed_dtypes_do_not_crash(self, tm):
        rng = np.random.default_rng(12)
        q = tmesh.shard_rows(_t(rng.normal(size=(64, 8)), torch.bfloat16), tm)
        k, v = (tmesh.shard_rows(_t(rng.normal(size=(64, 8))), tm) for _ in range(2))
        out = tring.ring_attention(q, k, v, mesh=tm)
        assert out.dtype == torch.float32 and np.isfinite(_np(out)).all()

    def test_dataset_wrapper_threads_n_valid(self, tm):
        n = 500
        Q = np.random.default_rng(13).normal(size=(n, 8))
        ds = TDataset(_t(Q, torch.float64)).shard(tm)
        assert ds.array.shape[0] > n  # actually padded
        out = tring.ring_attention_dataset(ds, mesh=tm)
        arr = _np(out.array)
        assert out.n == n and out.mesh is tm
        np.testing.assert_allclose(arr[:n], _attention(Q, Q, Q, False), atol=1e-10)
        np.testing.assert_allclose(arr[n:], 0.0, atol=0)

    def test_dataset_wrapper_rejects_mismatched_counts(self, tm):
        rng = np.random.default_rng(14)
        q = TDataset(_t(rng.normal(size=(16, 4)))).shard(tm)
        k = TDataset(_t(rng.normal(size=(24, 4)))).shard(tm)
        with pytest.raises(ValueError, match="matching true row counts"):
            tring.ring_attention_dataset(q, k, mesh=tm)

    def test_long_sequence_memory_shape(self, tm):
        Q = _t(np.random.default_rng(9).normal(size=(1024, 8)))
        sh = tmesh.shard_rows(Q, tm)
        out = tring.ring_attention(sh, sh, sh, mesh=tm, causal=True)
        assert tuple(out.shape) == (1024, 8) and {tuple(s.shape) for s in out.shards} == {(128, 8)}
        assert np.isfinite(_np(out)).all()
