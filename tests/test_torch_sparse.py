"""The port's sparse substrate against the JAX package, on the CPU: the
padded-COO products and densify, ``SparseLinearMapper``, the resident
tiles and the compressed int16 + bf16 COO, the sparse gram fold, the
``gram_corr_sym_acc`` kernel's plain version, and the sparse feature nodes.

Inputs come from seeded numpy generators and are float32 on both sides
(tests/conftest.py turns on x64, so arrays handed to JAX are cast to
float32 first). The reference's fold is held in both of its forms: XLA
(``use_pallas=False``) and the Pallas ``gram_corr_sym_acc`` in interpret
mode (``use_pallas=True`` with ``KEYSTONE_PALLAS=1``). The reference pads
the fold's width to its TPU tile; the port's carry is d wide, so the tests
compare ``G[:d, :d]`` and ``AtY[:d]`` (the reference's padded rows are
exactly zero). The kernel itself runs only on a CUDA card: its ``cuda``
tests are in tests/test_torch_sparse_kernels.py, which the card, having no
JAX, can import.

Tolerances and why:
  - products, densify, the mapper: 1e-5 relative to the sums' scale
    (Σ|v||w|): float32 sums of at most 16 lanes (or 1,000 rows) in other
    orders;
  - the fold's statistics: 1e-5 of each statistic's own scale (Σ|·| of its
    terms), the same float32 argument over 512-row chunks;
  - ``gram_corr_sym_acc``'s plain version: 1e-5 of |G₀| + Σ|fᵢ||fⱼ| on the
    upper tiles, and of |C₀| + Σ|f||r| for the correlation;
  - bf16 rounding, tiles, encode/decode, pipeline on/off: bit for bit.
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch import interop
from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.data import resident as tres
from keystone_tpu_torch.data.dataset import tree_leaves
from keystone_tpu_torch.ops import cuda_ops
from keystone_tpu_torch.ops import sparse as tsp
from keystone_tpu_torch.ops.learning.linear import SparseLinearMapper as TSparseLinearMapper

import jax.numpy as jnp
import ml_dtypes

from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.data import resident as jres
from keystone_tpu.ops import pallas_ops
from keystone_tpu.ops import sparse as jsp
from keystone_tpu.ops.learning.linear import SparseLinearMapper as JSparseLinearMapper

N, D, W_NNZ, K, CHUNK = 3000, 300, 8, 2, 512


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x)


def _coo(n=N, d=D, w=W_NNZ, k=K, seed=0, bad=True):
    """Padded-COO rows with -1 lanes and (if ``bad``) indices past d, plus
    ±1 one-hot labels."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(n, w)).astype(np.int32)
    if bad:
        u = rng.random(size=(n, w))
        idx[u < 0.1] = -1
        idx[u > 0.97] = d + 3  # out of range: dropped
    vals = rng.normal(size=(n, w)).astype(np.float32)
    Y = (2.0 * np.eye(k, dtype=np.float32)[rng.integers(0, k, size=n)] - 1.0)
    return idx, vals, Y


def _assert_rel(got, want, scale, tol=1e-5):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    scale = np.maximum(_np(scale).astype(np.float64), 1e-30)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want) / scale) <= tol


# ---------------------------------------------------------------------------
# Products and densify
# ---------------------------------------------------------------------------


class TestProducts:
    @pytest.mark.parametrize("k", [1, 2, 5, 40])
    def test_sparse_matmul(self, k):
        idx, vals, _ = _coo(n=700, k=k, seed=k)
        W = np.random.default_rng(9).normal(size=(D, k)).astype(np.float32)
        got = tsp.sparse_matmul(_t(idx), _t(vals), _t(W))
        want = jsp.sparse_matmul(jnp.asarray(idx), jnp.asarray(vals), jnp.asarray(W))
        live = (idx >= 0) & (idx < D)
        scale = (np.abs(vals) * live) @ np.ones((W_NNZ, 1)) * np.abs(W).max()
        _assert_rel(got, want, scale)

    @pytest.mark.parametrize("k", [1, 2, 5, 40])
    def test_sparse_matmul_t(self, k):
        idx, vals, _ = _coo(n=700, k=k, seed=10 + k)
        V = np.random.default_rng(9).normal(size=(700, k)).astype(np.float32)
        got = tsp.sparse_matmul_t(_t(idx), _t(vals), _t(V), D)
        want = jsp.sparse_matmul_t(jnp.asarray(idx), jnp.asarray(vals), jnp.asarray(V), D)
        dense_abs = np.zeros((700, D))
        live = (idx >= 0) & (idx < D)
        np.add.at(dense_abs, (np.nonzero(live)[0], idx[live]), np.abs(vals[live]))
        _assert_rel(got, want, dense_abs.T @ np.abs(V))

    def test_wide_k_chunks_match_one_pass(self, monkeypatch):
        idx, vals, _ = _coo(n=500, seed=3)
        V = np.random.default_rng(4).normal(size=(500, 40)).astype(np.float32)
        W = np.random.default_rng(5).normal(size=(D, 40)).astype(np.float32)
        whole_t = tsp.sparse_matmul_t(_t(idx), _t(vals), _t(V), D)
        whole = tsp.sparse_matmul(_t(idx), _t(vals), _t(W))
        monkeypatch.setattr(tsp, "_CHUNK_ELEMS", 7 * W_NNZ * 40)  # 72 chunks of 7 rows
        torch.testing.assert_close(tsp.sparse_matmul_t(_t(idx), _t(vals), _t(V), D), whole_t)
        torch.testing.assert_close(tsp.sparse_matmul(_t(idx), _t(vals), _t(W)), whole)

    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_densify_adds_duplicates_and_drops_out_of_range(self, dtype):
        rng = np.random.default_rng(6)
        idx = rng.integers(-1, 24, size=(200, 16)).astype(np.int32)  # many duplicates
        vals = rng.normal(size=(200, 16)).astype(np.float32)
        tv, jv = _t(vals), jnp.asarray(vals)
        if dtype == "bf16":
            tv, jv = tv.to(torch.bfloat16), jv.astype(jnp.bfloat16)
        got = tsp.densify_dataset(TDataset({"indices": _t(idx), "values": tv}, n=200), 20)
        want = jsp.densify_dataset(JDataset({"indices": jnp.asarray(idx), "values": jv}, n=200),
                                   20)
        live = (idx >= 0) & (idx < 20)
        scale = np.zeros((200, 20))
        np.add.at(scale, (np.nonzero(live)[0], idx[live]), np.abs(vals[live]))
        tol = 2.0 ** -7 if dtype == "bf16" else 1e-6  # bf16 sums round per add
        _assert_rel(got.array, np.asarray(want.array, np.float32), scale + 1e-3, tol)
        assert got.array.dtype == tv.dtype and got.n == 200

    def test_densify_slab_is_deterministic_and_exact(self):
        idx = torch.tensor([[1, 1, 3, -1, 9, 1]], dtype=torch.int32)
        vals = torch.tensor([[2.0, 3.0, 4.0, 5.0, 6.0, 0.5]])
        slab = tsp._dense_rows(idx, vals, 8, torch.float32)
        want = torch.zeros((1, 8))
        want[0, 1], want[0, 3] = 5.5, 4.0
        assert torch.equal(slab, want) and slab.is_contiguous()
        assert torch.equal(tsp._dense_rows(idx, vals, 8, torch.float32), slab)


class TestSparseLinearMapper:
    def _models(self, k=3):
        rng = np.random.default_rng(7)
        x = rng.normal(size=(D, k)).astype(np.float32)
        b = rng.normal(size=(k,)).astype(np.float32)
        return (TSparseLinearMapper(_t(x), _t(b)), JSparseLinearMapper(jnp.asarray(x),
                                                                        jnp.asarray(b)), x)

    def test_batch_apply(self):
        tm, jm, x = self._models()
        idx, vals, _ = _coo(n=400, seed=8)
        got = tm.batch_apply(TDataset({"indices": _t(idx), "values": _t(vals)}, n=390))
        want = jm.batch_apply(JDataset({"indices": jnp.asarray(idx), "values": jnp.asarray(vals)},
                                       n=390))
        _assert_rel(got.array, want.array, np.abs(vals).sum(1, keepdims=True) * np.abs(x).max()
                    + 10.0)
        assert got.n == 390 and torch.equal(got.array[390:], torch.zeros((10, 3)))

    def test_single_item_drops_out_of_range(self):
        tm, jm, _ = self._models()
        item = {"indices": np.array([3, D + 5, -1, 7], np.int32),
                "values": np.array([1.5, 9.0, 4.0, -2.0], np.float32)}
        torch.testing.assert_close(tm.apply(item), _t(np.asarray(jm.apply(item), np.float32)))

    def test_dense_input_falls_through(self):
        tm, jm, _ = self._models()
        X = np.random.default_rng(9).normal(size=(20, D)).astype(np.float32)
        got = tm.batch_apply(TDataset(_t(X)))
        want = jm.batch_apply(JDataset.of(jnp.asarray(X)))
        torch.testing.assert_close(got.array, _t(np.asarray(want.array, np.float32)),
                                   rtol=1e-5, atol=1e-4)

    def test_interop_carries_a_fitted_model(self):
        _, jm, _ = self._models()
        tm = interop.sparse_linear_mapper(np.asarray(jm.x), np.asarray(jm.b_opt), device="cpu")
        idx, vals, _ = _coo(n=50, seed=10)
        got = tm.batch_apply(TDataset({"indices": _t(idx), "values": _t(vals)}))
        want = jm.batch_apply(JDataset({"indices": jnp.asarray(idx), "values": jnp.asarray(vals)}))
        torch.testing.assert_close(got.array, _t(np.asarray(want.array, np.float32)),
                                   rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# Resident tiles and the compressed COO
# ---------------------------------------------------------------------------


class TestResident:
    def test_raw_chunk_tiles(self):
        idx, vals, Y = _coo(n=1100, seed=11)
        got = tres.raw_chunk_tiles(_t(idx), _t(vals), _t(Y), 512)
        want = jres.raw_chunk_tiles(jnp.asarray(idx), jnp.asarray(vals), jnp.asarray(Y), 512)
        for g, w in zip(got, want):
            assert tuple(g.shape) == tuple(w.shape) == (3,) + tuple(g.shape[1:])
            assert np.array_equal(_np(g), np.asarray(w))

    def test_bf16_rounding_has_the_bits_of_ml_dtypes(self):
        rng = np.random.default_rng(12)
        x = np.concatenate([
            rng.normal(size=20000).astype(np.float32) * 10.0 ** rng.integers(-30, 30, 20000),
            # exact ties between two bf16 values, both parities of the kept bit
            (np.arange(1, 2000, dtype=np.uint32) << 16 | 0x8000).view(np.float32),
            (np.arange(1, 2000, dtype=np.uint32) << 16 | 0x7FFF).view(np.float32),
            np.array([0.0, -0.0, 1e-40, -1e-40, 3.4e38, -3.4e38, np.inf, -np.inf], np.float32),
        ]).astype(np.float32)
        ours = _t(x).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
        theirs = x.astype(ml_dtypes.bfloat16).view(np.uint16)
        assert np.array_equal(ours, theirs)

    def test_encode_decode_match_the_reference(self):
        idx, vals, Y = _coo(n=1000, d=500, seed=13, bad=False)
        ours = tres.CompressedCOOChunks.encode(idx, vals, Y, chunk_rows=256, d=501, n_true=990)
        ref = jres.CompressedCOOChunks.encode(idx, vals, Y, chunk_rows=256, d=501, n_true=990)
        assert np.array_equal(ours.idx_t.numpy(), ref.idx_t)
        assert np.array_equal(ours.val_t.view(torch.int16).numpy().view(np.uint16),
                              ref.val_t.view(np.uint16))
        assert np.array_equal(ours.y_t.numpy(), ref.y_t)
        assert (ours.num_chunks, ours.chunk_rows, ours.d, ours.n_true) == (
            ref.num_chunks, ref.chunk_rows, ref.d, ref.n_true)
        assert ours.nbytes == ref.nbytes and ours.bytes_per_nnz == ref.bytes_per_nnz == 4.0
        for got, want in zip(ours.decode(), ref.decode()):
            assert np.array_equal(got, want)
        assert tres.CompressedCOOChunks.value_drift(vals) == (
            jres.CompressedCOOChunks.value_drift(vals))
        carried = interop.coo_chunks(ref, device="cpu")
        for got, want in zip(carried.operands(), ours.operands()):
            assert torch.equal(got, want)
        assert (carried.n_true, carried.d) == (990, 501)

    def test_round_trip_exact_for_bf16_representable_values(self):
        idx, _, Y = _coo(n=300, seed=14, bad=False)
        vals = np.random.default_rng(14).choice([-1.0, 0.5, 1.0, 2.0], size=idx.shape)
        chunks = tres.CompressedCOOChunks.encode(idx, vals.astype(np.float32), Y, chunk_rows=128)
        di, dv, dy = chunks.decode()
        assert np.array_equal(di, idx) and np.array_equal(dv, vals) and np.array_equal(dy, Y)
        assert tres.CompressedCOOChunks.value_drift(vals) == 0.0

    def test_int16_boundary_raises_never_wraps(self):
        top = tres.INT16_MAX_INDEX
        ok = np.array([[top, -1]], np.int32)
        chunks = tres.CompressedCOOChunks.encode(ok, np.ones((1, 2), np.float32),
                                                 np.ones((1, 1), np.float32), chunk_rows=4)
        assert int(chunks.idx_t.max()) == top
        with pytest.raises(ValueError, match="int16"):
            tres.CompressedCOOChunks.encode(ok + np.array([[1, 0]], np.int32),
                                            np.ones((1, 2), np.float32),
                                            np.ones((1, 1), np.float32), chunk_rows=4)
        with pytest.raises(ValueError, match="-1"):
            tres.CompressedCOOChunks.encode(np.array([[-2]], np.int32), np.ones((1, 1), np.float32),
                                            np.ones((1, 1), np.float32), chunk_rows=4)
        assert tres.compressible_dim(top + 1) == jres.compressible_dim(top + 1) is True
        assert tres.compressible_dim(top + 2) == jres.compressible_dim(top + 2) is False
        assert tres.COMPRESSED_BYTES_PER_NNZ == jres.COMPRESSED_BYTES_PER_NNZ

    def test_mesh_forms_raise_naming_the_roadmap(self):
        chunks = tres.CompressedCOOChunks.encode(np.zeros((4, 2), np.int32),
                                                 np.ones((4, 2), np.float32),
                                                 np.ones((4, 1), np.float32), chunk_rows=2)
        with pytest.raises(NotImplementedError, match="A.15"):
            chunks.partition(2)
        with pytest.raises(NotImplementedError, match="A.15"):
            tres.CompressedCOOChunks.encode(np.zeros((4, 2), np.int32), np.ones((4, 2)),
                                            np.ones((4, 1)), chunk_rows=2, index_base=1)
        with pytest.raises(NotImplementedError, match="A.15"):
            tres.compressible_dim(100, index_base=4)


# ---------------------------------------------------------------------------
# The gram fold and its kernel's plain version
# ---------------------------------------------------------------------------


def _fold_inputs(seed=15, bf16=False):
    idx, vals, Y = _coo(seed=seed)
    tiles_t = tres.raw_chunk_tiles(_t(idx), _t(vals), _t(Y), CHUNK)
    tiles_j = jres.raw_chunk_tiles(jnp.asarray(idx), jnp.asarray(vals), jnp.asarray(Y), CHUNK)
    return idx, vals, Y, tiles_t, tiles_j


def _fold_scales(idx, vals, Y, bf16):
    live = (idx >= 0) & (idx < D)
    v = np.abs(vals.astype(ml_dtypes.bfloat16).astype(np.float32) if bf16 else vals)
    dense = np.zeros((N, D))
    np.add.at(dense, (np.nonzero(live)[0], idx[live]), v[live])
    return dense.T @ dense, dense.T @ np.abs(Y)


class TestGramFold:
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    @pytest.mark.parametrize("use_pallas", [False, True])
    def test_fold_matches_the_reference(self, dtype, use_pallas, monkeypatch):
        if use_pallas:
            monkeypatch.setenv("KEYSTONE_PALLAS", "1")
        idx, vals, Y, tt, tj = _fold_inputs()
        nchunks = int(tt[0].shape[0])
        val_t = torch.bfloat16 if dtype == "bf16" else torch.float32
        val_j = jnp.bfloat16 if dtype == "bf16" else jnp.float32
        G, AtY, yty = tsp.sparse_gram_stream(lambda cid: tuple(a[cid] for a in tt), nchunks, D, K,
                                             val_dtype=val_t)
        Gj, Aj, yj = jsp.sparse_gram_stream(lambda cid: tuple(a[cid] for a in tj), nchunks, D, K,
                                            use_pallas=use_pallas, val_dtype=val_j)
        assert G.shape == (D, D) and AtY.shape == (D, K)
        assert Gj.shape[0] == jsp.gram_pad_dim(D, val_j) == tsp.gram_pad_dim(D, val_t)
        assert not np.any(np.asarray(Gj)[D:]) and not np.any(np.asarray(Aj)[D:])
        g_scale, c_scale = _fold_scales(idx, vals, Y, dtype == "bf16")
        _assert_rel(G, np.asarray(Gj)[:D, :D], g_scale)
        _assert_rel(AtY, np.asarray(Aj)[:D], c_scale)
        assert float(yty) == pytest.approx(float(yj), rel=1e-6)
        assert torch.equal(G, G.T)

    def test_pipeline_on_and_off_give_the_same_bits(self):
        _, _, _, tt, _ = _fold_inputs(seed=16)
        nchunks = int(tt[0].shape[0])
        runs = [
            tsp.sparse_gram_fold(None, range(nchunks), lambda cid: tuple(a[cid] for a in tt), D, K,
                                 pipeline=pipeline)
            for pipeline in (True, False)
        ]
        for a, b in zip(*runs):
            assert torch.equal(a, b)

    def test_fold_over_two_calls_equals_one(self):
        _, _, _, tt, _ = _fold_inputs(seed=17)

        def chunk(cid):
            return tuple(a[cid] for a in tt)

        one = tsp.sparse_gram_fold(None, range(6), chunk, D, K)
        carry = tsp.sparse_gram_fold(None, range(4), chunk, D, K)
        two = tsp.sparse_gram_fold(carry, range(4, 6), chunk, D, K)
        assert two[0] is carry[0]  # accumulated in place
        for a, b in zip(one, two):
            assert torch.equal(a, b)

    def test_fold_on_the_cpu_counts_no_launch(self):
        _, _, _, tt, _ = _fold_inputs(seed=18)
        before = dict(cuda_ops.launches)
        tsp.sparse_gram_stream(lambda cid: tuple(a[cid] for a in tt), 2, D, K)
        assert cuda_ops.launches == before

    def test_gram_pad_dim(self):
        for d in (1, 300, 512, 513, 16385):
            assert tsp.gram_pad_dim(d, torch.float32) == jsp.gram_pad_dim(d, jnp.float32)
            assert tsp.gram_pad_dim(d, torch.bfloat16) == jsp.gram_pad_dim(d, jnp.bfloat16)

    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    @pytest.mark.parametrize("k", [2, 3])
    def test_kernel_plain_version_matches_pallas(self, dtype, k):
        rng = np.random.default_rng(19)
        n, d = 1024, 512  # the reference's aligned shapes
        F = rng.normal(size=(n, d)).astype(np.float32)
        R = rng.normal(size=(n, k)).astype(np.float32)
        G = rng.normal(size=(d, d)).astype(np.float32)
        C = rng.normal(size=(d, k)).astype(np.float32)
        Ft, Fj = _t(F), jnp.asarray(F)
        if dtype == "bf16":
            Ft, Fj = Ft.to(torch.bfloat16), Fj.astype(jnp.bfloat16)
        got_g, got_c = cuda_ops.gram_corr_sym_acc_ref(_t(G), _t(C), Ft, _t(R))
        want_g, want_c = pallas_ops.gram_corr_sym_acc(jnp.asarray(G), jnp.asarray(C), Fj,
                                                      jnp.asarray(R), interpret=True)
        Ff = Ft.float().numpy()
        Rq = _t(R).to(torch.bfloat16).float().numpy() if dtype == "bf16" else R
        tiles = np.arange(d) // 128
        upper = tiles[:, None] <= tiles[None, :]
        g_scale = np.abs(G) + np.abs(Ff).T @ np.abs(Ff)
        err = np.abs(_np(got_g) - np.asarray(want_g)) / g_scale
        assert err[upper].max() <= 1e-5
        _assert_rel(got_c, want_c, np.abs(C) + np.abs(Ff).T @ np.abs(Rq))


# ---------------------------------------------------------------------------
# Nodes and the dict payload
# ---------------------------------------------------------------------------


ITEMS = [{"a": 1.0, "b": 2.0}, {"b": 1.0, "c": 3.0, "zz": 1.0}, [("c", 2.0), ("a", 0.5)],
         {"d": 4.0}, {"a": 1.0}]


class TestNodes:
    def test_feature_spaces_match(self):
        for t_est, j_est in ((tsp.CommonSparseFeatures(3), jsp.CommonSparseFeatures(3)),
                             (tsp.AllSparseFeatures(), jsp.AllSparseFeatures())):
            tv, jv = t_est.fit(TDataset(list(ITEMS))), j_est.fit(JDataset(list(ITEMS)))
            assert tv.feature_space == jv.feature_space
            assert tv.sparse_output_dim == jv.sparse_output_dim
            got = tv.batch_apply(TDataset(list(ITEMS)))
            want = jv.batch_apply(JDataset(list(ITEMS)))
            for key in ("indices", "values"):
                assert np.array_equal(got.data[key], np.asarray(want.data[key]))
            for item in ITEMS:
                for key in ("indices", "values"):
                    assert np.array_equal(tv.apply(item)[key], jv.apply(item)[key])

    def test_densify_and_sparsify(self):
        X = np.random.default_rng(20).normal(size=(6, 9)).astype(np.float32)
        X[X < 0.3] = 0.0
        ts, js = tsp.Sparsify().batch_apply(TDataset(_t(X))), jsp.Sparsify().batch_apply(
            JDataset.of(jnp.asarray(X)))
        for key in ("indices", "values"):
            assert np.array_equal(ts.data[key], np.asarray(js.data[key]))
        assert tsp.Sparsify().batch_apply(ts) is ts
        back = tsp.Densify(9).batch_apply(ts)
        assert np.array_equal(back.array.numpy(), X)
        item = tsp.Sparsify().apply(X[2])
        assert np.array_equal(tsp.Densify(9).apply(item).numpy(),
                              np.asarray(jsp.Densify(9).apply(jsp.Sparsify().apply(X[2]))))
        assert tsp.is_sparse_dataset(ts) and not tsp.is_sparse_dataset(TDataset(_t(X)))

    def test_dict_payload_dataset(self):
        idx, vals, _ = _coo(n=10, seed=21)
        ds = TDataset({"values": _t(vals), "indices": _t(idx)}, n=8)
        assert ds.n == 8 and ds.num_padded == 10 and not ds.is_host
        leaves = tree_leaves(ds.data)
        assert leaves[0].dtype == torch.int32 and leaves[1].dtype == torch.float32
        with pytest.raises(ValueError, match="dict"):
            ds.array


class TestSparsifyOnTheDevicesLayout:
    """``padded_coo_rows`` (what ``Sparsify`` runs on rows on any device)
    gives the reference's padded-COO layout, chunked or not."""

    @pytest.mark.parametrize("shape, density, chunk", [
        ((300, 50), 0.3, 777), ((64, 16), 0.0, 1 << 27), ((257, 33), 1.0, 100),
        ((1, 5), 0.5, 1)])
    def test_equals_sparsify_and_the_reference(self, shape, density, chunk):
        rng = np.random.default_rng(3)
        X = rng.normal(size=shape).astype(np.float32)
        X[rng.random(shape) >= density] = 0
        i, v = tsp.padded_coo_rows(torch.from_numpy(X), chunk_elements=chunk)
        host = tsp.Sparsify().batch_apply(TDataset.of(torch.from_numpy(X)))
        ref = jsp.Sparsify().batch_apply(JDataset.of(X))
        for got, key in ((i, "indices"), (v, "values")):
            assert np.array_equal(got.numpy(), np.asarray(host.data[key]))
            assert np.array_equal(got.numpy(), np.asarray(ref.data[key]))
