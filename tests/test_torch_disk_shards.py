"""Disk-backed shards for the streamed folds, in the port and against the
JAX package, on the CPU (twins of tests/test_disk_shards.py, plus the
shared on-disk format): the segmented Gramian folds read memory-mapped
shards one segment at a time, host residency bounded by the segment, and
a directory written by either package loads in the other with the same
bytes.

Tolerances and why:
  - shard round trips, segment reads and the disk fold against the same
    fold over resident chunks in the port: bits (the same chunks in the
    same order through the same fold);
  - the port's disk fits against the reference's disk fits on the same
    directory: 1e-4 relative Frobenius for weights, 1e-5 for losses (both
    fold float32 products in float32 in different orders);
  - the dense disk fit against the resident streamed fit: the reference
    test's own bounds (1e-5 for means, 2e-3 for weights, 1e-4 for the
    loss).
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data.durable import ShardCorrupted
from keystone_tpu_torch.data.shards import DiskCOOShards, DiskDenseShards
from keystone_tpu_torch.ops.learning import streaming_ls as tsls
from keystone_tpu_torch.ops.learning.lbfgs import _resident_chunk_fn, run_lbfgs_gram_streamed
from keystone_tpu_torch.parallel import streaming as tstream

import jax.numpy as jnp

from keystone_tpu.data import shards as jshards
from keystone_tpu.ops.learning import lbfgs as jl
from keystone_tpu.ops.learning import streaming_ls as jsls
from keystone_tpu.parallel import streaming as jstream

D, K, W_ACT = 384, 3, 6
CHUNK = 1024


def _coo_problem(n, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, D, size=(n, W_ACT)).astype(np.int32)
    val = rng.normal(size=(n, W_ACT)).astype(np.float32)
    y = rng.normal(size=(n, K)).astype(np.float32)
    return idx, val, y


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _banks(d_in, d_feat, seed=4):
    rng = np.random.default_rng(seed)
    Wrf = (rng.normal(size=(d_feat, d_in)) * 0.3).astype(np.float32)
    brf = rng.uniform(0, 6, d_feat).astype(np.float32)
    return (jsls.CosineBankFeaturize(jnp.asarray(Wrf), jnp.asarray(brf)),
            tsls.CosineBankFeaturize(torch.from_numpy(Wrf), torch.from_numpy(brf)))


def _tiles(idx, val, y, nc):
    pad = nc * CHUNK - idx.shape[0]
    return (
        torch.from_numpy(np.pad(idx, ((0, pad), (0, 0)), constant_values=-1)).reshape(nc, CHUNK, W_ACT),
        torch.from_numpy(np.pad(val, ((0, pad), (0, 0)))).reshape(nc, CHUNK, W_ACT),
        torch.from_numpy(np.pad(y, ((0, pad), (0, 0)))).reshape(nc, CHUNK, K),
    )


class TestDiskShards:
    def test_disk_fit_matches_resident_fit(self, tmp_path):
        n = 5 * CHUNK + 317  # ragged final chunk
        idx, val, y = _coo_problem(n)
        shards = DiskCOOShards.write(str(tmp_path / "coo"), idx, val, y, chunk_rows=CHUNK,
                                     n_true=n, d=D)
        assert shards.is_memory_mapped and shards.num_chunks == 6
        W_disk, loss_disk = run_lbfgs_gram_streamed(
            _resident_chunk_fn, shards.num_chunks, D, K, lam=1e-2, num_iterations=25, n=n,
            segment_source=shards.segment_source, max_chunks_per_dispatch=2, inflight=2,
            device="cpu",
        )
        # Resident chunks, the same chunking and fold order: the same bits.
        W_res, loss_res = run_lbfgs_gram_streamed(
            _resident_chunk_fn, 6, D, K, lam=1e-2, num_iterations=25, n=n,
            operands=_tiles(idx, val, y, 6),
        )
        assert torch.equal(W_disk, W_res) and torch.equal(loss_disk, loss_res)

    def test_segment_source_bounds_residency(self, tmp_path):
        n = 8 * CHUNK
        idx, val, y = _coo_problem(n, seed=1)
        shards = DiskCOOShards.write(str(tmp_path / "coo"), idx, val, y, chunk_rows=CHUNK,
                                     n_true=n, d=D)
        seg = 2
        ops = shards.segment_source(0, seg)
        total = idx.nbytes + val.nbytes + y.nbytes
        assert sum(a.nbytes for a in ops) <= total * seg / shards.num_chunks + 1024
        tail = shards.segment_source(shards.num_chunks - 1, seg)
        assert tail[0].shape[0] == seg
        assert (tail[0][1] == -1).all() and (tail[1][1] == 0).all()

    def test_incremental_create_fill(self, tmp_path):
        n = 3 * CHUNK
        idx, val, y = _coo_problem(n, seed=2)
        d = str(tmp_path / "inc")
        mm_i, mm_v, mm_y = DiskCOOShards.create(d, 3, CHUNK, W_ACT, K, n_true=n, d=D)
        for c in range(3):
            sl = slice(c * CHUNK, (c + 1) * CHUNK)
            mm_i[c], mm_v[c], mm_y[c] = idx[sl], val[sl], y[sl]
        for mm in (mm_i, mm_v, mm_y):
            mm.flush()
        with pytest.raises(ShardCorrupted, match="sealed"):
            DiskCOOShards(d)
        shards = DiskCOOShards.seal(d)
        assert shards.is_checksummed
        np.testing.assert_array_equal(shards.segment_source(1, 1)[0][0], idx[CHUNK:2 * CHUNK])

    def test_disk_fit_against_the_reference_disk_fit(self, tmp_path):
        n = 4 * CHUNK + 211
        idx, val, y = _coo_problem(n, seed=5)
        path = str(tmp_path / "coo")
        shards = DiskCOOShards.write(path, idx, val, y, chunk_rows=CHUNK, n_true=n, d=D)
        W, loss = run_lbfgs_gram_streamed(
            _resident_chunk_fn, shards.num_chunks, D, K, lam=1e-2, num_iterations=25, n=n,
            segment_source=shards.as_source(2), device="cpu",
        )
        j = jshards.DiskCOOShards(path)
        Wj, lossj = jl.run_lbfgs_gram_streamed(
            jl._resident_chunk_fn, j.num_chunks, D, K, lam=1e-2, num_iterations=25, n=n,
            segment_source=j.as_source(2),
        )
        assert _rel(W.numpy(), np.asarray(Wj)) <= 1e-4
        assert float(loss) == pytest.approx(float(lossj), rel=1e-5)


class TestDiskDenseShards:
    def test_dense_disk_fit_matches_resident_streamed(self, tmp_path):
        rng = np.random.default_rng(7)
        d_in, d_feat, bs, k = 16, 256, 64, 3
        tile, tps = 128, 2
        n = 5 * tile + 77  # ragged tail inside the last segment
        X = rng.normal(size=(n, d_in)).astype(np.float32)
        Y = rng.normal(size=(n, k)).astype(np.float32) + 0.4
        _, bank = _banks(d_in, d_feat)
        shards = DiskDenseShards.write(str(tmp_path / "dense"), X, Y, tile_rows=tile,
                                       tiles_per_segment=tps)
        assert shards.is_memory_mapped and shards.num_segments == 3
        W_d, fm_d, ym_d, loss_d = tstream.streaming_bcd_fit_segments(
            shards.segment_source, shards.num_segments, n, bank, d_feat=d_feat,
            tile_rows=tile, block_size=bs, lam=1e-2, num_iter=2, center=True,
        )
        W_r, fm_r, ym_r, loss_r = tstream.streaming_bcd_fit_centered(
            torch.from_numpy(X), torch.from_numpy(Y), featurize=bank, d_feat=d_feat,
            tile_rows=tile, block_size=bs, lam=1e-2, num_iter=2,
        )
        np.testing.assert_allclose(fm_d.numpy(), fm_r.numpy(), atol=1e-5)
        np.testing.assert_allclose(ym_d.numpy(), ym_r.numpy(), atol=1e-5)
        np.testing.assert_allclose(W_d.numpy(), W_r.numpy(), atol=2e-3, rtol=2e-3)
        assert float(loss_d) == pytest.approx(float(loss_r), rel=1e-4)
        # The same tile size folds the same rows in the same order.
        assert torch.equal(W_d, W_r)

    def test_dense_segment_residency_bounded(self, tmp_path):
        rng = np.random.default_rng(8)
        n, d_in, k, tile, tps = 1024, 8, 2, 128, 2
        X = rng.normal(size=(n, d_in)).astype(np.float32)
        Y = rng.normal(size=(n, k)).astype(np.float32)
        shards = DiskDenseShards.write(str(tmp_path / "d2"), X, Y, tile_rows=tile,
                                       tiles_per_segment=tps)
        seg = shards.segment_source(0)
        assert seg[0].nbytes + seg[1].nbytes <= (X.nbytes + Y.nbytes) * tps / shards.num_tiles + 4096
        last = shards.segment_source(shards.num_segments - 1)
        assert last[0].shape[0] == tps and 0 <= last[2] <= tps * tile

    def test_dense_disk_fit_against_the_reference_disk_fit(self, tmp_path):
        rng = np.random.default_rng(9)
        d_in, d_feat, bs, k, tile = 16, 128, 32, 3, 64
        n = 7 * tile + 13
        X = rng.normal(size=(n, d_in)).astype(np.float32)
        Y = rng.normal(size=(n, k)).astype(np.float32)
        path = str(tmp_path / "dense")
        shards = DiskDenseShards.write(path, X, Y, tile_rows=tile, tiles_per_segment=2)
        jbank, tbank = _banks(d_in, d_feat, seed=10)
        W, fm, ym, loss = tstream.streaming_bcd_fit_segments(
            shards.as_source(), bank=tbank, d_feat=d_feat, block_size=bs, lam=1e-2, num_iter=2,
        )
        Wj, fmj, ymj, lossj = jstream.streaming_bcd_fit_segments(
            jshards.DiskDenseShards(path).as_source(), bank=jbank, d_feat=d_feat,
            block_size=bs, lam=1e-2, num_iter=2,
        )
        assert _rel(W.numpy(), np.asarray(Wj)) <= 1e-4
        assert _rel(fm.numpy(), np.asarray(fmj)) <= 1e-5
        assert _rel(ym.numpy(), np.asarray(ymj)) <= 1e-5
        assert float(loss) == pytest.approx(float(lossj), rel=1e-4)


class TestSharedFormat:
    """A shard directory written by one package loads in the other: the
    same metadata, checksums and segment bytes."""

    def _dense_xy(self, n=300, seed=11):
        rng = np.random.default_rng(seed)
        return (rng.normal(size=(n, 8)).astype(np.float32),
                rng.normal(size=(n, 2)).astype(np.float32))

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_dense_directory_reads_across_packages(self, tmp_path, writer):
        X, Y = self._dense_xy()
        path = str(tmp_path / writer)
        write = DiskDenseShards.write if writer == "port" else jshards.DiskDenseShards.write
        write(path, X, Y, tile_rows=64, tiles_per_segment=2)
        t, j = DiskDenseShards(path), jshards.DiskDenseShards(path)
        assert t.is_checksummed and j.is_checksummed
        assert (t.n_true, t.num_tiles, t.num_segments) == (j.n_true, j.num_tiles, j.num_segments)
        for s in range(t.num_segments):
            a, b = t.segment_source(s), j.segment_source(s)
            np.testing.assert_array_equal(a[0], np.asarray(b[0]))
            np.testing.assert_array_equal(a[1], np.asarray(b[1]))
            assert a[2] == b[2]
        np.testing.assert_array_equal(t.as_source().materialize()[0], X)

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_coo_directory_reads_across_packages(self, tmp_path, writer):
        idx, val, y = _coo_problem(700, seed=12)
        path = str(tmp_path / writer)
        write = DiskCOOShards.write if writer == "port" else jshards.DiskCOOShards.write
        write(path, idx, val, y, chunk_rows=256, n_true=700, d=D)
        t, j = DiskCOOShards(path), jshards.DiskCOOShards(path)
        assert (t.n_true, t.d, t.num_chunks) == (j.n_true, j.d, j.num_chunks)
        for cid0 in (0, 2):
            for a, b in zip(t.segment_source(cid0, 2), j.segment_source(cid0, 2)):
                np.testing.assert_array_equal(a, np.asarray(b))

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_writer_directory_reads_across_packages(self, tmp_path, writer):
        X, Y = self._dense_xy(n=150, seed=13)
        path = str(tmp_path / writer)
        cls = (DiskDenseShards if writer == "port" else jshards.DiskDenseShards)
        from keystone_tpu_torch.data.shards import DiskDenseShardWriter as TW

        W = TW if writer == "port" else jshards.DiskDenseShardWriter
        w = W(path, capacity_rows=400, d_in=8, k=2, tile_rows=32, tiles_per_segment=2)
        w.append(X[:100], Y[:100])
        w.append(X[100:], Y[100:])
        assert isinstance(w.close(), cls)
        other = jshards.DiskDenseShards(path) if writer == "port" else DiskDenseShards(path)
        np.testing.assert_array_equal(np.asarray(other.as_source().materialize()[0]), X)
