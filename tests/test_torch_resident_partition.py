"""The compressed tier's mesh forms (``data/resident.py``): the
partition-local ``index_base`` rebase, ``compressible_dim``'s rebased gate
and ``CompressedCOOChunks.partition``, against the JAX package's
``data/resident.py``. Twins of tests/test_resident.py's TestMeshPartitions.

Inputs are the reference test's seeded numpy padded-COO rows, int32
indices and float32 values on both sides. Every comparison is exact:
encoding, rebasing and partitioning only move, round (bf16, RTNE on both
sides) and pad values.
"""

import numpy as np
import pytest
import torch

from keystone_tpu.data import resident as jres
from keystone_tpu_torch.data import resident as tres

TOP = tres.INT16_MAX_INDEX


def _coo(n=700, d=96, w=5, k=2, seed=3, bf16_exact=False):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(n, w)).astype(np.int32)
    if bf16_exact:
        val = (rng.integers(-128, 128, size=(n, w)) / 64.0).astype(np.float32)
    else:
        val = rng.normal(size=(n, w)).astype(np.float32)
    y = rng.normal(size=(n, k)).astype(np.float32)
    return idx, val, y


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(t, np.float32) if t.dtype.name == "bfloat16" else np.asarray(t)


def _same_chunks(t, j):
    for a, b in ((t.idx_t, j.idx_t), (t.val_t, j.val_t), (t.y_t, j.y_t)):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert (t.n_true, t.d, t.index_base) == (j.n_true, j.d, j.index_base)


class TestMeshPartitions:
    def test_index_base_rebases_and_round_trips(self):
        idx, val, y = _coo(n=200, d=64, bf16_exact=True)
        base = 40_000  # far past int16 as a global index
        gidx = np.where(idx >= 0, idx + base, -1)
        chunks = tres.CompressedCOOChunks.encode(gidx, val, y, chunk_rows=64, d=base + 64,
                                                 index_base=base)
        assert chunks.idx_t.dtype == torch.int16 and int(chunks.idx_t.max()) < 64
        idx2, val2, _ = chunks.decode()
        np.testing.assert_array_equal(idx2, gidx)
        np.testing.assert_array_equal(val2, val)
        _same_chunks(chunks, jres.CompressedCOOChunks.encode(
            gidx, val, y, chunk_rows=64, d=base + 64, index_base=base))

    def test_rebased_boundary_checked_on_local_range(self):
        idx, val, y = _coo(n=64, d=32)
        base = 70_000
        gidx = np.where(idx >= 0, idx + base, -1)
        gidx[0, 0] = base + TOP  # representable
        tres.CompressedCOOChunks.encode(gidx, val, y, chunk_rows=64, d=base + TOP + 1,
                                        index_base=base)
        gidx[0, 0] = base + TOP + 1  # one past raises at encode, never wraps
        for mod in (tres, jres):
            with pytest.raises(ValueError, match="int16"):
                mod.CompressedCOOChunks.encode(gidx, val, y, chunk_rows=64,
                                               d=base + TOP + 2, index_base=base)

    def test_active_index_below_base_raises(self):
        idx, val, y = _coo(n=64, d=32)
        gidx = np.where(idx >= 0, idx + 1000, -1)
        gidx[3, 1] = 999  # a column this partition does not own
        for mod in (tres, jres):
            with pytest.raises(ValueError, match="index_base"):
                mod.CompressedCOOChunks.encode(gidx, val, y, chunk_rows=64, d=2000,
                                               index_base=1000)
        gidx[3, 1] = -1  # inactive lanes are exempt from the base check
        _same_chunks(
            tres.CompressedCOOChunks.encode(gidx, val, y, chunk_rows=64, d=2000,
                                            index_base=1000),
            jres.CompressedCOOChunks.encode(gidx, val, y, chunk_rows=64, d=2000,
                                            index_base=1000))

    @pytest.mark.parametrize("d,base", [(100, 4), (TOP + 1, 0), (TOP + 2, 0), (TOP + 2, 1),
                                        (40_000 + 64, 40_000)])
    def test_compressible_dim_gates_on_the_rebased_width(self, d, base):
        assert tres.compressible_dim(d, index_base=base) == jres.compressible_dim(
            d, index_base=base)

    def test_partition_splits_contiguously_and_round_trips(self):
        idx, val, y = _coo(n=700, d=96, bf16_exact=True)
        chunks = tres.CompressedCOOChunks.encode(idx, val, y, chunk_rows=128)
        parts = chunks.partition(3)  # 6 chunks -> 2 a partition
        assert [p.num_chunks for p in parts] == [2, 2, 2]
        assert [p.n_true for p in parts] == [256, 256, 188]
        np.testing.assert_array_equal(np.concatenate([p.decode()[0] for p in parts]), idx)
        np.testing.assert_array_equal(np.concatenate([p.decode()[1] for p in parts]), val)
        jparts = jres.CompressedCOOChunks.encode(idx, val, y, chunk_rows=128).partition(3)
        for t, j in zip(parts, jparts):
            _same_chunks(t, j)

    def test_partition_ragged_tail_pads_dead_chunks(self):
        idx, val, y = _coo(n=300, d=96)
        chunks = tres.CompressedCOOChunks.encode(idx, val, y, chunk_rows=64)
        parts = chunks.partition(4)  # 5 chunks -> 2 a partition, the last 3 dead
        assert [p.num_chunks for p in parts] == [2, 2, 2, 2]
        assert parts[3].n_true == 0
        assert bool((parts[3].idx_t[1] == -1).all()) and not bool(parts[3].y_t.any())
        jparts = jres.CompressedCOOChunks.encode(idx, val, y, chunk_rows=64).partition(4)
        for t, j in zip(parts, jparts):
            _same_chunks(t, j)

    def test_partitions_past_the_chunks_are_empty(self):
        idx, val, y = _coo(n=100, d=16)
        parts = tres.CompressedCOOChunks.encode(idx, val, y, chunk_rows=64).partition(5)
        assert [p.n_true for p in parts] == [64, 36, 0, 0, 0]
        with pytest.raises(ValueError, match="num_partitions"):
            tres.CompressedCOOChunks.encode(idx, val, y, chunk_rows=64).partition(0)

    def test_partition_revalidates_int16_boundary(self):
        # The constructor trusts its buffers; partition() does not.
        idx_t = torch.full((2, 4, 3), -1, dtype=torch.int16)
        idx_t[0, 0, 0] = 50  # outside d = 32
        val_t = torch.zeros((2, 4, 3), dtype=torch.bfloat16)
        y_t = torch.zeros((2, 4, 1))
        bad = tres.CompressedCOOChunks(idx_t, val_t, y_t, n_true=8, d=32)
        with pytest.raises(ValueError, match="refusing"):
            bad.partition(2)
        # An index_base whose local range overflows int16 is refused even
        # with in-range buffers.
        wide = tres.CompressedCOOChunks(torch.zeros((2, 4, 3), dtype=torch.int16), val_t, y_t,
                                        n_true=8, d=TOP + 3, index_base=1)
        with pytest.raises(ValueError, match="int16"):
            wide.partition(2)

    def test_rebased_partitions_decode_global_indices(self):
        idx, val, y = _coo(n=300, d=64, bf16_exact=True)
        gidx = np.where(idx >= 0, idx + 50_000, -1)
        chunks = tres.CompressedCOOChunks.encode(gidx, val, y, chunk_rows=64, d=50_064,
                                                 index_base=50_000)
        parts = chunks.partition(2)
        assert all(p.index_base == 50_000 for p in parts)
        np.testing.assert_array_equal(
            np.concatenate([p.decode()[0] for p in parts])[:300], gidx)
