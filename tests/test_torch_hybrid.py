"""The hybrid resident + streamed compressed fold (``run_lbfgs_gram_hybrid``):
twins of tests/test_resident.py's TestHybridFold.

The port folds the same numpy-seeded padded-COO rows as the reference:
chunks ``[0, R)`` from the int16 + bf16 resident encoding, the tail from a
disk-like segment source or a chunk function. Tolerances:
  - the hybrid against one streamed fold over all chunks: bit for bit (the
    contract), W and the loss;
  - the port's W against the reference's hybrid W: 1e-4 of its scale, the
    port's bf16 gram tolerance (tests/test_torch_lbfgs.py): both fold the
    same bf16-rounded values in float32, in other summation orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keystone_tpu.data.prefetch import ShardSource as JShardSource
from keystone_tpu.data.resident import CompressedCOOChunks as JCompressed
from keystone_tpu.ops.learning import lbfgs as jl
from keystone_tpu_torch.data.prefetch import PrefetchStats, ShardSource
from keystone_tpu_torch.data.resident import CompressedCOOChunks
from keystone_tpu_torch.data.runtime import DataPlaneRuntime
from keystone_tpu_torch.ops.learning.lbfgs import (
    _resident_chunk_fn,
    run_lbfgs_gram_hybrid,
    run_lbfgs_gram_streamed,
)

W_TOL = 1e-4


def _coo(n, d, w, k, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(n, w)).astype(np.int32)
    val = rng.normal(size=(n, w)).astype(np.float32)
    y = rng.normal(size=(n, k)).astype(np.float32)
    return idx, val, y


def _tail_segment(arrs, lo, seg):
    out = []
    for a, fill in zip(arrs, (-1, 0, 0)):
        part = np.asarray(a[lo:lo + seg])
        pad = seg - part.shape[0]
        if pad:
            part = np.concatenate([part, np.full((pad,) + a.shape[1:], fill, a.dtype)])
        out.append(part)
    return tuple(out)


class _TailSource(ShardSource):
    """Segment s carries chunks [first + s·seg, first + (s+1)·seg) of the
    chunked arrays, segment-relative (int16 indices, the bf16 values widened
    exactly to float32, float32 labels: numpy has no bf16)."""

    def __init__(self, chunks, first_chunk, seg, n_true):
        self._arrs = (chunks.idx_t.numpy(), chunks.val_t.to(torch.float32).numpy(),
                      chunks.y_t.numpy())
        self.first, self.seg = int(first_chunk), int(seg)
        self.num_segments = -(-(chunks.num_chunks - self.first) // self.seg)
        self.n_true = int(n_true)

    def load(self, s):
        return _tail_segment(self._arrs, self.first + s * self.seg, self.seg)


class _JTailSource(JShardSource):
    def __init__(self, idx_t, val_t, y_t, first_chunk, seg, n_true):
        self._arrs = (idx_t, val_t, y_t)
        self.first, self.seg = int(first_chunk), int(seg)
        self.num_segments = -(-(idx_t.shape[0] - self.first) // self.seg)
        self.n_true = int(n_true)

    def load(self, s):
        return _tail_segment(self._arrs, self.first + s * self.seg, self.seg)


def _scale_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("num_resident", [4, 3])
def test_hybrid_bit_identical_to_single_streamed_fold(num_resident):
    # 3 resident chunks leave a ragged last resident segment: its phantom
    # id is not folded there, and folds as the tail's first chunk.
    n, d, k, w, chunk = 900, 96, 2, 5, 128
    idx, val, y = _coo(n, d, w, k, seed=5)
    chunks = CompressedCOOChunks.encode(idx, val, y, chunk_rows=chunk, d=d, n_true=n)
    nchunks = chunks.num_chunks
    assert nchunks == 8
    operands = chunks.operands()
    W_full, loss_full = run_lbfgs_gram_streamed(
        _resident_chunk_fn, nchunks, d, k, lam=1e-2, num_iterations=10, n=n,
        val_dtype=torch.bfloat16, operands=operands, max_chunks_per_dispatch=2,
        pipeline=False)
    stats = PrefetchStats()
    with DataPlaneRuntime():
        W_h, loss_h = run_lbfgs_gram_hybrid(
            _resident_chunk_fn, num_resident, operands, nchunks, d, k, lam=1e-2,
            num_iterations=10, n=n, val_dtype=torch.bfloat16, max_chunks_per_dispatch=2,
            segment_source=_TailSource(chunks, num_resident, 2, n), prefetch_stats=stats,
            pipeline=False)
    np.testing.assert_array_equal(W_full.numpy(), W_h.numpy())
    assert float(loss_full) == float(loss_h)
    # The tail streamed through the runtime with per-site accounting.
    assert stats.site_busy_s.get("read", 0) > 0
    assert stats.site_busy_s.get("compute", 0) > 0

    jchunks = JCompressed.encode(idx, val, y, chunk_rows=chunk, d=d, n_true=n)
    W_ref, _ = jl.run_lbfgs_gram_hybrid(
        jl._resident_chunk_fn, num_resident, jchunks.operands(), nchunks, d, k, lam=1e-2,
        num_iterations=10, n=n, val_dtype=jnp.bfloat16, max_chunks_per_dispatch=2,
        segment_source=_JTailSource(np.asarray(jchunks.idx_t), np.asarray(jchunks.val_t),
                                    np.asarray(jchunks.y_t), num_resident, 2, n),
        pipeline=False)
    assert _scale_err(W_h.numpy(), W_ref) <= W_TOL


def test_hybrid_with_device_regenerated_tail():
    n, d, k, w, chunk = 640, 64, 1, 4, 128
    idx, val, y = _coo(n, d, w, k, seed=6)
    chunks = CompressedCOOChunks.encode(idx, val, y, chunk_rows=chunk, d=d, n_true=n)
    operands = chunks.operands()
    nchunks = chunks.num_chunks
    idx_t, val_t, y_t = operands

    def tail_fn(cid):
        return idx_t[cid], val_t[cid], y_t[cid]

    W_full, _ = run_lbfgs_gram_streamed(
        _resident_chunk_fn, nchunks, d, k, lam=1e-2, num_iterations=8, n=n,
        val_dtype=torch.bfloat16, operands=operands, max_chunks_per_dispatch=2,
        pipeline=False)
    W_h, _ = run_lbfgs_gram_hybrid(
        _resident_chunk_fn, 2, operands, nchunks, d, k, lam=1e-2, num_iterations=8, n=n,
        val_dtype=torch.bfloat16, max_chunks_per_dispatch=2, chunk_fn=tail_fn,
        pipeline=False)
    np.testing.assert_array_equal(W_full.numpy(), W_h.numpy())

    jchunks = JCompressed.encode(idx, val, y, chunk_rows=chunk, d=d, n_true=n)
    ji, jv, jy = jchunks.operands()
    W_ref, _ = jl.run_lbfgs_gram_hybrid(
        jl._resident_chunk_fn, 2, (ji, jv, jy), nchunks, d, k, lam=1e-2, num_iterations=8,
        n=n, val_dtype=jnp.bfloat16, max_chunks_per_dispatch=2,
        chunk_fn=lambda cid: (ji[cid], jv[cid], jy[cid]), pipeline=False)
    assert _scale_err(W_h.numpy(), W_ref) <= W_TOL


def test_hybrid_all_resident_and_all_streamed():
    # The two ends of the split: every chunk resident (no tail), and none.
    n, d, k, w, chunk = 500, 48, 2, 3, 128
    chunks = CompressedCOOChunks.encode(*_coo(n, d, w, k, seed=7), chunk_rows=chunk, d=d,
                                        n_true=n)
    ops, nchunks = chunks.operands(), chunks.num_chunks
    kw = dict(lam=1e-2, num_iterations=6, n=n, val_dtype=torch.bfloat16,
              max_chunks_per_dispatch=2, pipeline=False)
    W_full, _ = run_lbfgs_gram_streamed(_resident_chunk_fn, nchunks, d, k, operands=ops, **kw)
    W_res, _ = run_lbfgs_gram_hybrid(_resident_chunk_fn, nchunks, ops, nchunks, d, k, **kw)
    W_none, _ = run_lbfgs_gram_hybrid(_resident_chunk_fn, 0, (), nchunks, d, k,
                                      chunk_fn=lambda cid: _resident_chunk_fn(cid, *ops),
                                      device="cpu", **kw)
    np.testing.assert_array_equal(W_full.numpy(), W_res.numpy())
    np.testing.assert_array_equal(W_full.numpy(), W_none.numpy())


def test_hybrid_validates_inputs():
    with pytest.raises(ValueError, match="row count n"):
        run_lbfgs_gram_hybrid(_resident_chunk_fn, 0, (), 2, 8, 1)
    with pytest.raises(ValueError, match="num_resident_chunks"):
        run_lbfgs_gram_hybrid(_resident_chunk_fn, 3, (), 2, 8, 1, n=16)
    with pytest.raises(ValueError, match="chunk_fn or segment_source"):
        run_lbfgs_gram_hybrid(_resident_chunk_fn, 0, (), 2, 8, 1, n=16)
    with pytest.raises(TypeError, match="must be a ShardSource"):
        run_lbfgs_gram_hybrid(_resident_chunk_fn, 0, (), 2, 8, 1, n=16,
                              segment_source=lambda cid0, seg: None)


def test_hybrid_folds_each_chunk_once(monkeypatch):
    # Ragged segments on both legs (5 resident, 7 streamed, segments of 3):
    # the phantom ids past each leg's end are not folded, so the fold's
    # kernel runs once a chunk, where the streamed fold pads its last
    # segment with zero chunks.
    from keystone_tpu_torch.ops import cuda_ops

    n, d, k, w, chunk = 1500, 40, 2, 3, 128
    chunks = CompressedCOOChunks.encode(*_coo(n, d, w, k, seed=8), chunk_rows=chunk, d=d,
                                        n_true=n)
    ops, nchunks = chunks.operands(), chunks.num_chunks
    assert nchunks == 12
    calls = []
    real = cuda_ops.gram_corr_sym_acc
    monkeypatch.setattr(cuda_ops, "gram_corr_sym_acc",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    kw = dict(lam=1e-2, num_iterations=6, n=n, val_dtype=torch.bfloat16,
              max_chunks_per_dispatch=3, pipeline=False)
    W_h, _ = run_lbfgs_gram_hybrid(_resident_chunk_fn, 5, ops, nchunks, d, k,
                                   segment_source=_TailSource(chunks, 5, 3, n),
                                   prefetch_depth=0, **kw)
    assert len(calls) == nchunks
    W_full, _ = run_lbfgs_gram_streamed(_resident_chunk_fn, nchunks, d, k, operands=ops, **kw)
    np.testing.assert_array_equal(W_full.numpy(), W_h.numpy())
