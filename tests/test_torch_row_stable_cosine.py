"""Row-stable products on the streamed and cosine routes (ROADMAP C.10's
parts on the disk tier's path), on the CPU and on the card.

  - ``cosine_features_ref`` sums its pre-activation on the CPU as one
    fused multiply-add chain an output, in index order (the native
    library's ``matmul_fma_chain_f32``), so a row's bits depend on that
    row, W and b alone: the rows of a 2-row, a 7-row and a 256-row call are
    bit-equal. An MKL product sums in an order it picks by the batch's
    shape, which split a cosine plan's padding buckets (by 2.4e-7) and made
    the lifecycle gate's dry run reject a good cosine candidate on the CPU.
  - the lifecycle gate now accepts a cosine candidate on the CPU: every
    padding bucket of its plan serves a row the same bits.
  - ``streaming_predict`` takes the mappers' product
    (``linear.mapper_product``), so a row predicted in a full tile and in
    the ragged last tile is bit-equal (the disk tier's model predicts
    through it).

The ``cuda`` cases hold the kernels to the same properties on the card
and skip without one. The file imports neither JAX nor the JAX package:
``python -m pytest tests/test_torch_row_stable_cosine.py -m cuda
--noconftest`` runs it on the card's machine.
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.ops import cuda_ops
from keystone_tpu_torch.ops.learning.linear import LinearMapper
from keystone_tpu_torch.ops.learning.streaming_ls import CosineBankFeaturize
from keystone_tpu_torch.ops.stats import CosineRandomFeatures
from keystone_tpu_torch.parallel import streaming
from keystone_tpu_torch.serving import LifecycleController, ReplicatedServer, export_plan
from keystone_tpu_torch.serving.lifecycle import _bucket_identity_mismatch
from keystone_tpu_torch.workflow.pipeline import FittedPipeline, TransformerGraph

D_IN, D_FEAT, K = 64, 256, 3


def _operands(device="cpu", rows=256, d_in=440, d_out=1024, seed=0):
    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.normal(size=(rows, d_in)).astype(np.float32)).to(device)
    W = torch.from_numpy((0.05 * rng.normal(size=(d_out, d_in))).astype(np.float32)).to(device)
    b = torch.from_numpy(rng.uniform(0, 2 * np.pi, d_out).astype(np.float32)).to(device)
    return X, W, b


def _cosine_plan(seed, device="cpu"):
    crf = CosineRandomFeatures(D_IN, D_FEAT, 0.05, seed=seed, device=device)
    W = np.random.default_rng(seed + 10).normal(size=(D_FEAT, K)).astype(np.float32)
    pipe = crf.to_pipeline().and_then(LinearMapper(torch.from_numpy(W).to(device)))
    fitted = FittedPipeline(TransformerGraph.from_graph(pipe.executor.graph), pipe.source,
                            pipe.sink)
    return export_plan(fitted, np.zeros(D_IN, np.float32), max_batch=32, device=device)


def _row_counts_agree(fn, X):
    whole = fn(X)
    for m in (2, 7):
        assert torch.equal(fn(X[:m]), whole[:m]), m
    # A row's bits do not follow its position either.
    assert torch.equal(fn(X[100:107]), whole[100:107])


class TestCosineRows:
    def test_plain_version_rows_equal_across_row_counts(self):
        X, W, b = _operands()
        _row_counts_agree(lambda A: cuda_ops.cosine_features_ref(A, W, b), X)

    def test_plain_version_within_its_rounding_of_cos(self):
        # A float32 multiply-add chain over k = 440 inputs and the bias add
        # round at most (k + 1) times; the polynomial adds 4e-7.
        X, W, b = _operands(rows=64)
        got = cuda_ops.cosine_features_ref(X, W, b).double()
        want = torch.cos(X.double() @ W.double().T + b.double())
        scale = X.double().abs() @ W.double().abs().T + b.double().abs()
        assert bool(((got - want).abs() <= 441 * 2.0**-24 * scale + 4e-7).all())


class TestCosineGate:
    def test_every_bucket_of_a_cosine_plan_agrees(self):
        assert _bucket_identity_mismatch(_cosine_plan(1)) is None

    def test_lifecycle_gate_accepts_a_cosine_candidate(self):
        plan0 = _cosine_plan(1)
        plane = ReplicatedServer(plan0, num_replicas=2, max_batch=32, max_wait_ms=1.0)
        try:
            ctl = LifecycleController(plane, plan0, canary_sustain_s=0.0,
                                      attribution_window_s=30.0)
            candidate = _cosine_plan(2)
            result = ctl.offer(candidate)
            assert result["reason"] != "bucket_bit_identity", result
            assert result["published"] is True, result
            assert ctl.incumbent_fingerprint == candidate.fingerprint
        finally:
            plane.close()


def _predict_rows_agree(device):
    rng = np.random.default_rng(3)
    n, tile = 300, 128
    X = torch.from_numpy(rng.normal(size=(n, D_IN)).astype(np.float32)).to(device)
    W = torch.from_numpy((0.2 * rng.normal(size=(D_FEAT, D_IN))).astype(np.float32)).to(device)
    b = torch.from_numpy(rng.uniform(0, 6, D_FEAT).astype(np.float32)).to(device)
    bank = CosineBankFeaturize(W, b)
    Wm = torch.from_numpy(rng.normal(size=(2, D_FEAT // 2, K)).astype(np.float32)).to(device)
    whole = streaming.streaming_predict(X, Wm, bank, tile)
    # Rows 256..299 form the ragged last tile (44 rows); shifted by 172
    # they land in a full 128-row tile.
    shifted = streaming.streaming_predict(X[172:], Wm, bank, tile)
    assert torch.equal(whole[256:], shifted[84:])
    # and a row's bits in a one-row tile too
    assert torch.equal(streaming.streaming_predict(X[299:], Wm, bank, tile)[0], whole[299])


class TestStreamingPredict:
    def test_ragged_tile_rows_equal_full_tile_rows(self):
        _predict_rows_agree("cpu")


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs an NVIDIA GPU")
class TestOnCard:
    def test_kernel_rows_equal_across_row_counts(self):
        X, W, b = _operands("cuda")
        _row_counts_agree(lambda A: cuda_ops.cosine_features(A, W, b), X)

    def test_predict_ragged_tile_rows_on_card(self):
        _predict_rows_agree("cuda")
