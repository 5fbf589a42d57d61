"""Shared fixtures of the port's continuous-learning tests (JAX-free):
tiny linear segments, a LinearMapper FittedPipeline wrapper, and a small
exported plan + 2-replica plane the lifecycle controller drives — the
port's twin of ``tests/_lifecycle_util.py``, on ``device="cpu"``."""

import numpy as np

from keystone_tpu_torch.ops.learning.linear import LinearMapper
from keystone_tpu_torch.serving import ReplicatedServer, export_plan
from keystone_tpu_torch.workflow.pipeline import FittedPipeline, TransformerGraph

D, K = 8, 3
MAX_BATCH = 32


def make_w_true(seed=0):
    return np.random.default_rng(seed).normal(size=(D, K)).astype(np.float32)


def make_segments(num, w_true, n=64, noise=0.01, seed=1):
    rng = np.random.default_rng(seed)
    segs = []
    for _ in range(num):
        X = rng.normal(size=(n, D)).astype(np.float32)
        y = (X @ w_true + noise * rng.normal(size=(n, K))).astype(np.float32)
        segs.append((X, y))
    return segs


def fitted_linear(W) -> FittedPipeline:
    pipe = LinearMapper(np.asarray(W, np.float32)).to_pipeline()
    return FittedPipeline(
        TransformerGraph.from_graph(pipe.executor.graph), pipe.source, pipe.sink,
    )


def solve_ridge(X, y, lam=1e-3):
    X64 = np.asarray(X, np.float64)
    return np.linalg.solve(
        X64.T @ X64 + lam * np.eye(X64.shape[1]), X64.T @ np.asarray(y, np.float64),
    ).astype(np.float32)


def export_small(fitted, max_batch=MAX_BATCH):
    return export_plan(fitted, np.zeros(D, np.float32), max_batch=max_batch, device="cpu")


def small_plane(plan, num_replicas=2, **kw):
    kw.setdefault("max_batch", MAX_BATCH)
    kw.setdefault("max_wait_ms", 1.0)
    return ReplicatedServer(plan, num_replicas=num_replicas, **kw)
