"""Shared fixtures of the port's serving tests (JAX-free, so the card-only
tests can use them): the port's tiny MNIST-shaped fit, a transformer that
counts its device function's calls, a gated host transformer, and the
one-transformer FittedPipeline. ``reference_tiny_mnist`` (which imports
the JAX package inside) carries the reference's tiny fit across."""

import threading

import numpy as np
import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.workflow import Transformer
from keystone_tpu_torch.workflow.pipeline import FittedPipeline, TransformerGraph

TINY_D_IN = 16


def fit_tiny_mnist(n=96, d_in=TINY_D_IN, num_ffts=2, block_size=16, seed=0, device="cpu"):
    """The port's own fit of ``tests/_serving_util.fit_tiny_mnist``'s
    pipeline (featurizer + BlockLS, one solver block); (fitted, X)."""
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels
    from keystone_tpu_torch.pipelines.mnist_random_fft import (
        MnistRandomFFTConfig,
        build_featurizer,
    )

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d_in)).astype(np.float32)
    y = rng.integers(0, 10, size=n)
    labels = ClassLabelIndicatorsFromIntLabels(10)(Dataset.of(torch.from_numpy(y).to(device)))
    cfg = MnistRandomFFTConfig(num_ffts=num_ffts, block_size=block_size, image_size=d_in)
    fitted = build_featurizer(cfg, device=device).and_then(
        BlockLeastSquaresEstimator(block_size, 1, 1e-3),
        Dataset.of(torch.from_numpy(X).to(device)), labels,
    ).fit()
    return fitted, X


def reference_tiny_mnist(**kw):
    """The reference's tiny fit (``tests/_serving_util.fit_tiny_mnist``)
    and the port's pipeline carrying its signs, block weights and feature
    scalers (through
    ``interop``); (reference fitted, port fitted, X)."""
    from keystone_tpu_torch import interop
    from keystone_tpu_torch.pipelines.mnist_random_fft import (
        MnistRandomFFTConfig,
        build_featurizer,
    )

    from keystone_tpu.ops.learning.block import BlockLinearMapper as JMapper
    from keystone_tpu.ops.stats import RandomSignNode as JSign
    from keystone_tpu.workflow.fusion import fused_members
    from tests._serving_util import fit_tiny_mnist as j_fit

    j_fitted, X = j_fit(**kw)
    (mapper,) = {id(m): m for o in j_fitted.transformer_graph.operators.values()
                 for m in fused_members(o) + [o] if isinstance(m, JMapper)}.values()
    # The reference's branch signs, in branch order (its config seed is 0).
    signs = [np.asarray(JSign.create(X.shape[1], seed=i).signs)
             for i in range(kw.get("num_ffts", 2))]
    nodes = [interop.random_sign_node(s, device="cpu") for s in signs]
    d_in = X.shape[1]
    cfg = MnistRandomFFTConfig(num_ffts=len(nodes), block_size=mapper.block_size,
                               image_size=d_in)
    t_mapper = interop.block_linear_mapper(
        [np.asarray(x) for x in mapper.xs], mapper.block_size,
        b_opt=None if mapper.b_opt is None else np.asarray(mapper.b_opt),
        feature_scalers=None if mapper.feature_scalers is None else [
            {"mean": np.asarray(sc.mean), "std": None if sc.std is None else np.asarray(sc.std)}
            for sc in mapper.feature_scalers],
        device="cpu")
    t_fitted = build_featurizer(cfg, device="cpu", sign_nodes=nodes).and_then(t_mapper).fit()
    return j_fitted, t_fitted, np.asarray(X, np.float32)


class CallCountingScale(Transformer):
    """Device-pure x -> 2x whose device function counts its calls (the
    port runs a device function eagerly: once per call on the CPU, and on
    the card once for the eager run and once for the capture of each
    bucket, never on a replay)."""

    def __init__(self):
        self.calls = 0

    def apply(self, x):
        return torch.as_tensor(x) * 2.0

    def device_fn(self):
        def fn(X):
            self.calls += 1
            return X * 2.0
        return fn


class GatedScale(Transformer):
    """Device-less x -> 3x whose batch path blocks on an Event — gives
    the tests deterministic control over when the worker is busy."""

    def __init__(self):
        self.gate = threading.Event()
        self.gate.set()
        self.batches = 0

    def apply(self, x):
        return torch.as_tensor(x) * 3.0

    def batch_apply(self, ds):
        self.gate.wait(timeout=10.0)
        self.batches += 1
        return Dataset(torch.as_tensor(ds.array) * 3.0, n=ds.n)


class Exploding(Transformer):
    """A host stage that raises while ``arm`` is set."""

    def __init__(self, message="plan down"):
        self.arm = True
        self.message = message

    def apply(self, x):
        return x

    def batch_apply(self, ds):
        if self.arm:
            raise ValueError(self.message)
        return ds


def fitted_from_transformer(t) -> FittedPipeline:
    """A single transformer as a FittedPipeline."""
    pipe = t.to_pipeline()
    return FittedPipeline(
        TransformerGraph.from_graph(pipe.executor.graph), pipe.source, pipe.sink
    )
