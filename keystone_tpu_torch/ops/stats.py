"""Statistical featurization nodes (reference: nodes/stats/).

Port of ``keystone_tpu/ops/stats.py`` (the nodes the TIMIT slice runs:
StandardScaler and the cosine random features, with the latter's
stage-fusion function; the padded real-FFT helpers of the block-SRHT
sketch, :func:`padded_pow2`, :func:`rfft_real_half` and
:func:`srht_chunk_sketch`, on ``torch.fft.rfft``; MnistRandomFFT's nodes,
RandomSignNode, PaddedFFT and LinearRectifier, with the packed-pair FFT
lowering of their gather, :func:`packed_fft_gather_fn`; the Fisher-vector
pipelines' SignedHellingerMapper and NormalizeRows; the text
pipelines' host-side TermFrequency; and the samplers, ColumnSampler,
:func:`sample_dataset` and Sampler). The FFTs are cuFFT through
``torch.fft`` on the card, as the reference's are XLA's: no Pallas kernel
stands behind them there, and no hand-written one here. Dense nodes operate
whole-batch on (n, d) tensors. Randomized nodes take explicit integer
seeds and draw from a ``torch.Generator`` seeded with them on the CPU, so
a seed gives the same draws on every device. (They are not the
reference's ``jax.random`` draws; tests carry the reference's weights
across through :mod:`keystone_tpu_torch.interop`.) A host-list dataset's
row sample is the reference's numpy ``default_rng(seed)`` draw, the same
rows in both packages.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from keystone_tpu_torch import resolve_device
from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.ops import cuda_ops
from keystone_tpu_torch.ops.util import FunctionNode
from keystone_tpu_torch.workflow import Estimator, Transformer


# ---------------------------------------------------------------------------
# StandardScaler
# ---------------------------------------------------------------------------


class StandardScalerModel(Transformer):
    """Subtract column means (and optionally divide by stds)
    (reference: nodes/stats/StandardScaler.scala:16-32)."""

    def __init__(self, mean, std=None):
        self.mean = as_tensor(mean)
        self.std = None if std is None else as_tensor(std, self.mean.device)

    def apply(self, x):
        out = as_tensor(x, self.mean.device) - self.mean
        if self.std is not None:
            out = out / self.std
        return out

    def batch_apply(self, data: Dataset) -> Dataset:
        if data.is_sharded:
            # Each shard on its own device, the statistics copied there.
            def shard_fn(X):
                out = X - self.mean.to(X.device)
                return out if self.std is None else out / self.std.to(X.device)

            return data.map_batch(shard_fn)
        return data.map_batch(self.apply)


class StandardScaler(Estimator):
    """Column mean/std in one pass over the rows
    (reference: nodes/stats/StandardScaler.scala:37-60)."""

    def __init__(self, normalize_std_dev: bool = True, eps: float = 1e-12):
        self.normalize_std_dev = normalize_std_dev
        self.eps = eps

    def fit(self, data: Dataset) -> StandardScalerModel:
        n = data.n
        if data.is_sharded:
            # Each shard's column sums, psum'd in shard order (the
            # reference's sharded reduction).
            from keystone_tpu_torch.parallel.mesh import psum

            shards = data.array.shards

            def colsum(fn):
                return psum([fn(X).sum(dim=0) for X in shards])
        else:
            X = as_tensor(data.array)

            def colsum(fn):
                return fn(X).sum(dim=0)
        # Padding rows are zero: sums are exact; divide by the true count.
        mean = colsum(lambda A: A) / n
        if not self.normalize_std_dev:
            return StandardScalerModel(mean)
        # Sample variance with the zero-padding correction:
        # sum((x - mean)^2) over real rows = sum(x^2) - n*mean^2.
        sumsq = colsum(lambda A: A * A)
        var = (sumsq - n * mean * mean) / max(n - 1, 1)
        std = torch.sqrt(torch.clamp(var, min=0.0))
        bad = torch.isnan(std) | torch.isinf(std) | (torch.abs(std) < self.eps)
        std = torch.where(bad, torch.ones_like(std), std)
        return StandardScalerModel(mean, std)


# ---------------------------------------------------------------------------
# Random features
# ---------------------------------------------------------------------------


class CosineRandomFeaturesModel(Transformer):
    """x -> cos(x Wᵀ + b): Rahimi-Recht random features
    (reference: nodes/stats/CosineRandomFeatures.scala:19-45).

    The batch path, and the stage-fusion function ``device_fn``, is the
    fused CUDA kernel ``cuda_ops.cosine_features`` (its plain version for
    CPU tensors). The reference's ``device_fn`` is XLA's ``cos(X Wᵀ + b)``
    because XLA fuses the cosine into the GEMM epilogue; eager PyTorch has
    no such fusion, and the hand-written kernel is this card's form of the
    same function. The single-datum ``apply`` stays plain ``torch.cos``, as
    the reference's stays ``jnp.cos``.
    """

    def __init__(self, W, b):
        self.W = as_tensor(W)
        self.b = as_tensor(b, self.W.device)
        if self.b.shape[0] != self.W.shape[0]:
            raise ValueError("# of rows in W and size of b should match")

    def apply(self, x):
        return torch.cos(as_tensor(x, self.W.device) @ self.W.T + self.b)

    def _batch_fn(self, X, out=None):
        return cuda_ops.cosine_features(
            as_tensor(X, self.W.device).contiguous(), self.W, self.b, out=out
        )

    def device_fn(self):
        """Stage-fusion contract (workflow/fusion.py): row-local cos-GEMM."""
        return self._batch_fn

    def batch_apply(self, data: Dataset) -> Dataset:
        """Row-sharded input runs the kernel on each shard, with W and b on
        the shard's device and no collective: the featurization is row
        parallel (reference ``ops/stats.py:112-130``)."""
        if data.is_sharded:
            return data.map_batch(lambda X: cuda_ops.cosine_features(
                X.contiguous(), self.W.to(X.device), self.b.to(X.device)))
        return super().batch_apply(data)

    def device_fn_into(self):
        """Gather-fusion contract for column-concatenated branches: the
        features are (width, dtype, device) and ``fn(X, out)`` writes them
        into ``out``, a column window of the gather's one feature matrix."""
        return self.W.shape[0], torch.float32, self.W.device, self._batch_fn


def CosineRandomFeatures(
    num_input_features: int,
    num_output_features: int,
    gamma: float,
    seed: int = 0,
    cauchy: bool = False,
    device=None,
) -> CosineRandomFeaturesModel:
    """Draw W ~ gaussian(·γ) (or cauchy(·γ)), b ~ U[0, 2π]
    (reference: CosineRandomFeatures.scala:50-61), on ``device``."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    shape = (num_output_features, num_input_features)
    if cauchy:
        W = torch.empty(shape).cauchy_(generator=gen) * gamma
    else:
        W = torch.randn(shape, generator=gen) * gamma
    b = torch.rand((num_output_features,), generator=gen) * (2 * math.pi)
    return CosineRandomFeaturesModel(W.to(device), b.to(device))


# ---------------------------------------------------------------------------
# Padded real FFT: the block-SRHT sketch's mixing step
# ---------------------------------------------------------------------------


def padded_pow2(n: int) -> int:
    """The FFT padding width every padded-FFT path shares: the next power
    of two ≥ n (minimum 2, so a width-1 input still has a non-trivial
    transform)."""
    return 1 << max(int(n - 1).bit_length(), 1)


def rfft_real_half(x: torch.Tensor, p: int, dim: int = -1) -> torch.Tensor:
    """Re(rfft(x))[bins 0..p/2) along ``dim``: the input is real and already
    padded to ``p``, and only the real parts of the first ``p // 2`` bins
    survive (DC included, Nyquist dropped), the reference's bin convention.
    On the card this is cuFFT through ``torch.fft``, as the reference's is
    XLA's FFT: no hand-written kernel stands behind either."""
    return torch.fft.rfft(x, dim=dim).real.narrow(dim, 0, p // 2)


def srht_chunk_sketch(dense_rows: torch.Tensor, signs: torch.Tensor,
                      sample_bins: torch.Tensor, scale: float) -> torch.Tensor:
    """One block-SRHT fold step (Drineas et al., "Faster Least Squares
    Approximation"): sign-flip the chunk's rows, zero-pad the row axis to a
    power of two, mix with the real FFT, keep Re of the first p/2 bins
    (:func:`rfft_real_half`) and gather the sampled bins.

    ``dense_rows (c, d)``, ``signs (c,)`` ±1, ``sample_bins (m_c,)`` in
    ``[0, p//2)``; returns ``scale · (m_c, d)`` float32. Stacking every
    chunk's sampled bins gives the block-diagonal SRHT ``S A`` of the whole
    row stream (``ops/learning/sketch.py``)."""
    c = dense_rows.shape[0]
    p = padded_pow2(c)
    Z = dense_rows * signs.to(dense_rows.dtype)[:, None]
    if p > c:
        Z = torch.cat([Z, Z.new_zeros((p - c, Z.shape[1]))])
    H = rfft_real_half(Z, p, dim=0)  # (p // 2, d)
    return scale * H[sample_bins.to(device=H.device, dtype=torch.int64)]


class PaddedFFT(Transformer):
    """Zero-pad to the next power of two, FFT, keep the real parts of the
    first half (reference: nodes/stats/PaddedFFT.scala:13-21): the input is
    real, and only Re(bins 0..p/2) survive (:func:`rfft_real_half`)."""

    def _padded_size(self, n: int) -> int:
        return padded_pow2(n)

    def apply(self, x):
        return self._batch_fn(as_tensor(x))

    def _batch_fn(self, X):
        p = self._padded_size(X.shape[-1])
        return rfft_real_half(torch.nn.functional.pad(X, (0, p - X.shape[-1])), p)

    def device_fn(self):
        return self._batch_fn


class RandomSignNode(Transformer):
    """Elementwise multiply by a fixed random ±1 vector
    (reference: nodes/stats/RandomSignNode.scala:11-24)."""

    def __init__(self, signs):
        self.signs = as_tensor(signs)

    @staticmethod
    def create(num_features: int, seed: int = 0, device=None) -> "RandomSignNode":
        """±1 signs drawn from a CPU ``torch.Generator`` seeded with
        ``seed``, on ``device`` (not the reference's ``jax.random``
        draws: :func:`keystone_tpu_torch.interop.random_sign_node` carries
        those across)."""
        gen = torch.Generator().manual_seed(seed)
        signs = 2.0 * torch.randint(0, 2, (num_features,), generator=gen).float() - 1.0
        return RandomSignNode(signs.to(resolve_device(device)))

    def apply(self, x):
        return as_tensor(x, self.signs.device) * self.signs

    def _batch_fn(self, X):
        return X * self.signs

    def device_fn(self):
        return self._batch_fn


class LinearRectifier(Transformer):
    """max(maxVal, x - alpha) (reference: nodes/stats/LinearRectifier.scala:12-17)."""

    def __init__(self, max_val: float = 0.0, alpha: float = 0.0):
        self.max_val = max_val
        self.alpha = alpha

    def apply(self, x):
        return self._batch_fn(as_tensor(x))

    def _batch_fn(self, X):
        return torch.clamp_min(X - self.alpha, self.max_val)

    def device_fn(self):
        return self._batch_fn


class SignedHellingerMapper(Transformer):
    """sign(x)·√|x| (reference: nodes/stats/SignedHellingerMapper.scala:11-22)."""

    def apply(self, x):
        return self._batch_fn(as_tensor(x))

    def _batch_fn(self, X):
        return torch.sign(X) * torch.sqrt(torch.abs(X))

    def device_fn(self):
        return self._batch_fn


class NormalizeRows(Transformer):
    """Divide by the L2 norm of the last axis, eps-floored
    (reference: nodes/stats/NormalizeRows.scala:10-14)."""

    def __init__(self, eps: float = 2.2e-16):
        self.eps = eps

    def apply(self, x):
        x = as_tensor(x)
        return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), self.eps)

    def device_fn(self):
        return self.apply


def packed_fft_gather_fn(branches, combiner):
    """The MnistRandomFFT gather — every branch [RandomSignNode → PaddedFFT
    → LinearRectifier] over one input, merged by a VectorCombiner — as one
    batch function, or None when the gather has another shape (the caller
    then composes branch by branch).

    Composed branch by branch, the gather reads X once a branch and runs
    one real FFT of width p each. This function reads X once, flips every
    branch's signs in one broadcast multiply, and packs branch pairs as the
    real and imaginary parts of one width-p complex FFT, unpacking
    Re(bins 0..p/2) by conjugate symmetry:

        Re A(k) = (Re Z(k) + Re Z((p−k) mod p)) / 2
        Re B(k) = (Im Z(k) + Im Z((p−k) mod p)) / 2

    An odd branch count leaves one real FFT. Then each branch's rectifier,
    and the branches' outputs in the combiner's order. Branch members may
    arrive wrapped in a FusedBatchTransformer (stage fusion runs before
    gather fusion); their ``members`` are read.
    """
    from keystone_tpu_torch.ops.util import VectorCombiner

    if not isinstance(combiner, VectorCombiner) or len(branches) < 2:
        return None
    flat = []
    for br in branches:
        members = []
        for m in br:
            sub = getattr(m, "members", None)
            members.extend(sub if sub is not None else [m])
        if len(members) != 3 or not (
            isinstance(members[0], RandomSignNode)
            and isinstance(members[1], PaddedFFT)
            and isinstance(members[2], LinearRectifier)
        ):
            return None
        flat.append(members)
    if len({int(m[0].signs.shape[0]) for m in flat}) != 1:
        return None
    d_in = int(flat[0][0].signs.shape[0])
    nb = len(flat)
    p = flat[0][1]._padded_size(d_in)
    h = p // 2
    signs = torch.stack([m[0].signs for m in flat])  # (nb, d_in)
    alphas = torch.tensor([float(m[2].alpha) for m in flat], device=signs.device)
    maxvals = torch.tensor([float(m[2].max_val) for m in flat], device=signs.device)
    npairs = nb // 2
    # Bin (p - k) mod p of each kept bin k.
    mirror = (-torch.arange(h, device=signs.device)) % p

    def fused(X):
        n = X.shape[0]
        Z = torch.nn.functional.pad(X[:, None, :] * signs, (0, p - d_in))  # (n, nb, p)
        outs = []
        if npairs:
            pairs = Z[:, :2 * npairs].reshape(n, npairs, 2, p)
            F = torch.fft.fft(torch.complex(pairs[:, :, 0], pairs[:, :, 1]), dim=-1)
            re, im = F.real, F.imag
            reA = 0.5 * (re[..., :h] + re[..., mirror])
            reB = 0.5 * (im[..., :h] + im[..., mirror])
            del F, re, im
            outs.append(torch.stack([reA, reB], dim=2).reshape(n, 2 * npairs, h))
        if nb % 2:
            outs.append(rfft_real_half(Z[:, -1], p)[:, None, :])
        halves = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
        out = torch.maximum(halves - alphas[None, :, None], maxvals[None, :, None])
        return out.reshape(n, nb * h)

    return fused


class TermFrequency(Transformer):
    """Seq of items -> {item: weighting(count)} (host-side;
    reference: nodes/stats/TermFrequency.scala:18-20)."""

    def __init__(self, weighting: Callable = lambda x: x):
        self.weighting = weighting

    def apply(self, items):
        counts = {}
        for item in items:
            counts[item] = counts.get(item, 0) + 1
        return {k: self.weighting(v) for k, v in counts.items()}

    def batch_apply(self, data: Dataset) -> Dataset:
        return Dataset.of([self.apply(x) for x in data.to_list()])

    def output_signature(self, sig):
        """Verifier declaration (host op): item sequences in, feature→
        weight dicts out. A bare string input is rejected — counting its
        CHARACTERS as terms is virtually always a missing-Tokenizer bug."""
        from keystone_tpu_torch.workflow.verify import HostSig, expect_host

        sig = expect_host(sig, ("tokens", "ngrams", "int_tokens"), self)
        return HostSig("tf_dict", n=sig.n, datum=sig.datum)


# ---------------------------------------------------------------------------
# Sampling (reference: nodes/stats/Sampling.scala:12-32)
# ---------------------------------------------------------------------------


def _generator(seed: int) -> torch.Generator:
    return torch.Generator(device="cpu").manual_seed(int(seed))


class ColumnSampler(Transformer):
    """Sample columns of per-item (d, cols) matrices, with replacement
    (reference: nodes/stats/Sampling.scala:12-25). The column indices are
    drawn on the CPU from a generator seeded with ``seed``, then gathered
    on the item's device."""

    def __init__(self, num_samples: int, seed: int = 0):
        self.num_samples = num_samples
        self.seed = seed

    def apply(self, x):
        x = as_tensor(x)
        idx = torch.randint(0, x.shape[1], (self.num_samples,), generator=_generator(self.seed))
        return x[:, idx.to(x.device)]


def sample_dataset(data: Dataset, num_items: int, seed: int = 0) -> Dataset:
    """Random row sample without replacement, ``min(num_items, n)`` rows
    (the RDD.takeSample FunctionNode, reference:
    nodes/stats/Sampling.scala:27-32). A host-list dataset draws the
    reference's numpy ``default_rng(seed).choice``; an array dataset a
    permutation from a generator seeded with ``seed``, gathered on its
    device."""
    k = min(num_items, data.n)
    if data.is_host:
        rng = np.random.default_rng(seed)
        items = data.to_list()
        idx = rng.choice(len(items), size=k, replace=False)
        return Dataset.of([items[i] for i in idx])
    X = as_tensor(data.array)[: data.n]
    idx = torch.randperm(data.n, generator=_generator(seed))[:k]
    return Dataset(X[idx.to(X.device)], n=k)


class Sampler(FunctionNode):
    """Dataset-level row sampler, outside graph tracking as the reference's
    is (reference: nodes/stats/Sampling.scala:27-32)."""

    def __init__(self, size: int, seed: int = 0):
        self.size = size
        self.seed = seed

    def apply(self, data: Dataset) -> Dataset:
        return sample_dataset(data, self.size, self.seed)
