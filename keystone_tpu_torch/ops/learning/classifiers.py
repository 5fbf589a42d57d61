"""Probabilistic and discriminant classifiers: multinomial naive Bayes,
softmax (logistic) regression by L-BFGS, and multi-class LDA.

Port of ``keystone_tpu/ops/learning/classifiers.py`` (reference:
nodes/learning/NaiveBayesModel.scala:21-69,
LinearDiscriminantAnalysis.scala:17-68 and
LogisticRegressionModel.scala:42-94, which wraps MLlib's
LogisticRegressionWithLBFGS; the JAX package runs ``optax.lbfgs()`` with
its zoom line search under a ``while_loop``). :func:`logistic_lbfgs` is that
algorithm step for step in plain PyTorch, with optax 0.2.6's defaults:
memory 10, the initial inverse Hessian scaled by the last secant pair (on
the first step the reciprocal of the gradient's norm, capped at 1), and
the zoom line search (Nocedal & Wright, Algorithms 3.5 and 3.6) with at
most 20 steps, a first guess of 1, slope_rtol 1e-4, curv_rtol 0.9,
approx_dec_rtol 1e-6, increase factor 2 and an interval threshold of
1e-5. The products, sums and the loss run on the operands' device; the line
search's scalar decisions are read on the host, one read a trial step.

:class:`NaiveBayesEstimator` densifies its rows on the labels' device, as
the reference densifies them, and fits in their dtype (float32 from the
sparse text features); :class:`LinearDiscriminantAnalysis` is host numpy
in float64, as in the reference.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.ops.learning.linear import LinearMapper
from keystone_tpu_torch.ops.sparse import _coo, _dense_rows, is_sparse_dataset
from keystone_tpu_torch.workflow import LabelEstimator, Transformer

logger = logging.getLogger("keystone_tpu_torch.classifiers")

MEMORY = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL, CURV_RTOL, APPROX_DEC_RTOL = 1e-4, 0.9, 1e-6
INCREASE_FACTOR, INTERVAL_THRESHOLD = 2.0, 1e-5


def _dense_on(data: Dataset, d: Optional[int], device, dtype=torch.float32) -> torch.Tensor:
    """A dense or padded-COO batch as a dense (n, d) tensor of ``dtype`` on
    ``device`` (the COO is moved first and densified there; d None: the
    largest index + 1). ``dtype=None`` keeps the values' dtype."""
    if not is_sparse_dataset(data):
        X = as_tensor(data.array, device)
        return X if dtype is None else X.to(dtype)
    indices, values = (t.to(device) for t in _coo(data))
    if d is None:
        d = int(indices.max()) + 1
    return _dense_rows(indices, values, d, values.dtype if dtype is None else dtype)


class NaiveBayesModel(Transformer):
    """x -> log-prior + log-likelihood·x, the unnormalised class
    log-posteriors (reference: NaiveBayesModel.scala:21-54)."""

    def __init__(self, pi, theta):
        self.pi = as_tensor(pi)  # (k,) log priors, indexed by class
        self.theta = as_tensor(theta, self.pi.device)  # (k, d) log feature likelihoods

    def apply(self, x):
        return self.pi + self.theta @ as_tensor(x, self.theta.device).to(self.theta.dtype)

    def batch_apply(self, data: Dataset) -> Dataset:
        X = _dense_on(data, self.theta.shape[1], self.theta.device, self.theta.dtype)
        return Dataset(X @ self.theta.T + self.pi, n=data.n)._rezero_padding()


class NaiveBayesEstimator(LabelEstimator):
    """Multinomial naive Bayes with additive smoothing λ
    (reference: NaiveBayesModel.scala:56-69, MLlib's NaiveBayes.train). The
    rows are densified on the labels' device in their own dtype; padding
    rows are masked out of the class counts and feature sums."""

    def __init__(self, num_classes: int, lam: float = 1.0):
        self.num_classes = num_classes
        self.lam = lam

    def fit(self, data: Dataset, labels: Dataset) -> NaiveBayesModel:
        y = as_tensor(labels.array).reshape(-1).long()
        X = _dense_on(data, None, y.device, None)
        y = torch.nn.functional.pad(y, (0, X.shape[0] - y.shape[0]))
        onehot = torch.nn.functional.one_hot(y, self.num_classes).to(X.dtype)
        mask = (torch.arange(X.shape[0], device=X.device) < data.n).to(X.dtype)
        onehot = onehot * mask[:, None]

        class_counts = onehot.sum(dim=0)  # (k,)
        feature_sums = onehot.T @ X  # (k, d)
        pi = torch.log(class_counts + self.lam) - math.log(
            data.n + self.num_classes * self.lam)
        d = X.shape[1]
        theta = torch.log(feature_sums + self.lam) - torch.log(
            feature_sums.sum(dim=1, keepdim=True) + d * self.lam)
        return NaiveBayesModel(pi, theta)


class LogisticRegressionModel(Transformer):
    """x -> argmax class under softmax weights
    (reference: LogisticRegressionModel.scala:27-40)."""

    def __init__(self, weights):
        self.weights = as_tensor(weights)  # (d, k)

    def apply(self, x):
        return torch.argmax(as_tensor(x, self.weights.device) @ self.weights, dim=-1)

    def batch_apply(self, data: Dataset) -> Dataset:
        X = _dense_on(data, self.weights.shape[0], self.weights.device)
        return Dataset(torch.argmax(X @ self.weights, dim=-1), n=data.n)


def logistic_loss_and_grad(X, onehot, mask, W, n, lam):
    """The masked multinomial negative log-likelihood over n rows plus
    λ/2 ‖W‖², and its gradient: padding rows (mask 0) leave the
    log-sum-exp out (the reference's ``loss_fn``)."""
    logits = X @ W
    lse = torch.logsumexp(logits, dim=1)
    ll = (logits * onehot).sum(dim=1) - lse * mask
    value = -ll.sum() / n + 0.5 * lam * (W * W).sum()
    probs = torch.softmax(logits, dim=1) * mask[:, None]
    grad = X.T @ ((probs - onehot) / n) + lam * W
    return value, grad


def _vdot(a, b):
    return (a * b).sum()


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Minimizer of the cubic through (a, fa) with slope fpa at a, (b, fb)
    and (c, fc) (optax's ``_cubicmin``)."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    d1 = torch.stack([torch.stack([dc ** 2, -(db ** 2)]), torch.stack([-(dc ** 3), db ** 3])])
    A, B = (d1 @ torch.stack([fb - fa - C * db, fc - fa - C * dc])) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Minimizer of the quadratic through (a, fa) with slope fpa at a, and
    (b, fb) (optax's ``_quadmin``)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    err = value - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = torch.maximum(slope - (2 * SLOPE_RTOL - 1.0) * slope_init,
                           value - value_init - APPROX_DEC_RTOL * torch.abs(value_init))
    err = torch.clamp_min(torch.minimum(approx, err), 0.0)
    return torch.where(torch.isnan(err), torch.full_like(err, math.inf), err)


def _curvature_error(slope, slope_init):
    err = torch.clamp_min(torch.abs(slope) - CURV_RTOL * torch.abs(slope_init), 0.0)
    return torch.where(torch.isnan(err), torch.full_like(err, math.inf), err)


def zoom_linesearch(value_and_grad, W, updates, value, grad):
    """A stepsize along ``updates`` from W that meets the strong Wolfe
    conditions, and the value and gradient there: optax's
    ``scale_by_zoom_linesearch`` with ``initial_guess_strategy='one'``,
    ``tol`` 0 and no largest stepsize. Returns (stepsize, value, grad,
    trial steps)."""
    zero = torch.zeros((), dtype=value.dtype, device=value.device)

    def on_line(step):
        v, g = value_and_grad(W + step * updates)
        return v, g, _vdot(g, updates)

    slope = _vdot(updates, grad)
    value_init, slope_init = value, slope
    stepsize, cur_value, cur_grad, cur_slope = zero, value, grad, slope
    low, value_low, slope_low = zero, value, slope
    high, value_high, slope_high = zero, value, slope
    cubic_ref, value_cubic_ref = zero, value
    safe_stepsize, safe_value, safe_grad = zero, value, grad
    decrease_error = torch.full_like(value, math.inf)
    interval_found = done = failed = False
    count = 0
    while not (done or failed):
        if not interval_found:
            # Search for an interval that holds a point meeting both conditions.
            new = torch.ones_like(value) if count == 0 else INCREASE_FACTOR * stepsize
            v, g, s = on_line(new)
            decrease_error = _decrease_error(new, v, s, value_init, slope_init)
            new_error = torch.maximum(decrease_error, _curvature_error(s, slope_init))
            if bool(decrease_error <= 0.0):
                safe_stepsize, safe_value, safe_grad = new, v, g
            set_high = bool(decrease_error > 0.0) or (bool(v >= cur_value) and count > 0)
            set_low = bool(s >= 0.0) and not set_high
            if set_low:
                low, value_low, slope_low, high, value_high, slope_high = (
                    new, v, s, stepsize, cur_value, cur_slope)
            else:
                low, value_low, slope_low, high, value_high, slope_high = (
                    stepsize, cur_value, cur_slope, new, v, s)
            done = bool(new_error <= 0.0)
            interval_found = set_high or set_low or done
            failed = count + 1 >= MAX_LINESEARCH_STEPS and not done
            cubic_ref, value_cubic_ref = low, value_low
            stepsize, cur_value, cur_grad, cur_slope = new, v, g, s
        else:
            # Zoom into [low, high] by cubic, quadratic or bisection steps.
            delta = torch.abs(high - low)
            left, right = torch.minimum(high, low), torch.maximum(high, low)
            too_small = bool(delta <= INTERVAL_THRESHOLD)
            cubic = _cubicmin(low, value_low, slope_low, high, value_high, cubic_ref,
                              value_cubic_ref)
            quad = _quadmin(low, value_low, slope_low, high, value_high)
            if bool((cubic > left + 0.2 * delta) & (cubic < right - 0.2 * delta)):
                middle = cubic
            elif bool((quad > left + 0.1 * delta) & (quad < right - 0.1 * delta)):
                middle = quad
            else:
                middle = (low + high) / 2.0
            v, g, s = on_line(middle)
            decrease_error = _decrease_error(middle, v, s, value_init, slope_init)
            new_error = torch.maximum(decrease_error, _curvature_error(s, slope_init))
            if bool(decrease_error <= 0.0) and bool(v < safe_value):
                safe_stepsize, safe_value, safe_grad = middle, v, g
            done = bool(new_error <= 0.0)
            set_high_to_middle = bool(decrease_error > 0.0) or bool(v >= value_low)
            set_high_to_low = bool(s * (high - low) >= 0.0) and not set_high_to_middle
            old_low = (low, value_low, slope_low)
            old_high = (high, value_high)
            if set_high_to_middle:
                high, value_high, slope_high = middle, v, s
            if set_high_to_low:
                high, value_high, slope_high = old_low
            if not set_high_to_middle:
                low, value_low, slope_low = middle, v, s
            cubic_ref, value_cubic_ref = (
                old_high if set_high_to_middle or set_high_to_low else old_low[:2])
            failed = (count + 1 >= MAX_LINESEARCH_STEPS
                      or (too_small and bool(safe_stepsize > 0.0))) and not done
            stepsize, cur_value, cur_grad, cur_slope = middle, v, g, s
        count += 1
        if failed and (bool(safe_stepsize > 0.0) or bool(torch.isinf(decrease_error))):
            # No point met both conditions: take the safe step (or stay put,
            # its stepsize 0, where no trial point was finite).
            stepsize, cur_value, cur_grad = safe_stepsize, safe_value, safe_grad
    return stepsize, cur_value, cur_grad, count


def _precondition(grad, dW, dG, rho, scale, idx):
    """The L-BFGS two-loop product of the inverse Hessian estimate with
    ``grad``, over the memory slots from the oldest (idx) round to the
    newest (optax's ``_precondition_by_lbfgs``)."""
    m = rho.shape[0]
    order = [(idx + j) % m for j in range(m)]
    vec, alphas = grad, {}
    for j in reversed(order):
        alphas[j] = rho[j] * _vdot(dW[j], vec)
        vec = vec - alphas[j] * dG[j]
    vec = scale * vec
    for j in order:
        beta = rho[j] * _vdot(dG[j], vec)
        vec = vec + (alphas[j] - beta) * dW[j]
    return vec


@dataclass
class LBFGSResult:
    """What :func:`logistic_lbfgs` returns: the weights, the final loss (at
    the weights, recomputed), the steps taken, the loss after each step and
    the line search's trial steps each step took."""

    W: torch.Tensor
    loss: float
    iterations: int
    losses: List[float] = field(default_factory=list)
    linesearch_steps: List[int] = field(default_factory=list)


def logistic_lbfgs(X, onehot, mask, W0, n, lam: float, num_iters: int,
                   tol: float) -> LBFGSResult:
    """Minimize :func:`logistic_loss_and_grad` from W0 by optax's L-BFGS as
    the reference's ``_logistic_lbfgs`` drives it: before each step the
    loop stops once ``num_iters`` steps are taken or the norm of the
    gradient it carries — the one the last step started from, the
    gradient at W0 before the first — is at most ``tol``."""

    def value_and_grad(W):
        return logistic_loss_and_grad(X, onehot, mask, W, n, lam)

    m = MEMORY
    W = W0
    dW = torch.zeros((m,) + W0.shape, dtype=W0.dtype, device=W0.device)
    dG = torch.zeros_like(dW)
    rho = torch.zeros((m,), dtype=W0.dtype, device=W0.device)
    prev_W, prev_g = torch.zeros_like(W0), torch.zeros_like(W0)
    carried = value_and_grad(W0)[1]
    value = grad = None  # the line search's last point: where the next step starts
    out = LBFGSResult(W0, 0.0, 0)
    count = 0
    while count < num_iters and bool(torch.linalg.vector_norm(carried) > tol):
        if value is None or not bool(torch.isfinite(value)):
            value, grad = value_and_grad(W)
        # The secant pair of the last step, into the slot before this one.
        idx, prev = count % m, (count - 1) % m
        if count > 0:
            s, y = W - prev_W, grad - prev_g
            sy = _vdot(y, s)
            dW[prev], dG[prev] = s, y
            rho[prev] = torch.where(sy == 0.0, torch.zeros_like(sy), 1.0 / sy)
            yy = _vdot(y, y)
            scale = torch.where(yy > 0.0, sy / yy, torch.ones_like(sy))
        else:
            dW[prev], dG[prev], rho[prev] = 0.0, 0.0, 0.0
            scale = torch.clamp_max(1.0 / torch.linalg.vector_norm(grad), 1.0)
        direction = -_precondition(grad, dW, dG, rho, scale, idx)
        prev_W, prev_g = W, grad
        step, new_value, new_grad, trials = zoom_linesearch(
            value_and_grad, W, direction, value, grad)
        W = W + step * direction
        carried = grad
        value, grad = new_value, new_grad
        count += 1
        out.losses.append(float(new_value))
        out.linesearch_steps.append(trials)
    out.W, out.iterations = W, count
    out.loss = float(value_and_grad(W)[0])
    return out


class LogisticRegressionEstimator(LabelEstimator):
    """Softmax regression by L-BFGS over the whole batch, the in-tree
    replacement for MLlib's LogisticRegressionWithLBFGS
    (reference: LogisticRegressionModel.scala:42-94). The fit runs on the
    labels' device (the loaders put them on the pipeline's); sparse
    (padded-COO) rows are densified there to ``num_features`` columns
    (default: the largest index + 1). ``last_fit`` holds the last run."""

    def __init__(self, num_classes: int, reg_param: float = 0.0, num_iters: int = 100,
                 convergence_tol: float = 1e-4, num_features: Optional[int] = None):
        self.num_classes = num_classes
        self.reg_param = reg_param
        self.num_iters = num_iters
        self.convergence_tol = convergence_tol
        self.num_features = num_features
        self.last_fit: Optional[LBFGSResult] = None

    @property
    def weight(self) -> int:
        return self.num_iters + 1

    def fit(self, data: Dataset, labels: Dataset) -> LogisticRegressionModel:
        y = as_tensor(labels.array).reshape(-1).long()
        device = y.device
        X = _dense_on(data, self.num_features, device)
        n = data.n
        mask = (torch.arange(X.shape[0], device=device) < n).to(X.dtype)
        onehot = torch.nn.functional.one_hot(y, self.num_classes).to(X.dtype) * mask[:, None]
        W0 = torch.zeros((X.shape[1], self.num_classes), dtype=X.dtype, device=device)
        result = logistic_lbfgs(X, onehot, mask, W0, float(n), self.reg_param, self.num_iters,
                                self.convergence_tol)
        self.last_fit = result
        logger.info("logistic final loss: %s (%d L-BFGS steps)", result.loss, result.iterations)
        return LogisticRegressionModel(result.W)


class LinearDiscriminantAnalysis(LabelEstimator):
    """Multi-class LDA: the top eigenvectors of Sw⁻¹·Sb, host numpy in
    float64 (reference: LinearDiscriminantAnalysis.scala:17-68). The
    projection goes back to the rows' device."""

    def __init__(self, num_dimensions: int):
        self.num_dimensions = num_dimensions

    def fit(self, data: Dataset, labels: Dataset) -> LinearMapper:
        device = as_tensor(data.array).device
        X = np.asarray(data.to_numpy(), dtype=np.float64)
        y = np.asarray(labels.to_numpy()).reshape(-1).astype(np.int64)
        classes = np.unique(y)
        d = X.shape[1]
        total_mean = X.mean(axis=0)

        Sw = np.zeros((d, d))
        Sb = np.zeros((d, d))
        for c in classes:
            Xc = X[y == c]
            mu = Xc.mean(axis=0)
            centered = Xc - mu
            Sw += centered.T @ centered
            m = (mu - total_mean)[:, None]
            Sb += Xc.shape[0] * (m @ m.T)

        eigvals, eigvecs = np.linalg.eig(np.linalg.solve(Sw, Sb))
        order = np.argsort(-np.abs(eigvals))[: self.num_dimensions]
        W = np.real(eigvecs[:, order])
        return LinearMapper(torch.from_numpy(np.ascontiguousarray(W)).to(device))
