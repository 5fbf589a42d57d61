"""The CIFAR slice's three CUDA kernels — gaussian_kernel_block,
gaussian_resid_block (keystone_tpu_torch/ops/cuda_ops.py) and
conv_featurize (keystone_tpu_torch/ops/cuda_images.py) — against their
plain versions, and their wrappers' contract.

This file imports no JAX, so that it runs on the machine with the card,
which has none: ``python -m pytest tests/test_torch_cifar_kernels.py -m cuda
--noconftest``. The ``cuda`` tests skip without a card; the plain versions
are held against the JAX package in tests/test_torch_kernel_ridge.py and
tests/test_torch_images.py.

Tolerances (kernel against plain version, same inputs on the card):
  - Gaussian kernel entries: 1e-5 absolute (K lies in [0, 1]; the two
    float32 cross terms sum d products in different orders);
  - residuals: 1e-5 of the sum's scale, max over entries of Kᵀ|W|;
  - convolution: 1e-5 of the largest output (float32 patch statistics and
    products summed in different orders).
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.ops import cuda_images, cuda_ops


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _gauss(m, n, d, k=None, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    X = _t(rng.normal(size=(m, d)).astype(np.float32) / np.sqrt(d)).to(device)
    Y = _t(rng.normal(size=(n, d)).astype(np.float32) / np.sqrt(d)).to(device)
    W = None if k is None else _t(rng.normal(size=(m, k)).astype(np.float32)).to(device)
    return X, Y, (X * X).sum(1), (Y * Y).sum(1), W


def _conv_inputs(n, X, Y, C, p, k, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    images = _t(rng.uniform(0, 255, size=(n, X, Y, C)).astype(np.float32)).to(device)
    filters = _t(rng.normal(size=(k, p * p * C)).astype(np.float32)).to(device)
    means = _t(rng.normal(size=(p * p * C,)).astype(np.float32)).to(device)
    return images, filters, means


# ---------------------------------------------------------------------------
# Contract, on the CPU
# ---------------------------------------------------------------------------


class TestContract:
    def test_counters_exist_beside_the_others(self):
        for name in ("gaussian_kernel_block", "gaussian_resid_block", "conv_featurize"):
            assert isinstance(cuda_ops.launches[name], int)
            assert name in cuda_ops._ENTRY_POINTS
        cuda_ops.launches["conv_featurize"] += 2
        cuda_ops.reset_launch_counts()
        assert cuda_ops.launches["conv_featurize"] == 0

    def test_compute_dtype_is_checked(self):
        X, Y, xn, yn, _ = _gauss(8, 4, 3)
        with pytest.raises(TypeError, match="compute_dtype"):
            cuda_ops.gaussian_kernel_block(X, Y, xn, yn, 0.1, compute_dtype=torch.float16)

    def test_non_cpu_non_cuda_tensors_raise(self):
        X = torch.empty((4, 3), device="meta")
        n = torch.empty((4,), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            cuda_ops.gaussian_kernel_block(X, X, n, n, 0.1)
        with pytest.raises(ValueError, match="CUDA"):
            cuda_ops.gaussian_resid_block(X, X, n, n, torch.empty((4, 2), device="meta"), 0.1)
        with pytest.raises(ValueError, match="CUDA"):
            cuda_images.conv_featurize(torch.empty((2, 8, 8, 3), device="meta"),
                                       torch.empty((4, 27), device="meta"), patch_size=3)

    def test_guard_is_sized_for_shared_memory(self):
        images = torch.empty((2, 32, 32, 3))
        assert cuda_images._smem_bytes(32, 32, 3, 6, 100) == 96176  # CIFAR: two blocks an SM
        assert cuda_images.conv_featurize_ok(images, torch.empty((100, 108)))
        assert cuda_images.conv_featurize_ok(images, torch.empty((256, 108)))
        assert not cuda_images.conv_featurize_ok(images, torch.empty((512, 108)))  # 304 KB
        assert not cuda_images.conv_featurize_ok(images, torch.empty((8, 100)))  # not p*p*C
        assert not cuda_images.conv_featurize_ok(torch.empty((2, 4, 4, 3)),
                                                 torch.empty((8, 108)))  # image < patch
        assert not cuda_images.conv_featurize_ok(torch.empty((32, 32, 3)),
                                                 torch.empty((8, 108)))  # not a batch

    def test_wrappers_take_plain_versions_on_cpu(self):
        X, Y, xn, yn, W = _gauss(30, 20, 7, k=3)
        images, filters, means = _conv_inputs(2, 9, 9, 2, 3, 4)
        before = dict(cuda_ops.launches)
        assert torch.equal(cuda_ops.gaussian_kernel_block(X, Y, xn, yn, 0.3),
                           cuda_ops.gaussian_kernel_block_ref(X, Y, xn, yn, 0.3))
        assert torch.equal(cuda_ops.gaussian_resid_block(X, Y, xn, yn, W, 0.3),
                           cuda_ops.gaussian_resid_block_ref(X, Y, xn, yn, W, 0.3))
        assert torch.equal(
            cuda_images.conv_featurize(images, filters, means, patch_size=3),
            cuda_images.conv_featurize_ref(images, filters, means, patch_size=3))
        assert cuda_ops.launches == before

    def test_plain_resid_is_the_contracted_kernel_block(self):
        X, Y, xn, yn, W = _gauss(50, 17, 9, k=4, seed=1)
        K = cuda_ops.gaussian_kernel_block_ref(X, Y, xn, yn, 0.5)
        torch.testing.assert_close(cuda_ops.gaussian_resid_block_ref(X, Y, xn, yn, W, 0.5),
                                   K.T @ W)
        assert float(K.max()) <= 1.0 and float(K.min()) >= 0.0


# ---------------------------------------------------------------------------
# Kernel against plain version: needs the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


GAUSS_SHAPES = [(37, 45, 23), (200, 130, 70), (129, 257, 9), (1, 1, 1), (1030, 513, 1800)]
RESID_SHAPES = [(300, 40, 30, 5), (130, 129, 17, 1), (517, 200, 12, 35), (5000, 512, 300, 10)]
CONV_SHAPES = [(3, 12, 10, 3, 5, 5), (2, 9, 9, 2, 3, 4), (2, 12, 11, 3, 6, 130),
               (37, 32, 32, 3, 6, 100)]


@pytest.mark.cuda
class TestKernelsOnCard:
    @pytest.mark.parametrize("m,n,d", GAUSS_SHAPES)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_gaussian_kernel_block(self, cuda_device, m, n, d, dtype):
        X, Y, xn, yn, _ = _gauss(m, n, d, device=cuda_device)
        before = cuda_ops.launches["gaussian_kernel_block"]
        got = cuda_ops.gaussian_kernel_block(X, Y, xn, yn, 0.7, compute_dtype=dtype)
        torch.cuda.synchronize()
        assert cuda_ops.launches["gaussian_kernel_block"] == before + 1
        want = cuda_ops.gaussian_kernel_block_ref(X, Y, xn, yn, 0.7, compute_dtype=dtype)
        assert got.shape == (m, n) and got.dtype == torch.float32
        assert (got - want).abs().max().item() <= 1e-5

    def test_row_slices_are_read_in_place(self, cuda_device):
        X, _, xn, _, _ = _gauss(700, 1, 300, device=cuda_device)
        got = cuda_ops.gaussian_kernel_block(X, X[128:640], xn, xn[128:640], 0.7)
        want = cuda_ops.gaussian_kernel_block_ref(X, X[128:640], xn, xn[128:640], 0.7)
        assert (got - want).abs().max().item() <= 1e-5
        # The diagonal of K(X_b, X_b) stays at or below 1 (the clamp).
        diag = cuda_ops.gaussian_kernel_block(X[:512], X[:512], xn[:512], xn[:512], 0.7)
        assert float(diag.max()) <= 1.0 and float(diag.diagonal().min()) >= 1.0 - 1e-5

    @pytest.mark.parametrize("m,n,d,k", RESID_SHAPES)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_gaussian_resid_block(self, cuda_device, m, n, d, k, dtype):
        X, Y, xn, yn, W = _gauss(m, n, d, k=k, device=cuda_device)
        before = cuda_ops.launches["gaussian_resid_block"]
        got = cuda_ops.gaussian_resid_block(X, Y, xn, yn, W, 0.7, compute_dtype=dtype)
        again = cuda_ops.gaussian_resid_block(X, Y, xn, yn, W, 0.7, compute_dtype=dtype)
        torch.cuda.synchronize()
        assert cuda_ops.launches["gaussian_resid_block"] == before + 2
        assert torch.equal(got, again)  # split rows summed in a fixed order
        K = cuda_ops.gaussian_kernel_block_ref(X, Y, xn, yn, 0.7, compute_dtype=dtype)
        scale = (K.T @ W.abs()).max().item()
        want = cuda_ops.gaussian_resid_block_ref(X, Y, xn, yn, W, 0.7, compute_dtype=dtype)
        assert got.shape == (n, k)
        assert (got - want).abs().max().item() <= 1e-5 * scale

    @pytest.mark.parametrize("n,X,Y,C,p,k", CONV_SHAPES)
    @pytest.mark.parametrize("normalize,use_means", [(True, True), (True, False), (False, True)])
    def test_conv_featurize(self, cuda_device, n, X, Y, C, p, k, normalize, use_means):
        images, filters, means = _conv_inputs(n, X, Y, C, p, k, device=cuda_device)
        means = means if use_means else None
        before = cuda_ops.launches["conv_featurize"]
        got = cuda_images.conv_featurize(images, filters, means, patch_size=p,
                                         normalize_patches=normalize)
        torch.cuda.synchronize()
        assert cuda_ops.launches["conv_featurize"] == before + 1
        want = cuda_images.conv_featurize_ref(images, filters, means, patch_size=p,
                                              normalize_patches=normalize)
        assert got.shape == (n, X - p + 1, Y - p + 1, k)
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()

    def test_conv_narrows_float64_and_refuses_what_the_guard_refuses(self, cuda_device):
        images, filters, means = _conv_inputs(3, 12, 10, 3, 5, 5, device=cuda_device)
        got = cuda_images.conv_featurize(images.double(), filters, means, patch_size=5)
        want = cuda_images.conv_featurize_ref(images, filters, means, patch_size=5)
        assert got.dtype == torch.float32
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
        wide = torch.zeros((512, 108), device=cuda_device)
        with pytest.raises(ValueError, match="shared memory"):
            cuda_images.conv_featurize(torch.zeros((2, 32, 32, 3), device=cuda_device), wide,
                                       patch_size=6)

    def test_wrong_dtype_raises_instead_of_falling_back(self, cuda_device):
        X = torch.zeros((8, 4), dtype=torch.float16, device=cuda_device)
        n = torch.zeros((8,), device=cuda_device)
        with pytest.raises(TypeError):
            cuda_ops.gaussian_kernel_block(X, X, n, n, 0.1, compute_dtype=torch.float16)
