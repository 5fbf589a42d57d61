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

import ctypes

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
        # conv_featurize, which Convolver's device_fn reaches, answers a meta
        # call (the plan verifier's shape inference) with an empty meta
        # output of the kernel's shape; the Gaussian kernels still raise.
        out = cuda_images.conv_featurize(torch.empty((2, 8, 8, 3), device="meta"),
                                         torch.empty((4, 27), device="meta"), patch_size=3)
        assert out.device.type == "meta" and tuple(out.shape) == (2, 6, 6, 4)

    def test_guard_is_sized_for_shared_memory(self):
        # The block holds a 128-pixel patch tile and the filters in whole
        # filter tiles; the images stay in device memory.
        images = torch.empty((2, 32, 32, 3))
        cifar = cuda_images._smem_bytes(108, 100)
        assert cifar == 4 * (108 * 128 + 112 * 108 + 2 * 108 + 2 * 128) == 105568
        assert 2 * (cifar + 1024) <= 228 * 1024  # two blocks an SM (1 KB reserved each)
        assert cuda_images.conv_featurize_ok(images, torch.empty((100, 108)))
        assert cuda_images.conv_featurize_ok(images, torch.empty((256, 108)))
        assert not cuda_images.conv_featurize_ok(images, torch.empty((512, 108)))  # 272 KB
        # Large images no longer count; large patches with a wide filter
        # tile do (d = 243, 112-wide tile: 231 KB).
        assert cuda_images.conv_featurize_ok(torch.empty((1, 256, 256, 3)),
                                             torch.empty((100, 108)))
        assert not cuda_images.conv_featurize_ok(torch.empty((1, 32, 32, 3)),
                                                 torch.empty((100, 243)))
        assert cuda_images.conv_featurize_ok(torch.empty((1, 32, 32, 3)),
                                             torch.empty((32, 243)))
        assert not cuda_images.conv_featurize_ok(images, torch.empty((8, 100)))  # not p*p*C
        assert not cuda_images.conv_featurize_ok(torch.empty((2, 4, 4, 3)),
                                                 torch.empty((8, 108)))  # image < patch
        assert not cuda_images.conv_featurize_ok(torch.empty((32, 32, 3)),
                                                 torch.empty((8, 108)))  # not a batch

    @pytest.mark.parametrize("k,width", [(1, 32), (32, 32), (33, 112), (100, 112), (112, 112),
                                         (113, 128), (128, 128), (256, 128)])
    def test_filter_tile_is_sized_from_k(self, k, width):
        assert cuda_images._filter_tile(k) == width

    def test_tile_constants_match_the_kernel_source(self):
        # _smem_bytes and _filter_tile model csrc/conv_featurize.cu: its
        # constants must be the ones the Python side assumes.
        text = (cuda_ops._CSRC / "conv_featurize.cu").read_text()
        for line in ("constexpr int FT_NARROW = 32;", "constexpr int FT_MID = 112;",
                     "constexpr int FT_WIDE = 128;", "constexpr int BUFS = 1;",
                     '#include "fma_pipe.cuh"'):
            assert line in text
        assert "constexpr int TM = 128;" in (cuda_ops._CSRC / "fma_pipe.cuh").read_text()
        assert cuda_images._PIXEL_TILE == 128
        assert cuda_images._FILTER_TILES == (32, 112, 128)

    def test_conv_config_entry_point_is_bound(self):
        assert cuda_ops._symbols("conv_featurize") == {
            "kt_conv_featurize": cuda_ops._ENTRY_POINTS["conv_featurize"][1],
            "kt_conv_featurize_config": [ctypes.c_int] * 6 + [ctypes.c_void_p]}

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


def _fill(blocks, resident):
    """The share of its waves' slots a grid of ``blocks`` fills: blocks over
    whole waves x resident blocks."""
    return blocks / (-(-blocks // resident) * resident)


class TestGaussianSplits:
    """The feature-chunk arithmetic of gaussian_kernel_block
    (``cuda_ops.gaussian_splits``), a pure function of the shapes and the
    card."""

    # (train apply, test apply, diagonal, ragged diagonal) at d = 1,800.
    CIFAR = [(50000, 512), (12500, 512), (512, 512), (336, 336)]

    @pytest.mark.parametrize("blocks_per_sm,want", [(1, (1, 1, 8, 14)), (2, (1, 1, 16, 28))])
    def test_cifar_shapes_fill_whole_waves_of_132_sms(self, blocks_per_sm, want):
        got = tuple(cuda_ops.gaussian_splits(m, n, 1800, 132, blocks_per_sm)
                    for m, n in self.CIFAR)
        assert got == want
        for (m, n), s in zip(self.CIFAR, got, strict=True):
            tiles = -(-m // 128) * -(-n // 128)
            # The applies fill a wave with their tiles alone; the diagonal
            # blocks fill one with their chunks.
            assert tiles >= 132 * blocks_per_sm or _fill(tiles * s, 132 * blocks_per_sm) >= 0.95
            assert s == 1 or 1800 // s >= 64

    @pytest.mark.parametrize("blocks_per_sm", [1, 2])
    def test_a_wave_of_tiles_takes_one_chunk(self, blocks_per_sm):
        # 264 tiles at 2 blocks an SM, 132 at 1, fill a wave alone; half as
        # many take two chunks.
        assert cuda_ops.gaussian_splits(128 * 132 * blocks_per_sm, 128, 1800, 132,
                                        blocks_per_sm) == 1
        assert cuda_ops.gaussian_splits(128 * 66 * blocks_per_sm, 128, 1800, 132,
                                        blocks_per_sm) == 2

    @pytest.mark.parametrize("blocks_per_sm", [1, 2])
    @pytest.mark.parametrize("m,n", [(1, 1), (200, 130), (512, 512), (12500, 512),
                                     (50000, 512), (5000, 5000)])
    @pytest.mark.parametrize("d", [1, 63, 64, 300, 1800, 1801])
    def test_whole_waves_or_the_most_fill_with_64_features_a_chunk(self, m, n, d,
                                                                     blocks_per_sm):
        resident = 132 * blocks_per_sm
        tiles = -(-m // 128) * -(-n // 128)
        splits = cuda_ops.gaussian_splits(m, n, d, 132, blocks_per_sm)
        most = max(d // 64, 1)
        assert 1 <= splits <= most
        assert splits == 1 or d // splits >= 64
        fills = [_fill(tiles * s, resident) for s in range(1, most + 1)]
        if tiles >= resident:  # a wave of tiles alone: no chunks
            assert splits == 1
        elif max(fills) >= 0.95:  # the fewest chunks that come within 5% of whole waves
            assert _fill(tiles * splits, resident) >= 0.95
            assert all(f < 0.95 for f in fills[:splits - 1])
        else:  # else the count that fills most
            assert _fill(tiles * splits, resident) == max(fills)

    def test_same_answer_on_every_call(self):
        shapes = [(512, 512, 1800), (336, 336, 1800), (12500, 512, 1800), (300, 200, 9)]
        first = [cuda_ops.gaussian_splits(m, n, d, 132, 2) for m, n, d in shapes]
        assert all([cuda_ops.gaussian_splits(m, n, d, 132, 2) for m, n, d in shapes] == first
                   for _ in range(3))

    def test_few_features_take_one_chunk(self):
        assert cuda_ops.gaussian_splits(512, 512, 127, 132, 2) == 1
        assert cuda_ops.gaussian_splits(512, 512, 0, 132, 2) == 1
        assert cuda_ops.gaussian_splits(0, 512, 1800, 132, 2) == 1


def _tile_fill(row_tiles, col_tiles, splits, resident):
    """The share of the tile slots of its waves that a gaussian_resid_block
    grid fills: each wave lasts as long as the longest row chunk,
    ceil(row_tiles / splits) row tiles."""
    blocks = col_tiles * splits
    waves = -(-blocks // resident)
    return col_tiles * row_tiles / (waves * resident * -(-row_tiles // splits))


class TestResidSplits:
    """The row-chunk arithmetic of gaussian_resid_block
    (``cuda_ops.gaussian_resid_splits``), a pure function of the shapes and
    the card: chunk z of s takes X's row tiles [z T / s, (z + 1) T / s)."""

    @pytest.mark.parametrize("blocks_per_sm,want", [(1, 33), (2, 66)])
    def test_cifar_sweep_fills_one_wave_of_132_sms(self, blocks_per_sm, want):
        # 391 row tiles x 4 column tiles (a 512-row block): 66 chunks of
        # 5-6 tiles at 2 blocks an SM, 264 blocks; blocks alone would take
        # 63 chunks of 6-7 tiles.
        splits = cuda_ops.gaussian_resid_splits(50000, 512, 132, blocks_per_sm)
        assert splits == want
        assert 4 * splits == 132 * blocks_per_sm
        assert _tile_fill(391, 4, splits, 132 * blocks_per_sm) >= 0.95

    @pytest.mark.parametrize("blocks_per_sm", [1, 2])
    @pytest.mark.parametrize("n", [512, 336, 128, 1])
    @pytest.mark.parametrize("m", [50000, 49999, 12500, 1000, 129, 128, 100, 1])
    def test_whole_row_tiles_no_empty_chunk_and_the_best_fill(self, m, n, blocks_per_sm):
        resident = 132 * blocks_per_sm
        T, tiles = -(-m // 128), -(-n // 128)
        splits = cuda_ops.gaussian_resid_splits(m, n, 132, blocks_per_sm)
        # Whole row tiles a chunk, none empty: s <= T gives every chunk
        # [z T / s, (z + 1) T / s) at least one tile, and the chunks cover
        # the tiles once.
        assert 1 <= splits <= T
        bounds = [z * T // splits for z in range(splits + 1)]
        assert bounds[0] == 0 and bounds[-1] == T
        assert all(b1 - b0 >= 1 for b0, b1 in zip(bounds, bounds[1:]))
        fills = [_tile_fill(T, tiles, s, resident) for s in range(1, T + 1)]
        if max(fills) >= 0.95:  # the fewest chunks that come within 5% of whole waves
            assert _tile_fill(T, tiles, splits, resident) >= 0.95
            assert all(f < 0.95 for f in fills[:splits - 1])
        else:  # else the count that fills most
            assert _tile_fill(T, tiles, splits, resident) == pytest.approx(max(fills))

    def test_same_answer_on_every_call(self):
        shapes = [(50000, 512), (50000, 336), (12500, 512), (300, 40)]
        first = [cuda_ops.gaussian_resid_splits(m, n, 132, 2) for m, n in shapes]
        assert all([cuda_ops.gaussian_resid_splits(m, n, 132, 2) for m, n in shapes] == first
                   for _ in range(3))

    def test_config_entry_point_is_bound(self):
        assert "kt_gaussian_resid_block_config" in [
            symbol for symbol, _ in cuda_ops._EXTRA_SYMBOLS["gaussian_resid_block"]]


# ---------------------------------------------------------------------------
# Kernel against plain version: needs the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


GAUSS_SHAPES = [(37, 45, 23), (200, 130, 70), (129, 257, 9), (1, 1, 1), (1030, 513, 1800)]
# k = 1, 10 and 16 take one 16-wide label pass and hold the partial in
# registers; 17, 33, 35, 147 and 170 take 2 to 11 passes through device
# memory; d % 4 != 0 (30, 17, 1801) loads element by element; m = 100 is
# below one row tile.
RESID_SHAPES = [(300, 40, 30, 5), (130, 129, 17, 1), (517, 200, 12, 35), (5000, 512, 300, 10),
                (100, 60, 1801, 33), (1000, 130, 64, 147), (700, 336, 1800, 10),
                (260, 33, 8, 170), (3000, 512, 1801, 1), (390, 70, 20, 16), (390, 70, 20, 17)]
# (n, X, Y, C, p, k). Pixel tiles of 128 rows run across image
# boundaries wherever x'y' is not a multiple of 128 (all of these), and the
# last tile is ragged; k = 1, 100, 112, 113 and 256 sit at the filter
# tiles' edges (32, 112, 2 x 128); X != Y, C = 1 and p = 1 move the
# offset table.
CONV_SHAPES = [(3, 12, 10, 3, 5, 5), (2, 9, 9, 2, 3, 4), (2, 12, 11, 3, 6, 130),
               (37, 32, 32, 3, 6, 100), (5, 32, 32, 3, 6, 1), (5, 32, 32, 3, 6, 112),
               (5, 32, 32, 3, 6, 113), (5, 32, 32, 3, 6, 256), (3, 14, 9, 3, 4, 20),
               (4, 12, 12, 1, 5, 40), (3, 10, 7, 3, 1, 64)]


def _gauss_check(X, Y, xn, yn, dtype, runs=3):
    """gaussian_kernel_block against its plain version within 1e-5
    absolute, one launch a call, and the same bits on every run; returns
    the kernel's block."""
    before = cuda_ops.launches["gaussian_kernel_block"]
    got = [cuda_ops.gaussian_kernel_block(X, Y, xn, yn, 0.7, compute_dtype=dtype)
           for _ in range(runs)]
    torch.cuda.synchronize()
    assert cuda_ops.launches["gaussian_kernel_block"] == before + runs
    assert all(torch.equal(got[0], g) for g in got[1:])
    want = cuda_ops.gaussian_kernel_block_ref(X, Y, xn, yn, 0.7, compute_dtype=dtype)
    assert got[0].shape == (X.shape[0], Y.shape[0]) and got[0].dtype == torch.float32
    assert (got[0] - want).abs().max().item() <= 1e-5
    return got[0]


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

    @pytest.mark.parametrize("d", [1, 3, 9, 1800, 1801])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_gaussian_feature_widths(self, cuda_device, d, dtype):
        # d = 1800 takes 16-byte chunks; 1801 (and 1, 3, 9) element by element.
        X, Y, xn, yn, _ = _gauss(300, 200, d, seed=d, device=cuda_device)
        _gauss_check(X, Y, xn, yn, dtype)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_odd_row_slice_with_odd_d(self, cuda_device, dtype):
        X, _, xn, _, _ = _gauss(700, 1, 301, seed=3, device=cuda_device)
        _gauss_check(X, X[129:460], xn, xn[129:460], dtype)

    @pytest.mark.parametrize("size", [512, 336])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_diagonal_block_split_into_feature_chunks(self, cuda_device, size, dtype):
        # A KRR pre-pass block: too few tiles for the card, so the features
        # are split (CIFAR's d = 1,800); the clamp keeps the diagonal at 1.
        X, _, xn, _, _ = _gauss(1000, 1, 1800, seed=size, device=cuda_device)
        Xb, xb = X[100:100 + size], xn[100:100 + size]
        got = _gauss_check(Xb, Xb, xb, xb, dtype)
        assert float(got.max()) <= 1.0
        if dtype == torch.float32:  # bf16 operands against f32 norms leave it below 1
            assert float(got.diagonal().min()) >= 1.0 - 1e-5
        grid = cuda_ops.gaussian_kernel_block_grid(size, size, 1800, dtype == torch.bfloat16,
                                                   cuda_device)
        assert grid["splits"] > 1 and grid["waves"] >= 0.95

    @pytest.mark.parametrize("bf16", [False, True])
    def test_cifar_grids(self, cuda_device, bf16):
        # The route's shapes at d = 1,800: 128 x 128 tiles, feature chunks
        # only where the tiles alone fill too little of the card.
        train = cuda_ops.gaussian_kernel_block_grid(50000, 512, 1800, bf16, cuda_device)
        assert train["tiles"] == 1564 and train["splits"] == 1
        bps, sms = train["blocks_per_sm"], train["sms"]
        for m, n in ((50000, 512), (12500, 512), (512, 512), (336, 336)):
            grid = cuda_ops.gaussian_kernel_block_grid(m, n, 1800, bf16, cuda_device)
            assert grid["splits"] == cuda_ops.gaussian_splits(m, n, 1800, sms, bps)
            assert grid["blocks"] == grid["tiles"] * grid["splits"]
        assert train["local_bytes"] == 0  # no spills
        if bps >= 2:
            assert train["registers"] <= 128

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

    @pytest.mark.parametrize("k", [1, 10, 33, 147])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_gaussian_resid_block_odd_row_slice(self, cuda_device, k, dtype):
        # Y a row slice of X at an odd row with odd d: not 16-byte aligned,
        # so X and Y load element by element; W a column slice (ldw > k).
        X, _, xn, _, W = _gauss(700, 1, 301, k=k + 3, seed=k, device=cuda_device)
        Y, yn, W = X[129:460], xn[129:460], W[:, 1:k + 1]
        got = cuda_ops.gaussian_resid_block(X, Y, xn, yn, W, 0.7, compute_dtype=dtype)
        again = cuda_ops.gaussian_resid_block(X, Y, xn, yn, W, 0.7, compute_dtype=dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        K = cuda_ops.gaussian_kernel_block_ref(X, Y, xn, yn, 0.7, compute_dtype=dtype)
        scale = (K.T @ W.abs()).max().item()
        want = cuda_ops.gaussian_resid_block_ref(X, Y, xn, yn, W, 0.7, compute_dtype=dtype)
        assert (got - want).abs().max().item() <= 1e-5 * scale

    @pytest.mark.parametrize("bf16", [False, True])
    def test_resid_grids(self, cuda_device, bf16):
        # The sweep's shapes at d = 1,800 and k = 10: one 16-wide label pass,
        # row chunks from gaussian_resid_splits, no spills, at most 128
        # registers at 2 blocks an SM, and under 110 KB of shared memory.
        for n in (512, 336):
            grid = cuda_ops.gaussian_resid_block_grid(50000, n, 1800, 10, bf16, cuda_device)
            bps, sms = grid["blocks_per_sm"], grid["sms"]
            assert grid["splits"] == cuda_ops.gaussian_resid_splits(50000, n, sms, bps)
            assert grid["blocks"] == grid["tiles"] * grid["splits"]
            assert grid["ktile"] == 16 and grid["label_tiles"] == 1 and grid["row_tiles"] == 391
            assert grid["local_bytes"] == 0
            assert bps >= 2 and grid["registers"] <= 128
            assert grid["smem_bytes"] <= 110 * 1024
        wide = cuda_ops.gaussian_resid_block_grid(50000, 512, 1800, 147, bf16, cuda_device)
        assert wide["label_tiles"] == 10 and wide["smem_bytes"] <= 110 * 1024

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

    def test_conv_tiles_across_images_give_each_image_its_bits(self, cuda_device):
        # Every output is one fmaf chain over its own patch, wherever its
        # row falls in a tile: a batch whose tiles straddle image boundaries
        # (729 rows an image) gives each image's bits from a call of its
        # own, and the same bits on a second call.
        images, filters, means = _conv_inputs(7, 32, 32, 3, 6, 100, seed=5, device=cuda_device)
        batch = cuda_images.conv_featurize(images, filters, means, patch_size=6)
        again = cuda_images.conv_featurize(images, filters, means, patch_size=6)
        alone = torch.cat([cuda_images.conv_featurize(images[i:i + 1], filters, means,
                                                      patch_size=6) for i in range(7)])
        assert torch.equal(batch, again) and torch.equal(batch, alone)

    @pytest.mark.parametrize("n,size,use_means", [(2382, 32, False), (4809, 24, True),
                                                  (7, 24, True), (7, 24, False)])
    def test_conv_featurize_at_the_runners_forms(self, cuda_device, n, size, use_means):
        # The forms the CIFAR runners add: RandomCifar's filters without a
        # whitener on a 32 x 32 row chunk (2,382 images), and the augmented
        # runner's 24 x 24 crops (19 x 19 = 361 outputs an image, so pixel
        # tiles cross image boundaries at other places than at 729) on its
        # row chunk of 4,809 crops: within 1e-5 of the plain version's
        # scale, and each image's bits whatever tile it falls in.
        images, filters, means = _conv_inputs(n, size, size, 3, 6, 100, seed=n,
                                              device=cuda_device)
        means = means if use_means else None
        assert cuda_images.conv_featurize_ok(images, filters)
        got = cuda_images.conv_featurize(images, filters, means, patch_size=6)
        want = cuda_images.conv_featurize_ref(images, filters, means, patch_size=6)
        torch.cuda.synchronize()
        assert got.shape == (n, size - 5, size - 5, 100)
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
        some = [0, n // 2, n - 1]
        alone = torch.cat([cuda_images.conv_featurize(images[i:i + 1], filters, means,
                                                      patch_size=6) for i in some])
        assert torch.equal(got[some], alone)
        grid = cuda_images.conv_featurize_grid(n, size, size, 3, 6, 100, cuda_device)
        assert grid["tiles"] == -(-n * (size - 5) ** 2 // 128) and grid["local_bytes"] == 0

    @pytest.mark.parametrize("n,k", [(2382, 100), (1, 100), (50, 32), (50, 256)])
    def test_conv_grid(self, cuda_device, n, k):
        # A persistent grid of the resident blocks (fewer where there are
        # fewer tiles), no spills, at most 128 registers; two blocks an SM
        # at CIFAR's k = 100 (105.6 KB of shared memory), and the row
        # chunk's 13,567 tiles fill at least 0.95 of the blocks' rounds.
        grid = cuda_images.conv_featurize_grid(n, 32, 32, 3, 6, k, cuda_device)
        resident = grid["sms"] * grid["blocks_per_sm"]
        assert grid["tiles"] == -(-n * 729 // 128)
        assert grid["blocks"] == min(grid["tiles"], resident)
        assert grid["local_bytes"] == 0 and grid["registers"] <= 128
        assert grid["smem_bytes"] == cuda_images._smem_bytes(108, k)
        assert grid["ktile"] == cuda_images._filter_tile(k)
        assert grid["vec_stores"] == (k % 4 == 0)
        if k <= 112:
            assert grid["blocks_per_sm"] >= 2
        if n == 2382:
            assert grid["tiles"] == 13567 and grid["fill"] >= 0.95 and grid["waves"] == 1.0

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
