"""The port's column-window kernels (block_gram_sym, block_corr,
block_residual_update in keystone_tpu_torch/ops/cuda_ops.py) against the
JAX package's Pallas kernels of the same names.

On the CPU the wrappers compute their plain PyTorch versions; those are held
here against the Pallas kernels run in interpret mode on the same inputs
(made with a seeded numpy generator, float32 on both sides; bf16 F is the
same round-to-nearest-even of those values on both sides). The shapes are
the reference's aligned ones: n = 1024 rows (a multiple of its 512-row
tile), d = 768, a 256-wide window at column 0, 256 or 512. The kernels
themselves run only on a CUDA card: the ``cuda`` tests compare each kernel
with its plain version there and skip elsewhere.

Tolerance: 1e-5 of the sums' scale (max over entries of sum |f||r|, or of
|r| + sum |f||dw| for the residual). Both sides sum float32 products in
float32 — bf16 operands are exact in float32 and their products too — in
different orders; over at most 1024 terms that differs by ~1e-7 of the
scale.
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.ops import cuda_ops

N, D, BLOCK = 1024, 768, 256
COL_STARTS = [0, 256, 512]
KS = [10, 147]
DTYPES = ["f32", "bf16"]


@pytest.fixture
def jax_ref():
    """(pallas_ops, jax.numpy) of the JAX package, the reference."""
    jnp = pytest.importorskip("jax.numpy")
    from keystone_tpu.ops import pallas_ops

    return pallas_ops, jnp


def _inputs(k, seed=0):
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(N, D)).astype(np.float32)
    R = rng.normal(size=(N, k)).astype(np.float32)
    dW = (0.1 * rng.normal(size=(BLOCK, k))).astype(np.float32)
    return F, R, dW


def _operands(jnp, F, dtype):
    """F for the port (torch) and the reference (jax), in ``dtype``."""
    Ft = torch.from_numpy(F)
    if dtype == "bf16":
        return Ft.to(torch.bfloat16), jnp.asarray(F, dtype=jnp.bfloat16)
    return Ft, jnp.asarray(F)


def _window(F, s, dtype):
    Fw = torch.from_numpy(F[:, s:s + BLOCK])
    return Fw.to(torch.bfloat16).double() if dtype == "bf16" else Fw.double()


def _round(x, dtype):
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16).double() if dtype == "bf16" else t.double()


def _rel(got, want, scale):
    return float(np.max(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)))) / scale


class TestAgainstPallas:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("s", COL_STARTS)
    def test_block_gram_sym(self, jax_ref, s, dtype):
        pallas_ops, jnp = jax_ref
        F, _, _ = _inputs(10)
        Ft, Fj = _operands(jnp, F, dtype)
        want = np.asarray(pallas_ops.block_gram_sym(Fj, s, BLOCK, interpret=True))
        got = cuda_ops.block_gram_sym_ref(Ft, s, BLOCK)
        assert got.shape == (BLOCK, BLOCK) and got.dtype == torch.float32
        assert torch.equal(got, got.T)
        Fw = _window(F, s, dtype)
        scale = float((Fw * Fw).sum(dim=0).max())
        assert _rel(got.numpy(), want, scale) <= 1e-5

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("k", KS)
    @pytest.mark.parametrize("s", COL_STARTS)
    def test_block_corr(self, jax_ref, s, k, dtype):
        pallas_ops, jnp = jax_ref
        F, R, _ = _inputs(k, seed=1)
        Ft, Fj = _operands(jnp, F, dtype)
        want = np.asarray(pallas_ops.block_corr(Fj, s, BLOCK, R, interpret=True))
        got = cuda_ops.block_corr_ref(Ft, s, BLOCK, torch.from_numpy(R))
        assert got.shape == (BLOCK, k) and got.dtype == torch.float32
        scale = float((_window(F, s, dtype).abs().T @ _round(R, dtype).abs()).max())
        assert _rel(got.numpy(), want, scale) <= 1e-5

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("k", KS)
    @pytest.mark.parametrize("s", COL_STARTS)
    def test_block_residual_update(self, jax_ref, s, k, dtype):
        pallas_ops, jnp = jax_ref
        F, R, dW = _inputs(k, seed=2)
        Ft, Fj = _operands(jnp, F, dtype)
        want = np.asarray(
            pallas_ops.block_residual_update(Fj, s, BLOCK, dW, R, interpret=True)
        )
        got = cuda_ops.block_residual_update_ref(
            Ft, s, BLOCK, torch.from_numpy(dW), torch.from_numpy(R)
        )
        assert got.shape == (N, k) and got.dtype == torch.float32
        prod = _window(F, s, dtype).abs() @ _round(dW, dtype).abs()
        scale = float((torch.from_numpy(R).double().abs() + prod).max())
        assert _rel(got.numpy(), want, scale) <= 1e-5


class TestWrappersOnTheCpu:
    def test_wrappers_take_the_plain_versions_on_cpu(self):
        F, R, dW = (torch.from_numpy(a) for a in _inputs(147, seed=3))
        before = dict(cuda_ops.launches)
        assert torch.equal(cuda_ops.block_gram_sym(F, 256, BLOCK),
                           cuda_ops.block_gram_sym_ref(F, 256, BLOCK))
        assert torch.equal(cuda_ops.block_corr(F, 256, BLOCK, R),
                           cuda_ops.block_corr_ref(F, 256, BLOCK, R))
        assert torch.equal(cuda_ops.block_residual_update(F, 256, BLOCK, dW, R),
                           cuda_ops.block_residual_update_ref(F, 256, BLOCK, dW, R))
        assert cuda_ops.launches == before  # no kernel was launched

    def test_windows_equal_the_sliced_products(self):
        # The window functions are the plain products of the sliced block.
        F, R, dW = (torch.from_numpy(a) for a in _inputs(10, seed=4))
        Fw = F[:, 512:768]
        torch.testing.assert_close(cuda_ops.block_gram_sym_ref(F, 512, BLOCK), Fw.T @ Fw)
        torch.testing.assert_close(cuda_ops.block_corr_ref(F, 512, BLOCK, R), Fw.T @ R)
        torch.testing.assert_close(
            cuda_ops.block_residual_update_ref(F, 512, BLOCK, dW, R), R - Fw @ dW
        )

    def test_strided_gram_ok(self):
        F = torch.zeros((100, 768))
        assert cuda_ops.strided_gram_ok(F, 256)
        assert cuda_ops.strided_gram_ok(F.to(torch.bfloat16), 256)
        # Ragged rows are masked in the kernels: any row count will do.
        assert cuda_ops.strided_gram_ok(torch.zeros((37, 768)), 256)
        assert not cuda_ops.strided_gram_ok(F, 300)  # d % block != 0
        assert not cuda_ops.strided_gram_ok(F.double(), 256)  # f64 accumulates in f64
        assert not cuda_ops.strided_gram_ok(F.T.contiguous().T, 256)  # column-major
        assert not cuda_ops.strided_gram_ok(torch.zeros(768), 256)

    def test_non_cpu_non_cuda_tensors_raise(self):
        F = torch.empty((8, 16), device="meta")
        R = torch.empty((8, 3), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            cuda_ops.block_gram_sym(F, 0, 8)
        with pytest.raises(ValueError, match="CUDA"):
            cuda_ops.block_corr(F, 0, 8, R)
        with pytest.raises(ValueError, match="CUDA"):
            cuda_ops.block_residual_update(F, 0, 8, torch.empty((8, 3), device="meta"), R)

    def test_cosine_features_writes_into_a_column_window(self):
        rng = np.random.default_rng(5)
        X = torch.from_numpy(rng.normal(size=(30, 20)).astype(np.float32))
        W = torch.from_numpy(rng.normal(size=(12, 20)).astype(np.float32))
        b = torch.from_numpy(rng.uniform(0, 6, size=12).astype(np.float32))
        out = torch.full((30, 40), 7.0)
        got = cuda_ops.cosine_features(X, W, b, out=out[:, 16:28])
        assert got.data_ptr() == out[:, 16:28].data_ptr()
        assert torch.equal(out[:, 16:28], cuda_ops.cosine_features_ref(X, W, b))
        assert torch.equal(out[:, :16], torch.full((30, 16), 7.0))
        assert torch.equal(out[:, 28:], torch.full((30, 12), 7.0))

    def test_library_name_hashes_the_shared_header(self, tmp_path, monkeypatch):
        # A header edit must give every kernel that includes it a new library.
        for src in (cuda_ops._CSRC).iterdir():
            (tmp_path / src.name).write_bytes(src.read_bytes())
        monkeypatch.setattr(cuda_ops, "_CSRC", tmp_path)
        before = {name: cuda_ops._library_path(name) for name in cuda_ops._ENTRY_POINTS}
        header = tmp_path / "fma_tile.cuh"
        header.write_text(header.read_text() + "\n// edited\n")
        after = {name: cuda_ops._library_path(name) for name in cuda_ops._ENTRY_POINTS}
        assert all(before[name] != after[name] for name in before)


# ---------------------------------------------------------------------------
# Kernel against plain version: needs the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _card_inputs(n, d, k, device, seed=0):
    rng = np.random.default_rng(seed)
    F = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(device)
    R = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32)).to(device)
    dW = torch.from_numpy((0.1 * rng.normal(size=(d, k))).astype(np.float32)).to(device)
    return F, R, dW


# (n, d, col_start, block, k): aligned, ragged rows/window/labels, one row.
CARD_SHAPES = [(1024, 768, 256, 256, 147), (1000, 600, 200, 200, 10),
               (70000, 384, 128, 256, 147), (1, 260, 3, 130, 1)]


@pytest.mark.cuda
class TestKernelsOnCard:
    @pytest.mark.parametrize("n,d,s,b,k", CARD_SHAPES)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_block_kernels(self, cuda_device, n, d, s, b, k, dtype):
        F, R, dW = _card_inputs(n, d, k, cuda_device)
        F = F.to(dtype)
        dW = dW[:b]
        Fw = F[:, s:s + b].float()
        before = dict(cuda_ops.launches)
        gram = cuda_ops.block_gram_sym(F, s, b)
        corr = cuda_ops.block_corr(F, s, b, R)
        resid = cuda_ops.block_residual_update(F, s, b, dW, R)
        torch.cuda.synchronize()
        for name in ("block_gram_sym", "block_corr", "block_residual_update"):
            assert cuda_ops.launches[name] == before[name] + 1
        assert torch.equal(gram, gram.T)
        g_scale = float((Fw * Fw).sum(dim=0).max())
        c_scale = float((Fw.abs().T @ R.abs()).max())
        r_scale = float((R.abs() + Fw.abs() @ dW.to(dtype).float().abs()).max())
        assert float((gram - cuda_ops.block_gram_sym_ref(F, s, b)).abs().max()) <= 1e-4 * g_scale
        assert float((corr - cuda_ops.block_corr_ref(F, s, b, R)).abs().max()) <= 1e-4 * c_scale
        want = cuda_ops.block_residual_update_ref(F, s, b, dW, R)
        assert float((resid - want).abs().max()) <= 1e-4 * r_scale

    def test_block_corr_gives_the_same_bits_every_run(self, cuda_device):
        F, R, _ = _card_inputs(70000, 512, 147, cuda_device)
        first = cuda_ops.block_corr(F, 256, 256, R)
        assert all(torch.equal(first, cuda_ops.block_corr(F, 256, 256, R)) for _ in range(3))

    def test_window_outside_f_raises(self, cuda_device):
        F, R, _ = _card_inputs(64, 256, 4, cuda_device)
        with pytest.raises(ValueError):
            cuda_ops.block_gram_sym(F, 200, 128)
        with pytest.raises(TypeError):
            cuda_ops.block_corr(F.double(), 0, 128, R)
