"""The port's CUDA-kernel module (keystone_tpu_torch/ops/cuda_ops.py)
against the JAX package's Pallas kernels.

On the CPU the port's wrappers compute their plain PyTorch versions; those
are held here against the Pallas kernels run in interpret mode on the same
inputs (made with a seeded numpy generator, cast to float32 on both sides
because tests/conftest.py turns on x64). The kernels themselves run only
on a CUDA card: the ``cuda`` tests compare each kernel with its plain
version there and skip elsewhere. The JAX package is imported inside a
fixture, so that on a machine with the card and without JAX the ``cuda``
tests still run (``python -m pytest tests/test_torch_cuda_ops.py -m cuda
--noconftest``) while the parity tests skip.

Tolerances:
  - cosine features, f32 or bf16 operands with f32 output: 1e-5 absolute.
    Both sides evaluate the reference's polynomial cosine with the same
    float32 arithmetic (``cuda_ops.fast_cos`` has ``pallas_ops._fast_cos``'s
    bits); the two float32 GEMMs sum d products in different orders. The
    wide-|x| cases (pre-activations up to about 100, where the polynomial's
    one-constant reduction is 10x less accurate than near 0) use inputs whose
    products and sums are exact in float32, so the GEMMs agree exactly and
    the cosines' arithmetic is what is compared.
  - cosine features with bf16 output: 2**-7 absolute, one bf16 step for
    values near 1 plus the f32 differences above.
  - Gramian + correlation: 1e-4 relative to the largest entry (the sums
    run over n rows in different orders).
"""

import ctypes

import numpy as np
import pytest
import torch

from keystone_tpu_torch.ops import cuda_ops


@pytest.fixture
def jax_ref():
    """(pallas_ops, jax.numpy) of the JAX package, the reference."""
    jnp = pytest.importorskip("jax.numpy")
    from keystone_tpu.ops import pallas_ops

    return pallas_ops, jnp


def _rng(seed):
    return np.random.default_rng(seed)


def _cosine_inputs(m, d, n, seed=0):
    rng = _rng(seed)
    X = rng.normal(size=(m, d)).astype(np.float32)
    W = (0.3 * rng.normal(size=(n, d))).astype(np.float32)
    b = rng.uniform(0.0, 2 * np.pi, size=n).astype(np.float32)
    return X, W, b


def _exact_cosine_inputs(m, d, n, seed=0):
    """Inputs whose pre-activations X Wᵀ + b are exact in float32 in any
    summation order (X small integers, W and b multiples of 1/8) and reach
    |x| of about 100: W's spread is set for a standard deviation of 25."""
    rng = _rng(seed)
    X = rng.integers(-4, 5, size=(m, d)).astype(np.float32)
    top = max(1, round(8 * np.sqrt(3) * 25 / (np.sqrt(20 / 3) * np.sqrt(d))))
    W = (rng.integers(-top, top + 1, size=(n, d)) / 8.0).astype(np.float32)
    b = (rng.integers(0, 51, size=n) / 8.0).astype(np.float32)
    return X, W, b


def _gram_inputs(n, d, k, seed=0):
    rng = _rng(seed)
    A = rng.normal(size=(n, d)).astype(np.float32)
    R = rng.normal(size=(n, k)).astype(np.float32)
    return A, R


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel(got, want):
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


COSINE_SHAPES = [(8, 16, 8), (37, 23, 45), (300, 70, 260)]
WIDE_COSINE_SHAPES = [(37, 23, 45), (100, 441, 130), (300, 70, 260)]
GRAM_SHAPES = [(64, 40, 7), (600, 300, 147), (130, 129, 1)]


class TestCosineFeaturesAgainstPallas:
    @pytest.mark.parametrize("m,d,n", COSINE_SHAPES)
    def test_f32(self, jax_ref, m, d, n):
        pallas_ops, _ = jax_ref
        X, W, b = _cosine_inputs(m, d, n)
        want = np.asarray(pallas_ops.cosine_features(X, W, b, interpret=True))
        got = cuda_ops.cosine_features_ref(_t(X), _t(W), _t(b)).numpy()
        assert got.shape == (m, n) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    @pytest.mark.parametrize("m,d,n", COSINE_SHAPES[1:])
    def test_bf16_operands(self, jax_ref, m, d, n):
        pallas_ops, jnp = jax_ref
        X, W, b = _cosine_inputs(m, d, n, seed=1)
        want = np.asarray(pallas_ops.cosine_features(
            X, W, b, compute_dtype=jnp.bfloat16, interpret=True
        ))
        got = cuda_ops.cosine_features_ref(
            _t(X), _t(W), _t(b), compute_dtype=torch.bfloat16
        ).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    def test_bf16_output(self, jax_ref):
        pallas_ops, jnp = jax_ref
        X, W, b = _cosine_inputs(37, 23, 45, seed=2)
        want = np.asarray(pallas_ops.cosine_features(
            X, W, b, out_dtype=jnp.bfloat16, interpret=True
        ).astype(jnp.float32))
        got = cuda_ops.cosine_features_ref(
            _t(X), _t(W), _t(b), out_dtype=torch.bfloat16
        )
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2**-7)

    @pytest.mark.parametrize("bound", [1.0, 10.0, 100.0, 300.0, 3000.0])
    def test_fast_cos_has_the_reference_bits(self, jax_ref, bound):
        pallas_ops, _ = jax_ref
        x = np.linspace(-bound, bound, 20001, dtype=np.float32)
        want = np.asarray(pallas_ops._fast_cos(x))
        got = cuda_ops.fast_cos(_t(x)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("m,d,n", WIDE_COSINE_SHAPES)
    def test_wide_preactivations(self, jax_ref, m, d, n):
        pallas_ops, _ = jax_ref
        X, W, b = _exact_cosine_inputs(m, d, n)
        pre = X.astype(np.float64) @ W.T.astype(np.float64) + b
        assert np.abs(pre).max() > 50
        want = np.asarray(pallas_ops.cosine_features(X, W, b, interpret=True))
        got = cuda_ops.cosine_features_ref(_t(X), _t(W), _t(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    def test_wrapper_takes_plain_version_on_cpu(self):
        X, W, b = _cosine_inputs(37, 23, 45, seed=3)
        before = dict(cuda_ops.launches)
        got = cuda_ops.cosine_features(_t(X), _t(W), _t(b))
        want = cuda_ops.cosine_features_ref(_t(X), _t(W), _t(b))
        assert torch.equal(got, want)
        assert cuda_ops.launches == before  # no kernel was launched


class TestGramCorrSymAgainstPallas:
    @pytest.mark.parametrize("n,d,k", GRAM_SHAPES)
    def test_f32(self, jax_ref, n, d, k):
        pallas_ops, _ = jax_ref
        A, R = _gram_inputs(n, d, k)
        gram_j, corr_j = pallas_ops.gram_corr_sym(A, R, interpret=True)
        gram, corr = cuda_ops.gram_corr_sym_ref(_t(A), _t(R))
        assert gram.shape == (d, d) and corr.shape == (d, k)
        assert _rel(gram.numpy(), np.asarray(gram_j)) < 1e-4
        assert _rel(corr.numpy(), np.asarray(corr_j)) < 1e-4
        assert torch.equal(gram, gram.T)

    def test_bf16_operand(self, jax_ref):
        pallas_ops, jnp = jax_ref
        # The Pallas kernel rounds R to the operand dtype for its bf16
        # matrix unit; the port keeps R in f32. With R already
        # bf16-representable the two compute the same products.
        A, R = _gram_inputs(600, 300, 147, seed=1)
        A16 = torch.from_numpy(A).to(torch.bfloat16)
        R = _t(R).to(torch.bfloat16).float().numpy()
        gram_j, corr_j = pallas_ops.gram_corr_sym(
            jnp.asarray(A16.float().numpy(), dtype=jnp.bfloat16), R, interpret=True
        )
        gram, corr = cuda_ops.gram_corr_sym_ref(A16, _t(R))
        assert _rel(gram.numpy(), np.asarray(gram_j)) < 1e-4
        assert _rel(corr.numpy(), np.asarray(corr_j)) < 1e-4

    def test_wrapper_takes_plain_version_on_cpu(self):
        A, R = _gram_inputs(64, 40, 7, seed=2)
        before = dict(cuda_ops.launches)
        got = cuda_ops.gram_corr_sym(_t(A), _t(R))
        want = cuda_ops.gram_corr_sym_ref(_t(A), _t(R))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert cuda_ops.launches == before


class TestWrapperContract:
    def test_non_cpu_non_cuda_tensors_raise(self):
        X = torch.empty((4, 3), device="meta")
        W = torch.empty((5, 3), device="meta")
        b = torch.empty((5,), device="meta")
        # cosine_features, which a transformer's device_fn reaches, answers a
        # meta call (the plan verifier's shape inference) with an empty meta
        # output and launches nothing; the other wrappers still raise.
        out = cuda_ops.cosine_features(X, W, b)
        assert out.device.type == "meta" and tuple(out.shape) == (4, 5)
        with pytest.raises(ValueError, match="CUDA"):
            cuda_ops.gram_corr_sym(X, torch.empty((4, 2), device="meta"))

    def test_reset_launch_counts(self):
        cuda_ops.launches["gram_corr_sym"] += 3
        cuda_ops.reset_launch_counts()
        assert set(cuda_ops.launches.values()) == {0}

    def test_cosine_config_entry_point_is_bound(self):
        assert ("kt_cosine_features_config", [ctypes.c_int] * 3 + [ctypes.c_void_p]) in \
            cuda_ops._EXTRA_SYMBOLS["cosine_features"]

    def test_library_name_tracks_the_source(self):
        path = cuda_ops._library_path("cosine_features")
        assert path.parent.name == "keystone_tpu_torch"
        assert path.parent.parent.name == "build"
        assert path.name.startswith("libcosine_features-")
        assert path == cuda_ops._library_path("cosine_features")


# ---------------------------------------------------------------------------
# Kernel against plain version: needs the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelsOnCard:
    @pytest.mark.parametrize("m,d,n", COSINE_SHAPES + [(1030, 440, 513), (100, 101, 130)])
    @pytest.mark.parametrize("compute,out,atol", [
        (torch.float32, torch.float32, 1e-5),
        (torch.bfloat16, torch.float32, 1e-5),
        (torch.float32, torch.bfloat16, 2**-7),
    ])
    def test_cosine_features(self, cuda_device, m, d, n, compute, out, atol):
        X, W, b = (_t(a).to(cuda_device) for a in _cosine_inputs(m, d, n))
        before = cuda_ops.launches["cosine_features"]
        got = cuda_ops.cosine_features(X, W, b, compute_dtype=compute, out_dtype=out)
        again = cuda_ops.cosine_features(X, W, b, compute_dtype=compute, out_dtype=out)
        torch.cuda.synchronize()
        assert cuda_ops.launches["cosine_features"] == before + 2
        assert torch.equal(got, again)
        want = cuda_ops.cosine_features_ref(X, W, b, compute, out)
        assert got.dtype == out
        assert (got.float() - want.float()).abs().max().item() <= atol

    @pytest.mark.parametrize("m,d,n", WIDE_COSINE_SHAPES)
    @pytest.mark.parametrize("compute,out,atol", [
        (torch.float32, torch.float32, 1e-5),
        (torch.float32, torch.bfloat16, 2**-7),
    ])
    def test_cosine_features_wide_preactivations(self, cuda_device, m, d, n, compute, out, atol):
        # Pre-activations up to about 100, exact in float32: the kernel's
        # cosine against the reference's arithmetic in the plain version.
        X, W, b = (_t(a).to(cuda_device) for a in _exact_cosine_inputs(m, d, n))
        got = cuda_ops.cosine_features(X, W, b, compute_dtype=compute, out_dtype=out)
        want = cuda_ops.cosine_features_ref(X, W, b, compute, out)
        torch.cuda.synchronize()
        assert (got.float() - want.float()).abs().max().item() <= atol

    @pytest.mark.parametrize("ldo,start", [(600, 0), (600, 4), (600, 64), (600, 1), (600, 6),
                                           (611, 0), (611, 4), (602, 2)])
    @pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
    def test_cosine_features_into_column_windows(self, cuda_device, ldo, start, out_dtype):
        # Windows at any column and row stride leave the rest of the matrix
        # as it was and give the bits of a fresh output. n = 513 leaves a
        # ragged last column tile.
        X, W, b = (_t(a).to(cuda_device) for a in _cosine_inputs(300, 70, 513, seed=4))
        fused = torch.full((300, ldo), 7.0, dtype=out_dtype, device=cuda_device)
        window = fused[:, start:start + 513]
        got = cuda_ops.cosine_features(X, W, b, out=window)
        torch.cuda.synchronize()
        assert got.data_ptr() == window.data_ptr()
        assert torch.equal(window, cuda_ops.cosine_features(X, W, b, out_dtype=out_dtype))
        rest = torch.ones_like(fused, dtype=torch.bool)
        rest[:, start:start + 513] = False
        assert bool((fused[rest] == 7.0).all())
        want = cuda_ops.cosine_features_ref(X, W, b, out_dtype=out_dtype)
        atol = 1e-5 if out_dtype == torch.float32 else 2**-7
        assert (window.float() - want.float()).abs().max().item() <= atol

    @pytest.mark.parametrize("bf16", [False, True])
    @pytest.mark.parametrize("out_bf16", [False, True])
    def test_cosine_grid(self, cuda_device, bf16, out_bf16):
        # A TIMIT branch: 512 x 32 tiles of 128 x 128, one block each; no
        # spills, and at two blocks an SM at most 128 registers.
        grid = cuda_ops.cosine_features_grid(65536, 4096, 440, bf16, out_bf16, cuda_device)
        assert grid["tiles"] == grid["blocks"] == 512 * 32
        assert grid["local_bytes"] == 0
        assert grid["blocks_per_sm"] >= 2 and grid["registers"] <= 128

    # (5011, 4096, 20): a block of VOCSIFTFisher's fit, one ragged row chunk.
    @pytest.mark.parametrize("n,d,k", GRAM_SHAPES + [(1000, 520, 147), (5011, 4096, 20)])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_gram_corr_sym(self, cuda_device, n, d, k, dtype):
        A, R = (_t(a).to(cuda_device) for a in _gram_inputs(n, d, k))
        A = A.to(dtype)
        before = dict(cuda_ops.launches)
        gram, corr = cuda_ops.gram_corr_sym(A, R)
        torch.cuda.synchronize()
        # gram_corr.cu's kernel, counted as gram_corr_sym's launch alone.
        assert cuda_ops.launches["gram_corr_sym"] == before["gram_corr_sym"] + 1
        assert cuda_ops.launches["gram_corr"] == before["gram_corr"]
        gram_r, corr_r = cuda_ops.gram_corr_sym_ref(A, R)
        assert torch.equal(gram, gram.T)
        assert _rel(gram.cpu().numpy(), gram_r.cpu().numpy()) < 1e-4
        assert _rel(corr.cpu().numpy(), corr_r.cpu().numpy()) < 1e-4

    def test_column_window_is_read_in_place(self, cuda_device):
        A, R = (_t(a).to(cuda_device) for a in _gram_inputs(700, 384, 147))
        window = A[:, 128:256]
        gram, corr = cuda_ops.gram_corr_sym(window, R)
        gram_r, corr_r = cuda_ops.gram_corr_sym_ref(window, R)
        assert _rel(gram.cpu().numpy(), gram_r.cpu().numpy()) < 1e-4
        assert _rel(corr.cpu().numpy(), corr_r.cpu().numpy()) < 1e-4

    def test_wrong_dtype_raises_instead_of_falling_back(self, cuda_device):
        A = torch.zeros((8, 4), dtype=torch.float16, device=cuda_device)
        with pytest.raises(TypeError):
            cuda_ops.gram_corr_sym(A, torch.zeros((8, 2), device=cuda_device))

    @pytest.mark.parametrize("m", [50000, 2048])
    def test_gaussian_kernel_block_at_nystrom_shapes(self, cuda_device, m):
        # Nystrom KRR's landmark blocks at the CIFAR geometry (d = 1,800,
        # 2,048 landmarks, gamma 5e-4): K(X, L) for 50,000 rows and the
        # square K(L, L), whose clamp keeps the diagonal at 1; within 1e-5
        # of the plain version, one launch a call.
        gen = torch.Generator(device=cuda_device).manual_seed(m)
        X = torch.randn((m, 1800), generator=gen, device=cuda_device)
        xn = (X * X).sum(1)
        L, ln = X[:2048], xn[:2048]
        before = cuda_ops.launches["gaussian_kernel_block"]
        got = cuda_ops.gaussian_kernel_block(X, L, xn, ln, 5e-4)
        want = cuda_ops.gaussian_kernel_block_ref(X, L, xn, ln, 5e-4)
        torch.cuda.synchronize()
        assert cuda_ops.launches["gaussian_kernel_block"] == before + 1
        assert got.shape == (m, 2048) and (got - want).abs().max().item() <= 1e-5
        assert float(got.max()) <= 1.0
        if m == 2048:
            assert float(got.diagonal().min()) >= 1.0 - 1e-5

    @pytest.mark.parametrize("kmeans", [True, False])
    def test_nystrom_fit_on_the_card_is_the_cpu_fit(self, cuda_device, kmeans):
        # NystromKernelRidge on the card (two gaussian_kernel_block launches a
        # fit, one an apply) against its plain run on the CPU: the same
        # landmarks (numpy's draws; k-means++ centres to rounding) and alpha
        # within 1e-4 relative.
        from keystone_tpu_torch.data import Dataset
        from keystone_tpu_torch.ops.learning.kernel import (
            GaussianKernelGenerator,
            NystromKernelRidge,
        )

        rng = _rng(3)
        X = rng.normal(size=(3000, 64)).astype(np.float32)
        Y = (2.0 * np.eye(4)[rng.integers(0, 4, 3000)] - 1.0).astype(np.float32)
        fits = {}
        for device in ("cpu", cuda_device):
            est = NystromKernelRidge(GaussianKernelGenerator(0.01), 1.0, 256,
                                     kmeans_landmarks=kmeans, seed=5)
            before = cuda_ops.launches["gaussian_kernel_block"]
            mapper = est.fit(Dataset(_t(X).to(device)), Dataset(_t(Y).to(device)))
            out = mapper.batch_apply(Dataset(_t(X[:100]).to(device))).array
            launched = cuda_ops.launches["gaussian_kernel_block"] - before
            fits[str(device)] = (mapper.landmarks.cpu().numpy(), mapper.alpha.cpu().numpy(),
                                 out.cpu().numpy(), launched)
        cpu, card = fits["cpu"], fits[str(cuda_device)]
        assert card[3] == 3
        for got, want, tol in zip(card[:3], cpu[:3], (1e-5, 1e-4, 1e-4)):
            assert _rel(got, want) <= tol

    def test_row_chunks_keep_every_form_bit_equal(self, cuda_device):
        # 12 whole 2,048-row Gramian chunks and a ragged one (csrc/gram_tile.cuh):
        # integer entries make every sum exact, so the kernel gives the plain
        # version's bits in any order; the accumulating form on a zero G
        # gives the storing form's, in place or into a new buffer.
        rng = _rng(21)
        n, d, k = 3 * 8192 + 100, 260, 5
        A = _t(rng.integers(-1, 2, size=(n, d)).astype(np.float32)).to(cuda_device)
        R = _t(rng.integers(-1, 2, size=(n, k)).astype(np.float32)).to(cuda_device)
        gram, corr = cuda_ops.gram_corr_sym(A, R)
        gram_r, corr_r = cuda_ops.gram_corr_sym_ref(A, R)
        assert torch.equal(gram, gram_r) and torch.equal(corr, corr_r)
        G = torch.zeros((d, d), device=cuda_device)
        fresh = cuda_ops.gram_sym_acc(G, A)
        cuda_ops.gram_sym_acc(G, A, out=G)
        upper = torch.triu(torch.ones((d, d), dtype=torch.bool, device=cuda_device))
        assert torch.equal(fresh[upper], gram[upper]) and torch.equal(G[upper], gram[upper])

    def test_cosine_sums_within_cublas_error_of_float64(self, cuda_device):
        # ROADMAP C.4: over 262,144 rows of cosine features the kernel's
        # float32 Gramian and correlation must be at most 1.25x as far from
        # float64 sums as cuBLAS's float32 ones (max |err| / max |f64|). One
        # fmaf chain over all rows was 2.8x (Gramian) and 7.4x (correlation)
        # as far at 589,824 rows on an H100; row chunks (gram_tile.cuh) cut it.
        gen = torch.Generator(device=cuda_device).manual_seed(5)
        n, d_in, d, k = 262144, 440, 1024, 147
        X = torch.randn((n, d_in), generator=gen, device=cuda_device) * 0.6
        W = torch.randn((d, d_in), generator=gen, device=cuda_device) * 0.05555
        b = torch.rand((d,), generator=gen, device=cuda_device) * 6.283185307179586
        F = cuda_ops.cosine_features(X, W, b)
        R = torch.randn((n, k), generator=gen, device=cuda_device)
        del X
        gram64 = torch.zeros((d, d), dtype=torch.float64, device=cuda_device)
        corr64 = torch.zeros((d, k), dtype=torch.float64, device=cuda_device)
        for start in range(0, n, 65536):
            Fc = F[start:start + 65536].double()
            gram64.addmm_(Fc.T, Fc)
            corr64.addmm_(Fc.T, R[start:start + 65536].double())

        def err(got, want):
            return ((got.double() - want).abs().max() / want.abs().max()).item()

        gram, corr = cuda_ops.gram_corr_sym(F, R)
        gram_r, corr_r = cuda_ops.gram_corr_sym_ref(F, R)
        assert err(gram, gram64) <= 1.25 * err(gram_r, gram64)
        assert err(corr, corr64) <= 1.25 * err(corr_r, corr64)
