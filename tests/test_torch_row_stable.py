"""The row-stable product (``cuda_ops.row_stable_matmul``, ROADMAP C.8's
repair): a row's bits depend on that row and W alone, never on how many
rows share the call, so every padding bucket of an exported plan serves a
row the same bits.

The CPU cases hold the plain version (``row_stable_matmul_ref``) to that
property at every row count from 1 to 300 and under zero padding, with
its rows split over 4 host threads and over 1, and to float64: each output's error stays
inside the bound of its summation, ``(min(k, 256) + ceil(k / 256)) * u *
(|X| @ |W|)`` with u = 2^-24 (every product and every add is rounded
once). They hold both of its forms so: the host form float32 CPU tensors
take (the native library's chunked fused multiply-add chains, also held
bit for bit to a float64 emulation of each ``fmaf`` step) and the
elementwise form the card and float64 take. The ``cuda`` cases run the kernel on the card against the same
bound and the plain version, and hold its rows bit-equal across row
counts, tile shapes (32- and 128-row tiles) and row panels; they skip
without a card. The file imports neither JAX nor the JAX package, so it
runs on the card's machine: ``python -m pytest tests/test_torch_row_stable.py
-m cuda --noconftest``.
"""

import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from keystone_tpu_torch import native
from keystone_tpu_torch.ops import cuda_ops
from keystone_tpu_torch.ops.cuda_ops import (
    ROW_STABLE_CHUNK,
    _row_stable_matmul_elementwise,
    row_stable_matmul,
    row_stable_matmul_ref,
)
from keystone_tpu_torch.ops.learning.block import BlockLinearMapper
from keystone_tpu_torch.ops.learning.linear import LinearMapper, mapper_product
from keystone_tpu_torch.serving import export_plan
from keystone_tpu_torch.serving.lifecycle import _bucket_identity_mismatch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_serving_util import fitted_from_transformer  # noqa: E402

U32 = 2.0 ** -24


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(m, k)).astype(np.float32)
    W = rng.normal(size=(k, n)).astype(np.float32)
    return X, W


def _bound(X, W):
    """Each output's rounding bound: (terms a chain + chunks) * u * |X||W|."""
    k = X.shape[1]
    terms = min(k, ROW_STABLE_CHUNK) + -(-k // ROW_STABLE_CHUNK)
    return terms * U32 * (np.abs(X).astype(np.float64) @ np.abs(W).astype(np.float64))


@contextmanager
def torch_threads(n):
    """The float32 CPU plain version splits its rows over
    ``torch.get_num_threads()`` C++ threads: this sets that count to n.
    ``torch.set_num_threads`` is not called: in the CPU build of torch
    these tests run on, any call to it makes a later batched float32 LU in
    the same process (``torch.linalg.solve`` of (3, 256, 256), as BWLS's
    class solve) spin forever inside MKL, and pytest runs other files in
    this process afterwards."""
    real = torch.get_num_threads
    torch.get_num_threads = lambda: n
    try:
        yield
    finally:
        torch.get_num_threads = real


_ELEMENTWISE_AT_ONE_THREAD = """
import sys
import numpy as np
import torch
from keystone_tpu_torch.ops.cuda_ops import _row_stable_matmul_elementwise
torch.set_num_threads(1)
X, W = np.load(sys.argv[1]), np.load(sys.argv[2])
out = _row_stable_matmul_elementwise(torch.from_numpy(X), torch.from_numpy(W))
np.save(sys.argv[3], out.numpy())
"""


class TestPlainVersion:
    @settings(max_examples=6, deadline=None)
    @given(k=st.integers(1, 600), n=st.integers(1, 12), seed=st.integers(0, 2**16))
    def test_rows_bit_equal_at_every_row_count_and_padding(self, k, n, seed):
        X, W = _operands(300, k, n, seed)
        Xt, Wt = torch.from_numpy(X), torch.from_numpy(W)
        with torch_threads(4):
            full = row_stable_matmul_ref(Xt, Wt)
            for m in range(1, 301):
                assert torch.equal(row_stable_matmul_ref(Xt[:m], Wt), full[:m]), m
            for m in (1, 2, 5, 64, 255):
                padded = torch.cat([Xt[:m], torch.zeros(300 - m, k)])
                assert torch.equal(row_stable_matmul_ref(padded, Wt)[:m], full[:m]), m
            # A row anywhere in the batch: its position does not matter.
            perm = torch.from_numpy(np.random.default_rng(seed).permutation(300))
            assert torch.equal(row_stable_matmul_ref(Xt[perm], Wt), full[perm])
        # And the thread count does not either.
        with torch_threads(1):
            assert torch.equal(row_stable_matmul_ref(Xt, Wt), full)

    @pytest.mark.parametrize("k", [1, 7, 256, 257, 700, 2048])
    def test_within_the_summation_bound_of_float64(self, k):
        X, W = _operands(37, k, 19, k)
        got = row_stable_matmul_ref(torch.from_numpy(X), torch.from_numpy(W)).numpy()
        exact = X.astype(np.float64) @ W.astype(np.float64)
        assert np.all(np.abs(got - exact) <= _bound(X, W))

    def test_float64_operands_stay_float64(self):
        X, W = _operands(5, 300, 3, 0)
        X64, W64 = torch.from_numpy(X).double(), torch.from_numpy(W).double()
        got = row_stable_matmul_ref(X64, W64)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), X64.numpy() @ W64.numpy(), rtol=1e-12, atol=1e-12)

    def test_empty_operands(self):
        assert row_stable_matmul(torch.zeros(0, 4), torch.zeros(4, 3)).shape == (0, 3)
        assert torch.equal(row_stable_matmul(torch.ones(2, 0), torch.zeros(0, 3)),
                           torch.zeros(2, 3))

    def test_mismatched_operands_raise(self):
        with pytest.raises(ValueError, match="do not match"):
            row_stable_matmul(torch.zeros(2, 4), torch.zeros(5, 3))
        with pytest.raises(TypeError, match="one floating dtype"):
            row_stable_matmul(torch.zeros(2, 4), torch.zeros(4, 3, dtype=torch.float64))

    def test_the_cpu_path_counts_no_launch(self):
        cuda_ops.reset_launch_counts()
        row_stable_matmul(torch.ones(3, 4), torch.ones(4, 2))
        assert cuda_ops.launches["row_stable_matmul"] == 0

    def test_meta_operands_give_an_empty_meta_output(self):
        out = row_stable_matmul(torch.empty(6, 4, device="meta"), torch.empty(4, 3, device="meta"))
        assert out.device.type == "meta" and out.shape == (6, 3) and out.dtype == torch.float32
        with pytest.raises(TypeError, match="float32"):
            row_stable_matmul(torch.empty(6, 4, device="meta", dtype=torch.float64),
                              torch.empty(4, 3, device="meta", dtype=torch.float64))


def _fma_chains(X, W, chunk):
    """The host form's sums, emulated: each fmaf step as the float64 sum of
    the exact product and the accumulator, rounded to float32 (a float64
    add rounds only when the operands' exponents lie far apart, and then
    the float32 rounding agrees but for a tie this data does not hit),
    chunks of ``chunk`` indices, their sums added in float32 in order."""
    X64, W64 = X.astype(np.float64), W.astype(np.float64)
    out = None
    for lo in range(0, X.shape[1], chunk):
        acc = np.zeros((X.shape[0], W.shape[1]), np.float32)
        for i in range(lo, min(lo + chunk, X.shape[1])):
            acc = (X64[:, i:i + 1] * W64[i] + acc).astype(np.float32)
        out = acc if out is None else out + acc
    return out


class TestPlainForms:
    @pytest.mark.parametrize("k,n", [(1, 3), (7, 33), (255, 5), (256, 32), (257, 1),
                                     (600, 40), (1024, 2)])
    @pytest.mark.parametrize("chunk", [ROW_STABLE_CHUNK, 1 << 20])
    def test_host_chains_equal_an_emulation_of_fmaf(self, k, n, chunk):
        X, W = _operands(5, k, n, k + n)
        got = native.matmul_fma_chain_f32(torch.from_numpy(X), torch.from_numpy(W), chunk, 4)
        np.testing.assert_array_equal(got.numpy(), _fma_chains(X, W, chunk))

    def test_float32_cpu_plain_version_is_the_host_form(self):
        X, W = _operands(9, 700, 6, 2)
        Xt, Wt = torch.from_numpy(X), torch.from_numpy(W)
        assert torch.equal(row_stable_matmul_ref(Xt, Wt),
                           native.matmul_fma_chain_f32(Xt, Wt, ROW_STABLE_CHUNK, 1))

    @settings(max_examples=4, deadline=None)
    @given(k=st.integers(1, 600), n=st.integers(1, 12), seed=st.integers(0, 2**16))
    def test_elementwise_form_rows_bit_equal_at_every_row_count_and_padding(self, k, n, seed):
        X, W = _operands(300, k, n, seed)
        Xt, Wt = torch.from_numpy(X), torch.from_numpy(W)
        full = _row_stable_matmul_elementwise(Xt, Wt)
        for m in (1, 2, 3, 17, 64, 255, 299):
            assert torch.equal(_row_stable_matmul_elementwise(Xt[:m], Wt), full[:m]), m
        padded = torch.cat([Xt[:5], torch.zeros(295, k)])
        assert torch.equal(_row_stable_matmul_elementwise(padded, Wt)[:5], full[:5])
        perm = torch.from_numpy(np.random.default_rng(seed).permutation(300))
        assert torch.equal(_row_stable_matmul_elementwise(Xt[perm], Wt), full[perm])

    def test_elementwise_form_bits_at_one_torch_thread(self, tmp_path):
        # torch's thread count set in a process of its own (see torch_threads).
        X, W = _operands(300, 600, 7, 11)
        for name, a in (("X", X), ("W", W)):
            np.save(tmp_path / f"{name}.npy", a)
        subprocess.run([sys.executable, "-c", _ELEMENTWISE_AT_ONE_THREAD,
                        str(tmp_path / "X.npy"), str(tmp_path / "W.npy"),
                        str(tmp_path / "out.npy")],
                       check=True, cwd=Path(__file__).resolve().parent.parent, timeout=300)
        full = _row_stable_matmul_elementwise(torch.from_numpy(X), torch.from_numpy(W))
        np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), full.numpy())

    @pytest.mark.parametrize("k", [1, 7, 256, 257, 700, 2048])
    def test_elementwise_form_within_the_summation_bound_of_float64(self, k):
        X, W = _operands(37, k, 19, k)
        got = _row_stable_matmul_elementwise(torch.from_numpy(X), torch.from_numpy(W)).numpy()
        exact = X.astype(np.float64) @ W.astype(np.float64)
        assert np.all(np.abs(got - exact) <= _bound(X, W))


class TestMappers:
    def test_mapper_product_routes_float32_only(self):
        X, W = _operands(9, 300, 4, 1)
        Xt, Wt = torch.from_numpy(X), torch.from_numpy(W)
        assert torch.equal(mapper_product(Xt, Wt), row_stable_matmul_ref(Xt, Wt))
        X64, W64 = Xt.double(), Wt.double()
        assert torch.equal(mapper_product(X64, W64), X64 @ W64)

    def test_linear_mapper_rows_do_not_depend_on_the_batch(self):
        X, W = _operands(64, 40, 5, 2)
        b = np.arange(5, dtype=np.float32)
        fn = LinearMapper(W, b_opt=b).device_fn()
        full = fn(torch.from_numpy(X))
        for m in (1, 2, 3, 17, 63):
            assert torch.equal(fn(torch.from_numpy(X[:m])), full[:m])
        np.testing.assert_allclose(full.numpy(), X @ W + b, rtol=1e-5, atol=1e-5)

    def test_block_mapper_rows_do_not_depend_on_the_batch(self):
        X, W = _operands(70, 600, 6, 3)
        mapper = BlockLinearMapper([W[:256], W[256:512], W[512:]], 256,
                                   b_opt=np.ones(6, np.float32))
        fn = mapper.device_fn()
        full = fn(torch.from_numpy(X))
        for m in (1, 2, 33, 69):
            assert torch.equal(fn(torch.from_numpy(X[:m])), full[:m])
        np.testing.assert_allclose(full.numpy(), X @ W + 1.0, rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("mapper", ["linear", "block"])
    def test_every_bucket_of_an_exported_plan_gives_the_same_bits(self, mapper):
        X, W = _operands(1, 520, 7, 4)
        op = (LinearMapper(W) if mapper == "linear"
              else BlockLinearMapper([W[:256], W[256:]], 256))
        plan = export_plan(fitted_from_transformer(op), np.zeros(520, np.float32),
                           max_batch=64, device="cpu")
        assert plan.compiled and plan.buckets == [2, 4, 8, 16, 32, 64]
        assert _bucket_identity_mismatch(plan) is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the row-stable kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelOnCard:
    @pytest.mark.parametrize("m,k,n", [
        (1, 1, 1), (2, 17, 4), (3, 256, 147), (65, 257, 33), (130, 700, 147),
        (300, 1024, 161), (64, 440, 200), (2, 16384, 147),
    ])
    def test_within_the_bound_and_near_the_plain_version(self, cuda_device, m, k, n):
        X, W = _operands(m, k, n, m + k + n)
        Xc, Wc = torch.from_numpy(X).to(cuda_device), torch.from_numpy(W).to(cuda_device)
        cuda_ops.reset_launch_counts()
        got = row_stable_matmul(Xc, Wc)
        torch.cuda.synchronize()
        assert cuda_ops.launches["row_stable_matmul"] == 1
        got = got.cpu().numpy()
        bound = _bound(X, W)
        assert np.all(np.abs(got - X.astype(np.float64) @ W.astype(np.float64)) <= bound)
        plain = row_stable_matmul_ref(torch.from_numpy(X), torch.from_numpy(W)).numpy()
        assert np.all(np.abs(got - plain) <= 2 * bound)

    def test_rows_bit_equal_across_row_counts_tiles_and_panels(self, cuda_device, monkeypatch):
        X, W = _operands(1000, 1300, 147, 7)
        Xc, Wc = torch.from_numpy(X).to(cuda_device), torch.from_numpy(W).to(cuda_device)
        full = row_stable_matmul(Xc, Wc)
        for m in (1, 2, 3, 31, 64, 65, 128, 129, 256, 999):
            assert torch.equal(row_stable_matmul(Xc[:m], Wc), full[:m]), m
        padded = torch.cat([Xc[:5], torch.zeros(251, 1300, device=cuda_device)])
        assert torch.equal(row_stable_matmul(padded, Wc)[:5], full[:5])
        # Row panels of 128 rows: a schedule, not a change of sums.
        monkeypatch.setattr(cuda_ops, "_ROW_STABLE_SCRATCH", 6 * 147 * 128)
        assert cuda_ops._row_stable_panel_rows(1000, 147, 1300) == 128
        assert torch.equal(row_stable_matmul(Xc, Wc), full)

    def test_unaligned_operands_give_the_aligned_bits(self, cuda_device):
        X, W = _operands(70, 513, 148, 8)
        Xc, Wc = torch.from_numpy(X).to(cuda_device), torch.from_numpy(W).to(cuda_device)
        want = row_stable_matmul(Xc[:, :512], Wc[:512])  # 16-byte rows both
        Xs = torch.zeros(70, 513, device=cuda_device)
        Xs[:, 1:] = Xc[:, :512]  # a view whose base is 4 bytes off
        Ws = torch.zeros(512, 149, device=cuda_device)
        Ws[:, :148] = Wc[:512]
        got = row_stable_matmul(Xs[:, 1:], Ws[:, :148])
        assert torch.equal(got, want)

    def test_rejects_what_the_kernel_does_not_take(self, cuda_device):
        with pytest.raises(TypeError, match="float32"):
            row_stable_matmul(torch.zeros(2, 3, device=cuda_device, dtype=torch.float64),
                              torch.zeros(3, 2, device=cuda_device, dtype=torch.float64))
        with pytest.raises(ValueError, match="one CUDA device"):
            row_stable_matmul(torch.zeros(2, 3, device=cuda_device), torch.zeros(3, 2))

    def test_cosine_plan_buckets_bit_equal_on_the_card(self, cuda_device):
        from keystone_tpu_torch.data import Dataset
        from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
        from keystone_tpu_torch.ops.stats import CosineRandomFeatures
        from keystone_tpu_torch.workflow import PipelineEnv

        PipelineEnv.get_or_create().reset()
        rng = np.random.default_rng(0)
        X = torch.from_numpy(rng.normal(size=(512, 40)).astype(np.float32)).to(cuda_device)
        Y = torch.from_numpy(rng.normal(size=(512, 11)).astype(np.float32)).to(cuda_device)
        crf = CosineRandomFeatures(40, 1024, 0.3, seed=0, device=cuda_device)
        fitted = crf.to_pipeline().and_then(BlockLeastSquaresEstimator(512, 1, 1e-2),
                                            Dataset(X), Dataset(Y)).fit()
        PipelineEnv.get_or_create().reset()
        plan = export_plan(fitted, np.zeros(40, np.float32), max_batch=64)
        assert _bucket_identity_mismatch(plan) is None
        assert all(p.get("row_stable_matmul") == 1 for p in plan.launches_per_replay.values())
        Xn = X[:64].cpu().numpy()
        batch = plan.apply_batch(list(Xn))
        for i in (0, 5, 63):
            np.testing.assert_array_equal(plan.apply_batch([Xn[i]])[0], batch[i])
