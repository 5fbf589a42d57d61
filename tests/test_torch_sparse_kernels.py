"""The sparse gram fold's CUDA kernel, gram_corr_sym_acc
(keystone_tpu_torch/ops/cuda_ops.py, csrc/gram_corr_sym_acc.cu), against its
plain version, its wrapper's contract, and the fold around it on the card.

This file imports no JAX, so that it runs on the machine with the card,
which has none: ``python -m pytest tests/test_torch_sparse_kernels.py -m cuda
--noconftest``. The ``cuda`` tests skip without a card; the plain version
is held against the JAX package's Pallas kernel in
tests/test_torch_sparse.py.

Tolerances (kernel against plain version, same inputs on the card): the
upper-triangle tiles of the Gramian within 1e-5 of the sums' scale
|G₀| + Σ|fᵢ||fⱼ|, the correlation within 1e-5 of |C₀| + Σ|f||r| (float32
products summed in other orders; bf16 operands and their products are exact
in float32). That holds for bf16 F too, on the tensor cores: their adds
into an f32 accumulator do not round to nearest, so the kernel sums only
two 64-row stages on them and adds those partial sums in FP32 (measured on
an H100: at most 3.5e-6 of scale at these shapes, 1.4e-5 at the 65,536-row
Amazon chunk, which chip_smoke.py holds to 1e-4). bf16 F must lie at a row
stride of a multiple of 8 elements on a 16-byte boundary (the kernel's TMA
loads); ``_operands`` lays it at the fold's stride. In place and into a new
buffer give the same bits, and so do repeated runs; the strictly-lower
tiles are left as they were in place.
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.resident import raw_chunk_tiles
from keystone_tpu_torch.ops import cuda_ops, sparse
from keystone_tpu_torch.ops.learning.lbfgs import (
    SparseLBFGSwithL2,
    _resident_chunk_fn,
    run_lbfgs_gram_streamed,
)


CORR_CHUNK = 256  # the correlation's row chunk (csrc/gram_tile.cuh)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _aligned(F, dtype):
    """F in ``dtype``; bf16 at a row stride rounded up to 64 elements, as
    the fold lays its slabs out for the kernel's TMA loads."""
    if dtype != torch.bfloat16:
        return F.to(dtype)
    n, d = F.shape
    out = torch.zeros((n, -(-d // 64) * 64), dtype=dtype, device=F.device)[:, :d]
    out.copy_(F)
    return out


def _operands(n, d, k, seed=0, device="cpu", dtype=torch.float32):
    rng = np.random.default_rng(seed)
    F = _aligned(_t(rng.normal(size=(n, d)).astype(np.float32)).to(device), dtype)
    R = _t(rng.normal(size=(n, k)).astype(np.float32)).to(device)
    G = _t(rng.normal(size=(d, d)).astype(np.float32)).to(device)
    C = _t(rng.normal(size=(d, k)).astype(np.float32)).to(device)
    return G, C, F, R


def _upper(d, device):
    tiles = torch.arange(d, device=device) // 128
    return tiles[:, None] <= tiles[None, :]


def _coo(n, d, w, k, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(n, w)).astype(np.int32)
    idx[rng.random(size=(n, w)) < 0.1] = -1
    vals = rng.normal(size=(n, w)).astype(np.float32)
    Y = (2.0 * np.eye(k, dtype=np.float32)[rng.integers(0, k, size=n)] - 1.0)
    return idx, vals, Y


# ---------------------------------------------------------------------------
# Contract, on the CPU
# ---------------------------------------------------------------------------


class TestContract:
    def test_counter_and_entry_point(self):
        assert isinstance(cuda_ops.launches["gram_corr_sym_acc"], int)
        assert "gram_corr_sym_acc" in cuda_ops._ENTRY_POINTS
        cuda_ops.launches["gram_corr_sym_acc"] += 3
        cuda_ops.reset_launch_counts()
        assert cuda_ops.launches["gram_corr_sym_acc"] == 0

    def test_cpu_wrapper_takes_the_plain_version(self):
        G, C, F, R = _operands(50, 20, 3)
        before = dict(cuda_ops.launches)
        gram, corr = cuda_ops.gram_corr_sym_acc(G, C, F, R)
        want_g, want_c = cuda_ops.gram_corr_sym_acc_ref(G, C, F, R)
        assert torch.equal(gram, want_g) and torch.equal(corr, want_c)
        Gi, Ci = G.clone(), C.clone()
        out = cuda_ops.gram_corr_sym_acc(Gi, Ci, F, R, out=(Gi, Ci))
        assert out[0] is Gi and out[1] is Ci
        assert torch.equal(Gi, want_g) and torch.equal(Ci, want_c)
        assert cuda_ops.launches == before

    def test_plain_version_rounds_labels_to_bf16_f(self):
        G, C, F, R = _operands(40, 10, 2, seed=1)
        F16 = F.to(torch.bfloat16)
        _, corr = cuda_ops.gram_corr_sym_acc_ref(G, C, F16, R)
        Rq = R.to(torch.bfloat16).float()
        torch.testing.assert_close(corr, C + F16.float().T @ Rq, rtol=0, atol=1e-5)
        _, corr32 = cuda_ops.gram_corr_sym_acc_ref(G, C, F, R)
        torch.testing.assert_close(corr32, C + F.T @ R, rtol=0, atol=1e-5)

    def test_guard(self):
        assert cuda_ops.gram_corr_acc_ok(torch.empty((8, 5)))
        # bf16 F is read by TMA: a 16-byte-aligned base and a row stride of
        # a multiple of 8 elements.
        assert cuda_ops.gram_corr_acc_ok(torch.empty((8, 8), dtype=torch.bfloat16))
        assert not cuda_ops.gram_corr_acc_ok(torch.empty((8, 5), dtype=torch.bfloat16))
        assert not cuda_ops.gram_corr_acc_ok(torch.empty((8, 16), dtype=torch.bfloat16)[:, 1:6])
        assert cuda_ops.gram_corr_acc_ok(torch.empty((8, 64), dtype=torch.bfloat16)[:, 8:13])
        assert cuda_ops.gram_corr_acc_ok(torch.empty((8, 9))[:, :5])  # contiguous rows
        assert not cuda_ops.gram_corr_acc_ok(torch.empty((5, 8)).T)
        assert not cuda_ops.gram_corr_acc_ok(torch.empty((8, 5), dtype=torch.float64))
        assert not cuda_ops.gram_corr_acc_ok(torch.empty((8,)))
        assert cuda_ops.gram_corr_acc_ok(torch.empty((0, 5)).as_strided((0, 5), (0, 0)))

    def test_non_cpu_non_cuda_tensors_raise(self):
        def meta(*shape):
            return torch.empty(shape, device="meta")

        with pytest.raises(ValueError, match="CUDA"):
            cuda_ops.gram_corr_sym_acc(meta(4, 4), meta(4, 2), meta(6, 4), meta(6, 2))

    def test_row_aligned_densify_keeps_the_values(self):
        rng = np.random.default_rng(7)
        idx = _t(rng.integers(-1, 70, size=(30, 12)).astype(np.int32))
        vals = _t(rng.normal(size=(30, 12)).astype(np.float32))
        for d in (1, 65, 67, 128):
            plain = sparse._dense_rows(idx, vals, d, torch.bfloat16)
            aligned = sparse._dense_rows(idx, vals, d, torch.bfloat16, row_align=64)
            assert aligned.shape == plain.shape == (30, d)
            assert aligned.stride() == (-(-d // 64) * 64, 1) and plain.stride() == (d, 1)
            assert torch.equal(aligned, plain)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_fold_slab_passes_the_guard_with_the_values_of_the_densify(self, monkeypatch,
                                                                         dtype):
        n, d, w, k, c = 700, 131, 9, 2, 256
        idx, vals, Y = _coo(n, d, w, k, seed=8)
        ops = raw_chunk_tiles(_t(idx), _t(vals), _t(Y), c)
        seen = []
        fold = cuda_ops.gram_corr_sym_acc

        def spy(G, C, F, R, out=None):
            seen.append(F)
            return fold(G, C, F, R, out=out)

        monkeypatch.setattr(sparse.cuda_ops, "gram_corr_sym_acc", spy)
        sparse.sparse_gram_stream(lambda cid: _resident_chunk_fn(cid, *ops), ops[0].shape[0],
                                  d, k, val_dtype=dtype)
        assert len(seen) == ops[0].shape[0] == 3
        for cid, F in enumerate(seen):
            chunk_idx, chunk_vals, _ = _resident_chunk_fn(cid, *ops)
            want = sparse._dense_rows(chunk_idx, chunk_vals, d, dtype)
            assert F.shape == (c, d) and torch.equal(F, want)
            assert cuda_ops.gram_corr_acc_ok(F)
            assert F.stride(0) == (192 if dtype == torch.bfloat16 else 132)

    def test_padded_float32_fold_has_the_bits_of_the_unpadded_one(self, monkeypatch):
        # The float32 slab's rows are padded to 4 elements (16 bytes) so the
        # kernel copies them in 16-byte chunks; the pad is never read, so the
        # fold's sums are those of contiguous slabs.
        n, d, w, k, c = 600, 131, 9, 2, 256
        idx, vals, Y = _coo(n, d, w, k, seed=9)
        ops = raw_chunk_tiles(_t(idx), _t(vals), _t(Y), c)

        def fold():
            return sparse.sparse_gram_stream(lambda cid: _resident_chunk_fn(cid, *ops),
                                             ops[0].shape[0], d, k, val_dtype=torch.float32)

        padded = fold()
        monkeypatch.setattr(sparse, "_SLAB_ROW_ALIGN", {})
        plain = fold()
        for a, b in zip(padded, plain, strict=True):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Kernel against plain version: needs the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


# (n, d, k): aligned, ragged rows and columns, one-column last tile (the
# Amazon d₁ = 16,385 in small), and label widths across the 8-wide passes.
SHAPES = [(512, 256, 2), (1000, 300, 2), (333, 129, 1), (64, 385, 8), (200, 140, 9),
          (150, 257, 17), (96, 130, 130), (1, 1, 1), (0, 130, 2), (4096, 1025, 2),
          (300, 257, 33), (128, 129, 200)]


def _check(got, want, G, C, F, R, upper):
    Ff = F.float()
    Rq = R.to(torch.bfloat16).float() if F.dtype == torch.bfloat16 else R
    g_scale = torch.addmm(G.abs(), Ff.abs().T, Ff.abs())
    c_scale = torch.addmm(C.abs(), Ff.abs().T, Rq.abs())
    g_rel = ((got[0] - want[0]).abs() / g_scale)[upper]
    c_rel = (got[1] - want[1]).abs() / c_scale
    assert g_rel.numel() == 0 or g_rel.max().item() <= 1e-5
    assert c_rel.numel() == 0 or c_rel.max().item() <= 1e-5


@pytest.mark.cuda
class TestKernelOnCard:
    @pytest.mark.parametrize("n,d,k", SHAPES)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_against_plain_version(self, cuda_device, n, d, k, dtype):
        G, C, F, R = _operands(n, d, k, device=cuda_device, dtype=dtype)
        before = cuda_ops.launches["gram_corr_sym_acc"]
        got = cuda_ops.gram_corr_sym_acc(G, C, F, R)
        torch.cuda.synchronize()
        assert cuda_ops.launches["gram_corr_sym_acc"] == before + 1
        want = cuda_ops.gram_corr_sym_acc_ref(G, C, F, R)
        assert got[0].shape == (d, d) and got[1].shape == (d, k)
        _check(got, want, G, C, F, R, _upper(d, cuda_device))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_in_place_has_the_bits_of_a_new_buffer(self, cuda_device, dtype):
        G, C, F, R = _operands(700, 300, 3, seed=2, device=cuda_device, dtype=dtype)
        fresh = cuda_ops.gram_corr_sym_acc(G, C, F, R)
        Gi, Ci = G.clone(), C.clone()
        out = cuda_ops.gram_corr_sym_acc(Gi, Ci, F, R, out=(Gi, Ci))
        torch.cuda.synchronize()
        upper = _upper(300, cuda_device)
        assert out[0] is Gi and out[1] is Ci
        assert torch.equal(Gi[upper], fresh[0][upper]) and torch.equal(Ci, fresh[1])
        assert torch.equal(Gi[~upper], G[~upper])  # lower tiles untouched

    def test_labels_are_rounded_to_bf16_with_bf16_f(self, cuda_device):
        # Labels with bits below bf16's mantissa: the correlation must be
        # the one of the rounded labels (F is a 0/1 indicator, so the sums
        # are exact and the comparison can be bitwise).
        n, d = 64, 16
        F = torch.zeros((n, d), device=cuda_device)
        F[torch.arange(n), torch.arange(n) % d] = 1.0
        R = (1.0 + torch.arange(n, device=cuda_device, dtype=torch.float32)[:, None]
             * 2.0 ** -12).repeat(1, 2)
        G, C = torch.zeros((d, d), device=cuda_device), torch.zeros((d, 2), device=cuda_device)
        _, corr16 = cuda_ops.gram_corr_sym_acc(G, C, F.to(torch.bfloat16), R)
        _, corr32 = cuda_ops.gram_corr_sym_acc(G, C, F, R)
        Rq = R.to(torch.bfloat16).float()
        assert torch.equal(corr16, F.T @ Rq)
        assert torch.equal(corr32, F.T @ R)
        assert not torch.equal(corr16, corr32)

    def test_column_window_is_read_through_its_row_stride(self, cuda_device):
        G, C, F, R = _operands(300, 200, 2, seed=3, device=cuda_device)
        wide = torch.zeros((300, 260), device=cuda_device)
        wide[:, 30:230] = F
        got = cuda_ops.gram_corr_sym_acc(G, C, wide[:, 30:230], R)
        want = cuda_ops.gram_corr_sym_acc_ref(G, C, F, R)
        _check(got, want, G, C, F, R, _upper(200, cuda_device))
        # bf16: a window on a 16-byte boundary of rows 8-element aligned.
        wide16 = torch.zeros((300, 264), dtype=torch.bfloat16, device=cuda_device)
        wide16[:, 32:232] = F
        F16 = wide16[:, 32:232]
        got = cuda_ops.gram_corr_sym_acc(G, C, F16, R)
        want = cuda_ops.gram_corr_sym_acc_ref(G, C, F16, R)
        _check(got, want, G, C, F16, R, _upper(200, cuda_device))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_repeated_runs_give_equal_bits(self, cuda_device, dtype):
        G, C, F, R = _operands(1500, 520, 9, seed=4, device=cuda_device, dtype=dtype)
        first = cuda_ops.gram_corr_sym_acc(G, C, F, R)
        upper = _upper(520, cuda_device)
        for _ in range(3):
            again = cuda_ops.gram_corr_sym_acc(G, C, F, R)
            assert torch.equal(again[0][upper], first[0][upper])
            assert torch.equal(again[1], first[1])

    @pytest.mark.parametrize("n,d,k", [(700, 129, 2), (333, 257, 33), (90, 300, 170)])
    def test_f32_row_strides_give_the_same_bits(self, cuda_device, n, d, k):
        # float32 F at a row stride of d (element-wise copies where d is not
        # a multiple of 4), of d rounded up to 4 (16-byte copies, the last
        # chunk in part: the fold's layout), wider, and at a base 4 bytes
        # off: every layout gives the same bits, in place those of a new
        # buffer, the strictly-lower tiles untouched.
        G, C, F, R = _operands(n, d, k, seed=5, device=cuda_device)
        upper = _upper(d, cuda_device)
        first = None
        for ld, off in ((d, 0), (-(-d // 4) * 4, 0), (d + 7, 0), (d + 4, 1)):
            wide = torch.full((n, ld + off), float("nan"), device=cuda_device)
            Fk = wide[:, off:off + d]
            Fk.copy_(F)
            fresh = cuda_ops.gram_corr_sym_acc(G, C, Fk, R)
            Gi, Ci = G.clone(), C.clone()
            cuda_ops.gram_corr_sym_acc(Gi, Ci, Fk, R, out=(Gi, Ci))
            torch.cuda.synchronize()
            assert torch.equal(Gi[upper], fresh[0][upper]) and torch.equal(Ci, fresh[1])
            assert torch.equal(Gi[~upper], G[~upper])
            if first is None:
                first = fresh
                _check(fresh, cuda_ops.gram_corr_sym_acc_ref(G, C, F, R), G, C, F, R, upper)
            assert torch.equal(fresh[0][upper], first[0][upper])
            assert torch.equal(fresh[1], first[1])

    @pytest.mark.parametrize("n,d,k", [(1000, 300, 2), (257, 129, 147)])
    def test_f32_has_the_bits_of_gram_sym_acc_and_gram_corr_sym(self, cuda_device, n, d, k):
        # One Gramian kernel: G + FᵀF is gram_sym_acc's, bit for bit, and
        # C + FᵀR is C plus gram_corr_sym's correlation of each chunk of
        # CORR_CHUNK rows, added in row order (gram_tile.cuh: one fmaf chain
        # an entry over a chunk's rows, from zero, then one add to the
        # running total, which starts at C).
        G, C, F, R = _operands(n, d, k, seed=6, device=cuda_device)
        gram, corr = cuda_ops.gram_corr_sym_acc(G, C, F, R)
        upper = _upper(d, cuda_device)
        assert torch.equal(gram[upper], cuda_ops.gram_sym_acc(G, F)[upper])
        want = C
        for i in range(0, n, CORR_CHUNK):
            want = want + cuda_ops.gram_corr_sym(F[i:i + CORR_CHUNK], R[i:i + CORR_CHUNK])[1]
        assert n > CORR_CHUNK and torch.equal(corr, want)

    @pytest.mark.parametrize("n,d,k", [(1000, 300, 2), (257, 129, 147)])
    def test_bf16_has_the_bits_of_gram_sym_acc_and_block_gram_sym(self, cuda_device, n, d, k):
        # One tensor-core mainloop (gram_wgmma.cuh): the bf16 Gramian of
        # gram_corr_sym_acc is gram_sym_acc's, bit for bit, and
        # block_gram_sym's is gram_sym_acc's on G = 0, mirrored (0 + x = x).
        G, C, F, R = _operands(n, d, k, seed=7, device=cuda_device, dtype=torch.bfloat16)
        gram, _ = cuda_ops.gram_corr_sym_acc(G, C, F, R)
        upper = _upper(d, cuda_device)
        assert torch.equal(gram[upper], cuda_ops.gram_sym_acc(G, F)[upper])
        acc = cuda_ops.gram_sym_acc(torch.zeros_like(G), F)
        assert torch.equal(cuda_ops.block_gram_sym(F, 0, d),
                           torch.triu(acc) + torch.triu(acc, 1).T)

    @pytest.mark.parametrize("ld,vec", [(16385, False), (16388, True)])
    def test_f32_grid_at_the_amazon_chunk(self, cuda_device, ld, vec):
        # d₁ = 16,385, k = 2: 257 correlation blocks of 64 columns with the
        # 32-wide label tile, then 129 · 130 / 2 = 8,385 upper tiles; the
        # fold's padded layout (16,388) takes the 16-byte copies.
        F = torch.empty((2, ld), device=cuda_device)[:, :16385]
        grid = cuda_ops.gram_corr_sym_acc_grid(F, 2)
        assert grid["gram_blocks"] == 8385 and grid["corr_blocks"] == 257
        assert grid["ktile"] == 32 and grid["corr_cols"] == 64 and grid["vec"] == vec
        assert grid["local_bytes"] == 0
        assert grid["blocks_per_sm"] >= 2 and grid["registers"] <= 128
        with pytest.raises(TypeError):
            cuda_ops.gram_corr_sym_acc_grid(F.to(torch.bfloat16), 2)

    def test_misaligned_bf16_f_raises_and_is_not_copied(self, cuda_device):
        G, C, F, R = _operands(64, 20, 2, device=cuda_device)
        before = cuda_ops.launches["gram_corr_sym_acc"]
        with pytest.raises(TypeError, match="multiple of 8"):
            cuda_ops.gram_corr_sym_acc(G, C, F.to(torch.bfloat16), R)  # row stride 20
        wide = torch.zeros((64, 32), dtype=torch.bfloat16, device=cuda_device)
        with pytest.raises(TypeError, match="16-byte"):
            cuda_ops.gram_corr_sym_acc(G, C, wide[:, 1:21], R)  # base 2 bytes off
        assert cuda_ops.launches["gram_corr_sym_acc"] == before

    def test_what_the_kernel_refuses_raises(self, cuda_device):
        G, C, F, R = _operands(30, 20, 2, device=cuda_device)
        with pytest.raises(TypeError):
            cuda_ops.gram_corr_sym_acc(G, C, F.double(), R)
        with pytest.raises(TypeError):
            cuda_ops.gram_corr_sym_acc(G, C, F.T.contiguous().T, R)
        with pytest.raises(ValueError):
            cuda_ops.gram_corr_sym_acc(G[:10, :10], C, F, R)
        with pytest.raises(ValueError):
            cuda_ops.gram_corr_sym_acc(G, C, F, R[:10])


@pytest.mark.cuda
class TestFoldOnCard:
    def test_fold_launches_once_a_chunk_and_matches_the_cpu(self, cuda_device):
        n, d, w, k, c = 2000, 300, 12, 2, 512
        idx, vals, Y = _coo(n, d, w, k)
        runs = {}
        for device in ("cpu", cuda_device):
            ops = raw_chunk_tiles(_t(idx).to(device), _t(vals).to(device), _t(Y).to(device), c)
            before = cuda_ops.launches["gram_corr_sym_acc"]
            G, AtY, yty = sparse.sparse_gram_stream(
                lambda cid: _resident_chunk_fn(cid, *ops), ops[0].shape[0], d, k)
            runs[str(device)] = (G.cpu(), AtY.cpu(), float(yty))
            launched = cuda_ops.launches["gram_corr_sym_acc"] - before
            assert launched == (4 if device == cuda_device else 0)
        (Gc, Ac, yc), (Gg, Ag, yg) = runs["cpu"], runs[str(cuda_device)]
        assert torch.equal(Gg, Gg.T)
        torch.testing.assert_close(Gg, Gc, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(Ag, Ac, rtol=1e-5, atol=1e-4)
        assert yg == pytest.approx(yc, rel=1e-6)

    def test_densify_has_the_same_bits_on_card_and_cpu(self, cuda_device):
        rng = np.random.default_rng(4)
        idx = _t(rng.integers(-1, 50, size=(300, 40)).astype(np.int32))  # many duplicates
        vals = _t(rng.normal(size=(300, 40)).astype(np.float32))
        for dtype in (torch.float32, torch.bfloat16):
            cpu = sparse._dense_rows(idx, vals, 48, dtype)
            card = sparse._dense_rows(idx.to(cuda_device), vals.to(cuda_device), 48, dtype)
            again = sparse._dense_rows(idx.to(cuda_device), vals.to(cuda_device), 48, dtype)
            assert torch.equal(card.cpu(), cpu) and torch.equal(card, again)

    def test_compressed_engine_has_the_bits_of_the_bf16_engine(self, cuda_device):
        n, d, w, k = 3000, 300, 8, 2
        idx, vals, Y = _coo(n, d, w, k, seed=5)
        data = Dataset({"indices": _t(idx).to(cuda_device), "values": _t(vals).to(cuda_device)},
                       n=n)
        labels = Dataset(_t(Y).to(cuda_device))
        kw = dict(lam=1e-3, num_iterations=15, num_features=d, solver="gram",
                  gram_chunk_rows=512)
        m16 = SparseLBFGSwithL2(gram_dtype="bf16", **kw).fit(data, labels)
        mc = SparseLBFGSwithL2(compress="int16_bf16", **kw).fit(data, labels)
        assert torch.equal(m16.x, mc.x) and torch.equal(m16.b_opt, mc.b_opt)

    def test_segmented_fold_has_the_bits_of_the_single_one(self, cuda_device):
        n, d, w, k, c = 2500, 200, 10, 2, 500
        idx, vals, Y = _coo(n, d, w, k, seed=6)
        tiles = [_t(a).to(cuda_device).reshape(n // c, c, -1) for a in (idx, vals, Y)]

        def chunk(cid, it, vt, yt):
            cid = min(cid, it.shape[0] - 1)  # ids past the end slice safely
            return it[cid], vt[cid], yt[cid]

        kw = dict(lam=1e-3, num_iterations=15, n=n, operands=tuple(tiles))
        before = cuda_ops.launches["gram_corr_sym_acc"]
        W1, loss1 = run_lbfgs_gram_streamed(chunk, n // c, d, k, **kw)
        W2, loss2 = run_lbfgs_gram_streamed(chunk, n // c, d, k, max_chunks_per_dispatch=2, **kw)
        assert cuda_ops.launches["gram_corr_sym_acc"] - before == 5 + 6
        assert torch.equal(W1, W2) and torch.equal(loss1, loss2)
