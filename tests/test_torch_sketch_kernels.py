"""The sketched tier's CountSketch kernel, countsketch_scatter, and the dense
Gramian kernel, gram_corr (keystone_tpu_torch/ops/cuda_ops.py,
csrc/countsketch_scatter.cu, csrc/gram_corr.cu), against their plain
versions, their wrappers' contracts, and the fits around them on the card.

This file imports no JAX, so that it runs on the machine with the card,
which has none: ``python -m pytest tests/test_torch_sketch_kernels.py -m cuda
--noconftest``. The ``cuda`` tests skip without a card; the plain versions
are held against the JAX package's Pallas kernels in
tests/test_torch_sketch.py.

Tolerances (kernel against plain version, same inputs):
  - countsketch_scatter: bit for bit against the plain version run on the
    CPU, which adds lane after lane in (row, slot) order — the kernel adds
    each output entry's contributions in that order too, without
    contraction. The plain version on the card (``index_add_``, atomics in
    no fixed order) is held within 1e-6 of the sums' scale Σ|val| instead.
  - gram_corr: within 1e-5 of the sums' scale (Σ|aᵢ||aⱼ| for the Gramian,
    Σ|a||r| for the correlation: float32 products summed in other orders;
    bf16 operands and their products are exact in float32), exactly
    symmetric, and both outputs bit for bit gram_corr_sym's (both kernels
    sum each entry as one fmaf chain over the rows in order).
  - a sketched fit on the card against the same fit on the CPU: 1e-4
    relative Frobenius (the gradient operand's ``index_add_`` adds in
    atomic order on the card).
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.resident import CompressedCOOChunks
from keystone_tpu_torch.ops import cuda_ops
from keystone_tpu_torch.ops.learning.sketch import IterativeHessianSketch, SketchedLeastSquares
from keystone_tpu_torch.parallel import linalg


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _chunk(c, s, m, d1, seed=0, duplicates=False, device="cpu"):
    """A chunk with masked lanes (−1), out-of-range columns and buckets, and
    optionally duplicate columns within rows."""
    r = np.random.default_rng(seed)
    idx = r.integers(0, d1, size=(c, s)).astype(np.int32)
    if duplicates and s > 1:
        idx[:, 1::2] = idx[:, ::2][:, : idx[:, 1::2].shape[1]]
    val = r.normal(size=(c, s)).astype(np.float32)
    drop = r.random(size=(c, s)) < 0.2
    idx = np.where(drop, -1, idx)
    val = np.where(drop, 0.0, val).astype(np.float32)
    if c and s:
        idx[r.random(size=(c, s)) < 0.02] = d1 + 3  # out of range: adds nothing
    bucket = r.integers(0, m, size=(c,)).astype(np.int32)
    if c:
        bucket[r.random(size=c) < 0.05] = m  # out of range: the row adds nothing
    sign = r.choice([-1.0, 1.0], size=(c,)).astype(np.float32)
    return tuple(_t(a).to(device) for a in (idx, val, bucket, sign))


def _sketch_scale(idx, val, bucket, m, d1):
    """Σ|val| into each output entry: the scale of the sums."""
    ones = val.new_ones((idx.shape[0],))
    return cuda_ops.countsketch_scatter_ref(idx, val.abs(), bucket, ones, m, d1)


# ---------------------------------------------------------------------------
# Contract, on the CPU
# ---------------------------------------------------------------------------


class TestContract:
    def test_counters_and_entry_points(self):
        for name in ("countsketch_scatter", "gram_corr"):
            assert isinstance(cuda_ops.launches[name], int)
            assert name in cuda_ops._ENTRY_POINTS
            cuda_ops.launches[name] += 2
        cuda_ops.reset_launch_counts()
        assert cuda_ops.launches["countsketch_scatter"] == cuda_ops.launches["gram_corr"] == 0

    def test_cpu_wrappers_take_the_plain_versions(self):
        before = dict(cuda_ops.launches)
        idx, val, bucket, sign = _chunk(40, 5, 9, 17)
        assert torch.equal(cuda_ops.countsketch_scatter(idx, val, bucket, sign, 9, 17),
                           cuda_ops.countsketch_scatter_ref(idx, val, bucket, sign, 9, 17))
        A, R = torch.randn(30, 20), torch.randn(30, 3)
        got, want = cuda_ops.gram_corr(A, R), cuda_ops.gram_corr_ref(A, R)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert cuda_ops.launches == before

    def test_plain_version_into_a_column_window(self):
        idx, val, bucket, sign = _chunk(40, 5, 9, 17, seed=1)
        wide = torch.randn(9, 30)
        keep = wide.clone()
        cuda_ops.countsketch_scatter(idx, val, bucket, sign, 9, 17, out=wide[:, 5:22])
        want = cuda_ops.countsketch_scatter_ref(idx, val, bucket, sign, 9, 17,
                                                out=keep[:, 5:22].contiguous())
        assert torch.equal(wide[:, 5:22], want)
        assert torch.equal(wide[:, :5], keep[:, :5]) and torch.equal(wide[:, 22:], keep[:, 22:])

    def test_shapes_are_checked(self):
        idx, val, bucket, sign = _chunk(10, 3, 4, 6)
        with pytest.raises(ValueError):
            cuda_ops.countsketch_scatter(idx, val[:, :2], bucket, sign, 4, 6)
        with pytest.raises(ValueError):
            cuda_ops.countsketch_scatter(idx, val, bucket[:5], sign, 4, 6)
        with pytest.raises(ValueError):
            cuda_ops.countsketch_scatter(idx, val, bucket, sign, 4, 6, out=torch.zeros(4, 7))

    def test_non_cpu_non_cuda_tensors_raise(self):
        def meta(*shape):
            return torch.empty(shape, device="meta")

        with pytest.raises(ValueError, match="CUDA"):
            cuda_ops.gram_corr(meta(6, 4), meta(6, 2))


# ---------------------------------------------------------------------------
# Kernels against plain versions: need the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


# (c, s, m, d1): the reference's small check geometry, ragged everything,
# one bucket, one column, and an empty chunk.
CS_SHAPES = [(2048, 16, 512, 256), (1000, 83, 333, 1025), (50, 4, 13, 37),
             (300, 3, 600, 300), (64, 7, 1, 50), (64, 7, 20, 1), (0, 5, 8, 9), (30, 0, 8, 9)]


@pytest.mark.cuda
class TestCountSketchOnCard:
    @pytest.mark.parametrize("c,s,m,d1", CS_SHAPES)
    @pytest.mark.parametrize("duplicates", [False, True])
    def test_bits_of_the_cpu_plain_version(self, cuda_device, c, s, m, d1, duplicates):
        ops = _chunk(c, s, m, d1, seed=c + s, duplicates=duplicates)
        before = cuda_ops.launches["countsketch_scatter"]
        got = cuda_ops.countsketch_scatter(*(t.to(cuda_device) for t in ops), m, d1)
        torch.cuda.synchronize()
        launched = cuda_ops.launches["countsketch_scatter"] - before
        assert launched == (1 if c and s else 0)
        want = cuda_ops.countsketch_scatter_ref(*ops, m, d1)
        assert got.shape == (m, d1) and got.dtype == torch.float32
        assert torch.equal(got.cpu(), want)

    def test_in_place_keeps_untouched_entries(self, cuda_device):
        m, d1 = 300, 500
        ops = _chunk(700, 9, m, d1, seed=3, duplicates=True)
        out0 = torch.randn((m, d1))
        acc = out0.to(cuda_device)
        out = cuda_ops.countsketch_scatter(*(t.to(cuda_device) for t in ops), m, d1, out=acc)
        torch.cuda.synchronize()
        assert out is acc
        want = cuda_ops.countsketch_scatter_ref(*ops, m, d1, out=out0.clone())
        assert torch.equal(acc.cpu(), want)
        lanes = cuda_ops.countsketch_scatter_ref(ops[0], torch.ones_like(ops[1]), ops[2],
                                                 torch.ones(700), m, d1)
        touched = lanes != 0
        assert torch.equal(acc.cpu()[~touched], out0[~touched])

    def test_repeated_runs_give_equal_bits(self, cuda_device):
        m, d1 = 97, 4099
        ops = [t.to(cuda_device) for t in _chunk(5000, 40, m, d1, seed=4)]
        first = cuda_ops.countsketch_scatter(*ops, m, d1)
        for _ in range(3):
            assert torch.equal(cuda_ops.countsketch_scatter(*ops, m, d1), first)

    def test_against_the_card_plain_version(self, cuda_device):
        m, d1 = 256, 2000
        ops = [t.to(cuda_device) for t in _chunk(8000, 30, m, d1, seed=5, duplicates=True)]
        got = cuda_ops.countsketch_scatter(*ops, m, d1)
        want = cuda_ops.countsketch_scatter_ref(*ops, m, d1)
        scale = _sketch_scale(ops[0], ops[1], ops[2], m, d1)
        assert ((got - want).abs() <= 1e-6 * scale).all()

    def test_fold_composition(self, cuda_device):
        m, d1 = 31, 77
        acc = torch.zeros((m, d1), device=cuda_device)
        want = torch.zeros((m, d1))
        for i in range(4):
            ops = _chunk(200, 6, m, d1, seed=10 + i, duplicates=i % 2 == 1)
            cuda_ops.countsketch_scatter(*(t.to(cuda_device) for t in ops), m, d1, out=acc)
            cuda_ops.countsketch_scatter_ref(*ops, m, d1, out=want)
        assert torch.equal(acc.cpu(), want)

    def test_compressed_operands(self, cuda_device):
        """bf16-decoded values and int16 indices from CompressedCOOChunks,
        cast in the caller as the fold casts them."""
        m, d1 = 64, 300
        idx, val, _, _ = _chunk(512, 12, m, d1, seed=6)
        idx = torch.where((idx >= 0) & (idx < d1), idx, -1)
        labels = torch.zeros((512, 2))
        chunks = CompressedCOOChunks.encode(idx.to(cuda_device), val.to(cuda_device),
                                            labels.to(cuda_device), chunk_rows=256, d=d1)
        it, vt, _ = chunks.operands()
        acc = torch.zeros((m, d1), device=cuda_device)
        want = torch.zeros((m, d1))
        for cid in range(chunks.num_chunks):
            bucket = torch.randint(0, m, (256,), generator=torch.Generator().manual_seed(cid))
            sign = torch.ones(256)
            i32, f32 = it[cid].to(torch.int32), vt[cid].to(torch.float32)
            cuda_ops.countsketch_scatter(i32, f32, bucket.to(cuda_device), sign.to(cuda_device),
                                         m, d1, out=acc)
            cuda_ops.countsketch_scatter_ref(i32.cpu(), f32.cpu(), bucket, sign, m, d1, out=want)
        assert torch.equal(acc.cpu(), want)

    # Shapes past the warp's 32 lanes: buckets of ~170 rows (the warp takes a
    # bucket's rows in order through several 32-row scans), 83 slots all on
    # one column (one group of 32 lanes, then one of 32, then 19), and a run
    # of equal columns across the slot passes 0-31 / 32-63.
    @pytest.mark.parametrize("case", ["big buckets", "one column a row", "runs across passes"])
    @pytest.mark.parametrize("in_place", [False, True])
    def test_bits_past_the_warp_width(self, cuda_device, case, in_place):
        c, s, m, d1 = {"big buckets": (512, 20, 3, 97), "one column a row": (300, 83, 40, 300),
                       "runs across passes": (400, 70, 50, 200)}[case]
        idx, val, bucket, sign = _chunk(c, s, m, d1, seed=len(case))
        if case == "one column a row":
            idx[:] = idx[:, :1].clamp(min=0)
        elif case == "runs across passes":
            idx[:, 25:45] = idx[:, 25:26].clamp(min=0)
        out0 = torch.randn((m, d1)) if in_place else None
        got = cuda_ops.countsketch_scatter(
            idx.to(cuda_device), val.to(cuda_device), bucket.to(cuda_device),
            sign.to(cuda_device), m, d1, out=None if out0 is None else out0.to(cuda_device))
        want = cuda_ops.countsketch_scatter_ref(idx, val, bucket, sign, m, d1,
                                                out=None if out0 is None else out0.clone())
        assert torch.equal(got.cpu(), want)

    @pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
    def test_preparation_groups_the_rows_of_the_stable_order(self, cuda_device, dtype):
        m = 300
        bucket = torch.randint(-2, m + 3, (5000,), generator=torch.Generator().manual_seed(9))
        order, starts = cuda_ops.countsketch_prepare(bucket.to(dtype).to(cuda_device), m)
        want_order, want_starts = cuda_ops.countsketch_order(bucket, m)
        assert torch.equal(starts.cpu(), want_starts)
        live = int(want_starts[m])
        for b in range(m):
            lo, hi = int(want_starts[b]), int(want_starts[b + 1])
            assert torch.equal(order[lo:hi].cpu().sort().values, want_order[lo:hi])
        assert live < 5000

    def test_what_the_kernel_refuses_raises(self, cuda_device):
        idx, val, bucket, sign = (t.to(cuda_device) for t in _chunk(20, 4, 5, 9))
        with pytest.raises(TypeError):
            cuda_ops.countsketch_scatter(idx.long(), val, bucket, sign, 5, 9)
        with pytest.raises(TypeError):
            cuda_ops.countsketch_scatter(idx, val.double(), bucket, sign, 5, 9)
        with pytest.raises(ValueError):
            cuda_ops.countsketch_scatter(idx, val, bucket, sign, 5, 9, out=torch.zeros(
                (5, 9), device=cuda_device).T.contiguous().T)
        with pytest.raises(ValueError):
            cuda_ops.countsketch_scatter(idx, val, bucket.cpu(), sign, 5, 9)


# (n, d, k): aligned, ragged rows and columns, one-column last tile, and
# label widths across a tile.
GC_SHAPES = [(512, 256, 2), (1000, 300, 11), (333, 129, 1), (64, 385, 147), (1, 1, 1),
             (0, 130, 2), (4096, 1025, 2)]


@pytest.mark.cuda
class TestGramCorrOnCard:
    @pytest.mark.parametrize("n,d,k", GC_SHAPES)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_against_plain_version(self, cuda_device, n, d, k, dtype):
        rng = np.random.default_rng(n + d + k)
        A = _t(rng.normal(size=(n, d)).astype(np.float32)).to(cuda_device).to(dtype)
        R = _t(rng.normal(size=(n, k)).astype(np.float32)).to(cuda_device)
        before = cuda_ops.launches["gram_corr"]
        gram, corr = cuda_ops.gram_corr(A, R)
        torch.cuda.synchronize()
        assert cuda_ops.launches["gram_corr"] == before + 1
        want_g, want_c = cuda_ops.gram_corr_ref(A, R)
        Af = A.float()
        g_scale = Af.abs().T @ Af.abs()
        c_scale = Af.abs().T @ R.abs()
        assert gram.shape == (d, d) and corr.shape == (d, k)
        assert ((gram - want_g).abs() <= 1e-5 * g_scale).all()
        assert ((corr - want_c).abs() <= 1e-5 * c_scale).all()
        assert torch.equal(gram, gram.T)

    @pytest.mark.parametrize("n,d,k", GC_SHAPES)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_bits_of_gram_corr_sym(self, cuda_device, n, d, k, dtype):
        # Both kernels sum each output entry as one fmaf chain over the rows
        # in order; gram_corr computes the upper Gramian tiles and mirrors them.
        rng = np.random.default_rng(n + 2 * d + k)
        A = _t(rng.normal(size=(n, d)).astype(np.float32)).to(cuda_device).to(dtype)
        R = _t(rng.normal(size=(n, k)).astype(np.float32)).to(cuda_device)
        gram, corr = cuda_ops.gram_corr(A, R)
        sym_gram, sym_corr = cuda_ops.gram_corr_sym(A, R)
        assert torch.equal(gram, sym_gram) and torch.equal(corr, sym_corr)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_correlation_at_k_147(self, cuda_device, dtype):
        rng = np.random.default_rng(147)
        A = _t(rng.normal(size=(20000, 512)).astype(np.float32)).to(cuda_device).to(dtype)
        R = _t(rng.normal(size=(20000, 147)).astype(np.float32)).to(cuda_device)
        grid = cuda_ops.gram_corr_grid(A, 147)
        assert grid["ktile"] == 160 and grid["corr_blocks"] == 512 // grid["corr_cols"]
        runs = [cuda_ops.gram_corr(A, R)[1] for _ in range(3)]
        assert all(torch.equal(runs[0], c) for c in runs[1:])
        Af = A.float()
        want = cuda_ops.gram_corr_ref(A, R)[1]
        assert ((runs[0] - want).abs() <= 1e-5 * (Af.abs().T @ R.abs())).all()

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_timit_grid(self, cuda_device, dtype):
        # A 65,536 x 4,096, R 65,536 x 147: the correlation in blocks of one
        # 160-wide label tile (8% masked), then the 528 upper tiles.
        A = torch.empty((65536, 4096), dtype=dtype, device=cuda_device)
        grid = cuda_ops.gram_corr_grid(A, 147)
        assert grid["gram_blocks"] == 528 and grid["corr_blocks"] == 4096 // grid["corr_cols"]
        assert grid["blocks"] == 528 + grid["corr_blocks"]
        assert grid["ktile"] == 160 and grid["masked"] <= 0.10
        assert grid["local_bytes"] == 0  # no spills
        assert grid["blocks_per_sm"] < 2 or grid["registers"] <= 128

    def test_column_window_is_read_through_its_row_stride(self, cuda_device):
        A, R = torch.randn(300, 200, device=cuda_device), torch.randn(300, 3, device=cuda_device)
        wide = torch.zeros((300, 260), device=cuda_device)
        wide[:, 30:230] = A
        got = cuda_ops.gram_corr(wide[:, 30:230], R)
        want = cuda_ops.gram_corr(A, R)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    def test_sym_false_block_update_matches_sym_true(self, cuda_device):
        Ab = torch.randn(2000, 256, device=cuda_device)
        R, Wb = torch.randn(2000, 5, device=cuda_device), torch.zeros(256, 5, device=cuda_device)
        before = dict(cuda_ops.launches)
        dense = linalg._bcd_block_update(Ab, R, Wb, 1e-2, sym=False)
        sym = linalg._bcd_block_update(Ab, R, Wb, 1e-2)
        assert cuda_ops.launches["gram_corr"] == before["gram_corr"] + 1
        assert cuda_ops.launches["gram_corr_sym"] == before["gram_corr_sym"] + 1
        for a, b in zip(dense[:2], sym[:2]):
            assert float((a - b).norm() / b.norm()) <= 1e-5

    def test_what_the_kernel_refuses_raises(self, cuda_device):
        A, R = torch.randn(30, 20, device=cuda_device), torch.randn(30, 2, device=cuda_device)
        with pytest.raises(TypeError):
            cuda_ops.gram_corr(A.double(), R)
        with pytest.raises(ValueError):
            cuda_ops.gram_corr(A, R[:10])


# ---------------------------------------------------------------------------
# The sketched fits on the card against the CPU
# ---------------------------------------------------------------------------


def _coo(n, d, nnz, seed=0):
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.integers(0, d, size=(n, nnz)).astype(np.int32), axis=1)
    vals = rng.normal(size=(n, nnz)).astype(np.float32)
    truth = rng.normal(size=d).astype(np.float32)
    score = (vals * truth[idx]).sum(1) + 0.3 * rng.normal(size=n)
    Y = 2.0 * np.eye(2, dtype=np.float32)[(score > 0).astype(int)] - 1.0
    return idx, vals, Y


def _fit(est, idx, vals, Y, device):
    data = Dataset({"indices": _t(idx).to(device), "values": _t(vals).to(device)},
                   n=idx.shape[0])
    model = est.fit(data, Dataset(_t(Y).to(device)))
    return torch.cat([model.x, model.b_opt[None]]).cpu()


@pytest.mark.cuda
class TestSketchedFitsOnCard:
    @pytest.mark.parametrize("compress", [None, "int16_bf16"])
    def test_ihs_launches_once_a_chunk_and_pass_and_matches_the_cpu(self, cuda_device,
                                                                     compress):
        idx, vals, Y = _coo(3000, 200, 10)
        kw = dict(lam=1e-3, sketch_factor=4, outer_iters=3, chunk_rows=512, num_features=200,
                  compress=compress, seed=5)
        cpu = _fit(IterativeHessianSketch(**kw), idx, vals, Y, "cpu")
        est = IterativeHessianSketch(**kw)
        cuda_ops.reset_launch_counts()
        card = _fit(est, idx, vals, Y, cuda_device)
        counts = dict(cuda_ops.launches)
        assert counts.pop("countsketch_scatter") == 6 * est.passes
        assert all(v == 0 for v in counts.values())
        assert float((card - cpu).norm() / cpu.norm()) <= 1e-4

    def test_srht_launches_no_kernel_and_matches_the_cpu(self, cuda_device):
        idx, vals, Y = _coo(3000, 200, 10, seed=1)
        kw = dict(lam=1e-3, sketch_factor=2, pcg_iters=12, chunk_rows=512, num_features=200)
        cpu = _fit(SketchedLeastSquares(**kw), idx, vals, Y, "cpu")
        cuda_ops.reset_launch_counts()
        card = _fit(SketchedLeastSquares(**kw), idx, vals, Y, cuda_device)
        assert all(v == 0 for v in cuda_ops.launches.values())
        assert float((card - cpu).norm() / cpu.norm()) <= 1e-4
