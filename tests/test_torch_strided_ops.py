"""The port's column-window kernels (block_gram_sym, block_corr,
block_residual_update in keystone_tpu_torch/ops/cuda_ops.py) against the
JAX package's Pallas kernels of the same names; and, on the card, those
kernels and the streamed fold's gram_sym_acc against their plain versions
(gram_sym_acc's plain version is held against its Pallas twin in
tests/test_torch_streaming.py).

On the CPU the wrappers compute their plain PyTorch versions; those are held
here against the Pallas kernels run in interpret mode on the same inputs
(made with a seeded numpy generator, float32 on both sides; bf16 F is the
same round-to-nearest-even of those values on both sides). The shapes are
the reference's aligned ones: n = 1024 rows (a multiple of its 512-row
tile), d = 768, a 256-wide window at column 0, 256 or 512. The kernels
themselves run only on a CUDA card: the ``cuda`` tests compare each kernel
with its plain version there and skip elsewhere (this file imports no JAX
at module level, so that they run on the machine with the card:
``python -m pytest tests/test_torch_strided_ops.py -m cuda --noconftest``).

Tolerance: 1e-5 of the sums' scale (max over entries of sum |f||r|, or of
|r| + sum |f||dw| for the residual). Both sides sum float32 products in
float32 — bf16 operands are exact in float32 and their products too — in
different orders; over at most 1024 terms that differs by ~1e-7 of the
scale.
"""

import ctypes
from pathlib import Path

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
        header = tmp_path / "gram_tile.cuh"
        header.write_text(header.read_text() + "\n// edited\n")
        after = {name: cuda_ops._library_path(name) for name in cuda_ops._ENTRY_POINTS}
        assert all(before[name] != after[name] for name in before)

    def test_library_name_hashes_the_pipelined_header(self, tmp_path, monkeypatch):
        # Seven sources include fma_pipe.cuh, the two Gramian ones through
        # gram_tile.cuh: an edit rebuilds them.
        users = ("block_corr", "gram_corr", "block_residual_update", "gaussian_kernel_block",
                 "gaussian_resid_block", "cosine_features", "gram_corr_sym_acc")
        for name in users:
            assert _includes_pipelined_tile((cuda_ops._CSRC / f"{name}.cu").read_text())
        for src in (cuda_ops._CSRC).iterdir():
            (tmp_path / src.name).write_bytes(src.read_bytes())
        monkeypatch.setattr(cuda_ops, "_CSRC", tmp_path)
        before = {name: cuda_ops._library_path(name) for name in users}
        header = tmp_path / "fma_pipe.cuh"
        header.write_text(header.read_text() + "\n// edited\n")
        assert all(cuda_ops._library_path(name) != path for name, path in before.items())

    def test_gaussian_epilogue_is_defined_once(self):
        # Both Gaussian kernels take the distance, clamp and exp from
        # gaussian.cuh; neither keeps a copy of its own.
        where = [p.name for p in sorted(cuda_ops._CSRC.iterdir())
                 if "float gauss(" in p.read_text()]
        assert where == ["gaussian.cuh"]
        for name in ("gaussian_kernel_block", "gaussian_resid_block"):
            assert '#include "gaussian.cuh"' in (cuda_ops._CSRC / f"{name}.cu").read_text()

    def test_fma_tile_users(self):
        # The first slice's FP32-FMA tile and its last users' sources are
        # gone: every GEMM source is on the pipelined tile, and the Gramian
        # tile loop (mainloop over A's columns against themselves) is
        # written once, in gram_tile.cuh.
        for name in ("fma_tile.cuh", "gram_corr_sym.cu", "block_gram_sym.cu",
                     "gram_sym_acc.cu"):
            assert not (cuda_ops._CSRC / name).exists()
        sources = sorted(cuda_ops._CSRC.glob("*.cu*"))
        assert not [p.name for p in sources if "fma_tile" in p.read_text()]
        own_tiles = ("countsketch_scatter.cu",)
        for p in sources:
            if p.suffix == ".cu" and p.name not in own_tiles:
                assert _includes_pipelined_tile(p.read_text()), p.name
        gram_loops = [p.name for p in sources
                      if "(smem, A, lda, i0, d, A, lda, j0, d," in p.read_text()]
        assert gram_loops == ["gram_tile.cuh"]

    def test_tensor_core_gramian_is_written_once(self):
        # The TMA + wgmma mainloop lives in gram_wgmma.cuh alone, and both
        # Gramian sources include it; the FMA Gramian-alone kernel has no
        # bf16 instance (bf16 block_gram_sym and gram_sym_acc run on the
        # tensor cores).
        where = [p.name for p in sorted(cuda_ops._CSRC.iterdir())
                 if "wgmma.mma_async" in p.read_text()]
        assert where == ["gram_wgmma.cuh"]
        for name in ("gram_corr.cu", "gram_corr_sym_acc.cu"):
            assert '#include "gram_wgmma.cuh"' in (cuda_ops._CSRC / name).read_text()
        text = (cuda_ops._CSRC / "gram_corr.cu").read_text()
        assert "launch_gram<__nv_bfloat16" not in text and "gram_plan<__nv_bfloat16" not in text
        assert "gram_kernel(const float* __restrict__ A" in (
            cuda_ops._CSRC / "gram_tile.cuh").read_text()

    def test_shared_source_builds_one_library(self):
        # gram_corr_sym, block_gram_sym and gram_sym_acc launch the kernels of
        # gram_corr.cu: one library, with every wrapper's entry points bound.
        path = cuda_ops._library_path("gram_corr")
        assert cuda_ops._library_path("gram_corr_sym") == path
        assert cuda_ops._library_path("block_gram_sym") == path
        assert cuda_ops._library_path("gram_sym_acc") == path
        assert set(cuda_ops._symbols("gram_corr")) == {
            "kt_gram_corr", "kt_gram_corr_config", "kt_block_gram_sym",
            "kt_block_gram_sym_config", "kt_gram_sym_acc", "kt_gram_sym_acc_config"}
        # gram_corr_sym_acc keeps its source (its bf16 kernel) and gains the
        # float32 form's grid.
        assert cuda_ops._source("gram_corr_sym_acc") == "gram_corr_sym_acc"
        assert set(cuda_ops._symbols("gram_corr_sym_acc")) == {
            "kt_gram_corr_sym_acc", "kt_gram_corr_sym_acc_config"}

    @pytest.mark.parametrize("symbol", sorted(
        {sym for name in cuda_ops._ENTRY_POINTS
         for sym in cuda_ops._symbols(cuda_ops._source(name))}))
    def test_argtypes_match_the_c_declaration(self, symbol):
        # ctypes passes each argument as its argtype says: a pointer as a
        # 64-bit address, long long as 64 bits, int and float as 32. A
        # mismatch with the C declaration cuts pointers or shifts arguments.
        source = next(cuda_ops._source(name) for name in cuda_ops._ENTRY_POINTS
                      if symbol in cuda_ops._symbols(cuda_ops._source(name)))
        argtypes = cuda_ops._symbols(source)[symbol]
        text = (cuda_ops._CSRC / f"{source}.cu").read_text()
        params = text.split(f'extern "C" int {symbol}(', 1)[1].split(")", 1)[0]
        kinds = {"*": ctypes.c_void_p, "long long": ctypes.c_longlong, "int": ctypes.c_int,
                 "float": ctypes.c_float}
        declared = [next(t for key, t in kinds.items() if key in param)
                    for param in " ".join(params.split()).split(",")]
        assert declared == argtypes

    @pytest.mark.parametrize("name", sorted(cuda_ops.launches))
    def test_every_wrapper_has_an_entry_point_its_library_binds(self, name):
        source = cuda_ops._CSRC / f"{cuda_ops._source(name)}.cu"
        symbols = cuda_ops._symbols(cuda_ops._source(name))
        assert cuda_ops._ENTRY_POINTS[name][0] in symbols
        text = source.read_text()
        for symbol in symbols:
            assert f'extern "C" int {symbol}(' in text

    def test_build_compiles_a_shared_source_once(self, tmp_path, monkeypatch):
        # One nvcc a source, however many wrappers it serves.
        commands = []

        class FakeNvcc:
            returncode = 0

            def __init__(self, cmd, **kwargs):
                commands.append(cmd)
                self.out = Path(cmd[cmd.index("-o") + 1])

            def communicate(self):
                self.out.write_bytes(b"")
                return "ptxas info", None

        monkeypatch.setattr(cuda_ops, "_BUILD", tmp_path)
        monkeypatch.setattr(cuda_ops, "_nvcc", lambda: "nvcc")
        monkeypatch.setattr(cuda_ops.subprocess, "Popen", FakeNvcc)
        reports = cuda_ops.build(["gram_corr_sym", "block_gram_sym", "gram_corr", "block_corr"])
        assert sorted(reports) == ["block_corr", "gram_corr"]
        assert sorted(Path(cmd[-1]).name for cmd in commands) == ["block_corr.cu", "gram_corr.cu"]
        assert cuda_ops._library_path("block_gram_sym").exists()
        assert cuda_ops.build(["gram_corr_sym"]) == {"gram_corr": "(already built)"}
        assert len(commands) == 2

    @pytest.mark.parametrize("constant", ["KT_NARROW", "KT_WIDE"])
    def test_label_tiles_are_defined_once(self, constant):
        # block_corr, the Gramian kernels (gram_tile.cuh) and
        # block_residual_update share the header's label tiles and the
        # function that picks one (with_label_tile).
        where = [p.name for p in sorted(cuda_ops._CSRC.iterdir())
                 if f"constexpr int {constant} =" in p.read_text()]
        assert where == ["fma_pipe.cuh"]
        for name in ("block_corr.cu", "gram_tile.cuh", "block_residual_update.cu"):
            assert "with_label_tile(k," in (cuda_ops._CSRC / name).read_text()


class TestTmaLayout:
    """The bf16 layout the tensor-core Gramian's TMA loads read in place
    (``cuda_ops._tma_layout_ok``), the staging copy of any other, and the
    layouts the bf16 routes hand to ``gram_sym_acc`` and
    ``block_gram_sym``: all on the CPU, where the wrappers take their plain
    versions, so the routes' calls are recorded."""

    @pytest.mark.parametrize("ptr,row_stride,col_start,ok", [
        (0, 8, 0, True), (1024, 16384, 8192, True), (16, 264, 8, True), (48, 16448, 0, True),
        (8, 8, 0, False), (2, 16384, 0, False), (0, 300, 0, False), (0, 16385, 0, False),
        (0, 16448, 3, False), (0, 16448, 4, False),
    ])
    def test_answers(self, ptr, row_stride, col_start, ok):
        # A 16-byte-aligned base, a row stride of whole 16 bytes (8 bf16),
        # and a window start on a 16-byte boundary.
        assert cuda_ops._tma_layout_ok(ptr, row_stride, col_start) == ok

    def test_gram_corr_acc_ok_states_the_same_layout(self):
        wide = torch.zeros((4, 40), dtype=torch.bfloat16)
        for F in (wide, wide[:, 8:20], wide[:, 3:20], wide[:, :36].contiguous()):
            assert cuda_ops.gram_corr_acc_ok(F) == cuda_ops._tma_layout_ok(F.data_ptr(),
                                                                           F.stride(0))

    def test_staging_copies_a_misaligned_window_and_counts_it(self):
        F = torch.arange(10 * 40, dtype=torch.float32).reshape(10, 40).to(torch.bfloat16)
        cuda_ops.reset_launch_counts()
        rows, col = cuda_ops._tma_rows("block_gram_sym", F, 3, 20)
        assert col == 0 and rows.stride(0) == 24 and torch.equal(rows, F[:, 3:23])
        assert cuda_ops._tma_layout_ok(rows.data_ptr(), rows.stride(0))
        assert cuda_ops.staged == {"gram_sym_acc": 0, "block_gram_sym": 1}
        same, col = cuda_ops._tma_rows("gram_sym_acc", F, 8, 16)
        assert same is F and col == 8 and cuda_ops.staged["gram_sym_acc"] == 0
        rows, _ = cuda_ops._tma_rows("gram_sym_acc", F[:, 1:], 0, 39)
        assert rows.stride(0) == 40 and torch.equal(rows, F[:, 1:])
        assert cuda_ops.staged["gram_sym_acc"] == 1
        cuda_ops.reset_launch_counts()
        assert cuda_ops.staged == {"gram_sym_acc": 0, "block_gram_sym": 0}

    @pytest.mark.parametrize("d", [8, 24, 20, 13])
    def test_bf16_cosine_bank_tiles_are_tma_ready(self, d):
        # A bf16 bank writes rows of a whole 16 bytes whatever its width (d
        # = 20, 13 padded to 24, 16), with the values of an unpadded tile.
        from keystone_tpu_torch.ops.learning.streaming_ls import CosineBankFeaturize

        rng = np.random.default_rng(d)
        X = torch.from_numpy(rng.normal(size=(30, 7)).astype(np.float32))
        W = torch.from_numpy(rng.normal(size=(d, 7)).astype(np.float32))
        b = torch.from_numpy(rng.uniform(0, 6, size=d).astype(np.float32))
        tile = CosineBankFeaturize(W, b, torch.bfloat16)(X)
        assert tile.shape == (30, d) and tile.stride(0) == -(-d // 8) * 8
        assert cuda_ops._tma_layout_ok(tile.data_ptr(), tile.stride(0))
        want = cuda_ops.cosine_features_ref(X, W, b, torch.bfloat16, torch.bfloat16)
        assert torch.equal(tile, want)
        f32 = CosineBankFeaturize(W, b)(X)
        assert f32.is_contiguous() and torch.equal(f32, cuda_ops.cosine_features_ref(X, W, b))

    @pytest.mark.parametrize("d", [24, 20])
    def test_streamed_fold_reads_bf16_tiles_in_place(self, monkeypatch, d):
        # The streamed fit with a bf16 bank: every tile gram_sym_acc folds is
        # TMA-ready (so the card stages nothing), the ragged last one too.
        from keystone_tpu_torch.ops.learning.streaming_ls import CosineBankFeaturize
        from keystone_tpu_torch.parallel import streaming

        rng = np.random.default_rng(1)
        X = torch.from_numpy(rng.normal(size=(1300, 7)).astype(np.float32))
        Y = torch.from_numpy(rng.normal(size=(1300, 3)).astype(np.float32))
        bank = CosineBankFeaturize(torch.from_numpy(rng.normal(size=(d, 7)).astype(np.float32)),
                                   torch.from_numpy(rng.uniform(0, 6, d).astype(np.float32)),
                                   torch.bfloat16)
        layouts, real = [], cuda_ops.gram_sym_acc

        def recording(G, F, out=None):
            layouts.append((F.dtype, cuda_ops._tma_layout_ok(F.data_ptr(), F.stride(0))))
            return real(G, F, out=out)

        monkeypatch.setattr(cuda_ops, "gram_sym_acc", recording)
        streaming.gram_stats(X, Y, bank, d, 512, valid=1250)
        assert layouts == [(torch.bfloat16, True)] * 3

    def test_flat_fit_windows_are_tma_ready(self, monkeypatch):
        # The fused flat fit of a bf16 slab (centred in place, windows of 16
        # columns): every block_gram_sym window is read in place on the card.
        from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator

        rng = np.random.default_rng(2)
        F = torch.from_numpy(rng.normal(size=(300, 48)).astype(np.float32)).to(torch.bfloat16)
        Y = torch.from_numpy(rng.normal(size=(300, 3)).astype(np.float32))
        windows, real = [], cuda_ops.block_gram_sym

        def recording(F, col_start, block):
            windows.append(cuda_ops._tma_layout_ok(F.data_ptr(), F.stride(0), col_start))
            return real(F, col_start, block)

        monkeypatch.setattr(cuda_ops, "block_gram_sym", recording)
        BlockLeastSquaresEstimator(16, 2).device_fit_fn().fit(F, Y, 290)
        assert windows == [True, True, True]


def _includes_pipelined_tile(text):
    """Whether a source includes fma_pipe.cuh, itself or through the
    Gramian header gram_tile.cuh (which includes it)."""
    return '#include "fma_pipe.cuh"' in text or '#include "gram_tile.cuh"' in text


def _fill(blocks, resident):
    """The share of its waves' slots a grid of ``blocks`` fills: blocks over
    whole waves x resident blocks."""
    return blocks / (-(-blocks // resident) * resident)


class TestCorrSplits:
    """The row-chunk arithmetic of block_corr (``cuda_ops.corr_splits``), a
    pure function of the shapes and the card."""

    @pytest.mark.parametrize("blocks_per_sm,want", [(1, 4), (2, 8)])
    def test_timit_window_fills_whole_waves_of_132_sms(self, blocks_per_sm, want):
        # 4096 window columns x one 160-wide label tile: 32 tiles.
        splits = cuda_ops.corr_splits(65536, 32, 132, blocks_per_sm)
        assert splits == want
        assert _fill(32 * splits, 132 * blocks_per_sm) >= 0.95
        assert -(-65536 // splits) >= 1024

    @pytest.mark.parametrize("blocks_per_sm", [1, 2])
    @pytest.mark.parametrize("tiles", [1, 7, 32, 33, 264, 300])
    @pytest.mark.parametrize("n", [1000, 2047, 5000, 65536, 500000])
    def test_whole_waves_or_the_most_fill_with_1024_rows_a_chunk(self, n, tiles,
                                                                 blocks_per_sm):
        resident = 132 * blocks_per_sm
        splits = cuda_ops.corr_splits(n, tiles, 132, blocks_per_sm)
        most = max(n // 1024, 1)
        assert 1 <= splits <= most
        assert splits == 1 or n // splits >= 1024
        fills = [_fill(tiles * s, resident) for s in range(1, most + 1)]
        if max(fills) >= 0.95:  # the fewest chunks that come within 5% of whole waves
            assert _fill(tiles * splits, resident) >= 0.95
            assert all(f < 0.95 for f in fills[:splits - 1])
        else:  # else the count that fills most
            assert _fill(tiles * splits, resident) == max(fills)

    def test_same_answer_on_every_call(self):
        first = [cuda_ops.corr_splits(n, 32, 132, 2) for n in (4096, 65536, 70000)]
        assert all([cuda_ops.corr_splits(n, 32, 132, 2) for n in (4096, 65536, 70000)] == first
                   for _ in range(3))

    def test_no_tiles_or_few_rows_take_one_chunk(self):
        assert cuda_ops.corr_splits(65536, 0, 132, 2) == 1
        assert cuda_ops.corr_splits(2047, 32, 132, 2) == 1
        assert cuda_ops.corr_splits(0, 32, 132, 2) == 1


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


def _mirrored(G):
    """G's upper triangle mirrored: the whole symmetric Gramian."""
    return torch.triu(G) + torch.triu(G, 1).T


# block_gram_sym with float32 F on gram_corr.cu's Gramian tiles: the window
# read in place through F's row stride gives the bits of gram_corr_sym on a
# copy of it (each entry one fmaf chain over the rows in order, whichever
# path copies the window); 16-byte copies where the window's base, F's row
# stride and the window's width are whole 16-byte chunks. With bf16 F on
# the tensor cores (gram_wgmma.cuh): the bits of gram_sym_acc on G = 0 and
# a copy of the window, mirrored; a window whose start is not on a 16-byte
# boundary is first copied into TMA-ready rows, and counted.
@pytest.mark.cuda
class TestBlockGramSymOnCard:
    @pytest.mark.parametrize("s", [0, 3, 201, 256])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_window_in_place_gives_the_bits_of_a_copy(self, cuda_device, s, dtype):
        n, d, b = 3000, 704, 264
        F, R, _ = _card_inputs(n, d, 3, cuda_device, seed=s)
        F = F.to(dtype)
        before = dict(cuda_ops.launches)
        staged = cuda_ops.staged["block_gram_sym"]
        gram = cuda_ops.block_gram_sym(F, s, b)
        torch.cuda.synchronize()
        assert cuda_ops.launches["block_gram_sym"] == before["block_gram_sym"] + 1
        assert cuda_ops.launches["gram_corr_sym"] == before["gram_corr_sym"]
        assert cuda_ops.launches["gram_corr"] == before["gram_corr"]
        window = F[:, s:s + b].contiguous()
        grid = cuda_ops.block_gram_sym_grid(F, s, b)
        assert grid["blocks"] == 3 * 4 // 2  # 3 tiles of 128 across 264 columns
        if dtype == torch.float32:
            copy, _ = cuda_ops.gram_corr_sym(window, R)
            assert grid["vec"] == (s % 4 == 0 and d % 4 == 0 and b % 4 == 0)
            assert not grid["tensor_cores"] and not grid["staged"]
        else:
            # d = 704 makes whole 16-byte rows: the window is staged where
            # its start is not on a 16-byte boundary.
            assert cuda_ops.staged["block_gram_sym"] == staged + (s % 8 != 0)
            assert grid["tensor_cores"] and grid["staged"] == (s % 8 != 0)
            copy = _mirrored(cuda_ops.gram_sym_acc(
                torch.zeros((b, b), device=cuda_device), window))
            assert torch.equal(gram, cuda_ops.block_gram_sym(window, 0, b))
        assert torch.equal(gram, copy)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_timit_grid(self, cuda_device, dtype):
        # F 65,536 x 16,384, the window [8192, 12288): the 528 upper tiles,
        # no spills. float32 F: 16-byte copies, at most 128 registers at 2
        # blocks an SM. bf16 F: the tensor cores, the window read in place,
        # one block an SM: 4 waves of 132.
        F = torch.empty((65536, 16384), dtype=dtype, device=cuda_device)
        grid = cuda_ops.block_gram_sym_grid(F, 8192, 4096)
        assert grid["blocks"] == 528
        assert grid["local_bytes"] == 0
        if dtype == torch.float32:
            assert grid["vec"] and not grid["tensor_cores"]
            assert grid["blocks_per_sm"] >= 2 and grid["registers"] <= 128
        else:
            assert grid["tensor_cores"] and not grid["staged"]
            assert grid["blocks_per_sm"] == 1 and grid["waves"] == 528 / grid["sms"]


# block_corr's pipelined kernel: label tiles sized to k (32 for k <= 32, else
# 160 a tile), row chunks that fill whole waves, aligned and unaligned windows.
KTILES = (32, 160)
BC_KS = sorted({1, 147} | {w + e for w in KTILES for e in (-1, 0, 1)})


def _corr_check(F, s, b, R, runs=3):
    """block_corr against its plain version within 1e-4 of |Fw|ᵀ|R| (R
    rounded to bf16 for bf16 F), one launch a call, and the same bits on
    every run."""
    before = cuda_ops.launches["block_corr"]
    got = [cuda_ops.block_corr(F, s, b, R) for _ in range(runs)]
    torch.cuda.synchronize()
    assert cuda_ops.launches["block_corr"] == before + runs
    assert all(torch.equal(got[0], g) for g in got[1:])
    want = cuda_ops.block_corr_ref(F, s, b, R)
    Rs = cuda_ops._corr_operand(F, R)
    scale = F[:, s:s + b].float().abs().T @ Rs.abs()
    assert got[0].shape == (b, R.shape[1])
    assert ((got[0] - want).abs() <= 1e-4 * scale.max()).all()


@pytest.mark.cuda
class TestBlockCorrOnCard:
    @pytest.mark.parametrize("k", BC_KS)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_label_widths_around_each_tile(self, cuda_device, k, dtype):
        F, R, _ = _card_inputs(3000, 512, k, cuda_device, seed=k)
        grid = cuda_ops.block_corr_grid(3000, 256, k, dtype == torch.bfloat16, cuda_device)
        assert grid["ktile"] == (32 if k <= 32 else 160)
        assert grid["tiles"] == 2 * -(-k // grid["ktile"])
        _corr_check(F.to(dtype), 128, 256, R)

    # Rows below one chunk's 1,024, at one, and across several; windows at an
    # unaligned start (3, 201) and an aligned one.
    @pytest.mark.parametrize("n", [1000, 1024, 70000])
    @pytest.mark.parametrize("s", [3, 201, 256])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_rows_and_window_starts(self, cuda_device, n, s, dtype):
        F, R, _ = _card_inputs(n, 640, 147, cuda_device, seed=n + s)
        grid = cuda_ops.block_corr_grid(n, 256, 147, dtype == torch.bfloat16, cuda_device)
        assert (grid["splits"] > 1) == (n >= 2048)
        _corr_check(F.to(dtype), s, 256, R)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_non_contiguous_r_row_stride(self, cuda_device, dtype):
        F, _, _ = _card_inputs(5000, 384, 1, cuda_device, seed=7)
        wide = torch.randn((5000, 153), device=cuda_device)
        R = wide[:, 3:150]  # row stride 153 floats, base 12 bytes in
        assert R.stride(0) == 153 and not R.is_contiguous()
        _corr_check(F.to(dtype), 128, 256, R)

    @pytest.mark.parametrize("bf16", [False, True])
    def test_timit_grid(self, cuda_device, bf16):
        # F 65,536 x 16,384, a 4096-wide window, k = 147: one 160-wide label
        # tile (8% masked), and chunks that fill whole waves.
        grid = cuda_ops.block_corr_grid(65536, 4096, 147, bf16, cuda_device)
        assert grid["ktile"] == 160 and grid["tiles"] == 32 and grid["masked"] <= 0.10
        bps = grid["blocks_per_sm"]
        assert grid["splits"] == cuda_ops.corr_splits(65536, 32, grid["sms"], bps)
        assert _fill(grid["blocks"], grid["sms"] * bps) >= 0.95
        assert grid["local_bytes"] == 0  # no spills
        if bps >= 2:
            assert grid["registers"] <= 128


# block_residual_update's pipelined kernel: the window a K-major operand,
# label tiles sized to k (32 for k <= 32, else 160 a tile), the window's
# columns never split, aligned and unaligned windows.
BRU_KS = [1, 31, 32, 33, 147, 160, 161, 300]


def _resid_check(F, s, b, dW, R, runs=3):
    """block_residual_update against its plain version within 1e-4 of
    |R| + |Fw||dW| (dW rounded to F's dtype), one launch a call, and the
    same bits on every run."""
    before = cuda_ops.launches["block_residual_update"]
    got = [cuda_ops.block_residual_update(F, s, b, dW, R) for _ in range(runs)]
    torch.cuda.synchronize()
    assert cuda_ops.launches["block_residual_update"] == before + runs
    assert all(torch.equal(got[0], g) for g in got[1:])
    want = cuda_ops.block_residual_update_ref(F, s, b, dW, R)
    scale = R.abs() + F[:, s:s + b].float().abs() @ dW.to(F.dtype).float().abs()
    assert got[0].shape == R.shape and got[0].dtype == torch.float32
    assert ((got[0] - want).abs() <= 1e-4 * scale.max()).all()


@pytest.mark.cuda
class TestBlockResidualUpdateOnCard:
    @pytest.mark.parametrize("k", BRU_KS)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_label_widths_around_each_tile(self, cuda_device, k, dtype):
        F, R, dW = _card_inputs(3000, 512, k, cuda_device, seed=k)
        grid = cuda_ops.block_residual_update_grid(3000, k, dtype == torch.bfloat16,
                                                   cuda_device)
        assert grid["ktile"] == (32 if k <= 32 else 160)
        assert grid["label_tiles"] == -(-k // grid["ktile"])
        assert grid["blocks"] == -(-3000 // 128) * grid["label_tiles"]
        _resid_check(F.to(dtype), 128, 256, dW[:256], R)

    # One row, a ragged row tile, and many; windows at an unaligned start
    # (3, 201: element by element) and an aligned one (256: 16-byte chunks).
    @pytest.mark.parametrize("n", [1, 129, 70000])
    @pytest.mark.parametrize("s", [3, 201, 256])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_rows_and_window_starts(self, cuda_device, n, s, dtype):
        F, R, dW = _card_inputs(n, 640, 147, cuda_device, seed=n + s)
        _resid_check(F.to(dtype), s, 256, dW[:256], R)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_r_row_stride_wider_than_k(self, cuda_device, dtype):
        F, _, dW = _card_inputs(5000, 384, 147, cuda_device, seed=8)
        wide = torch.randn((5000, 153), device=cuda_device)
        R = wide[:, 3:150]  # row stride 153 floats, base 12 bytes in
        assert R.stride(0) == 153 and not R.is_contiguous()
        _resid_check(F.to(dtype), 128, 256, dW[:256], R)

    @pytest.mark.parametrize("bf16", [False, True])
    def test_timit_grid(self, cuda_device, bf16):
        # F 65,536 x 16,384, a 4096-wide window, k = 147: 512 row tiles x one
        # 160-wide label tile (8% masked), 1.94 waves at 2 blocks an SM.
        grid = cuda_ops.block_residual_update_grid(65536, 147, bf16, cuda_device)
        assert grid["ktile"] == 160 and grid["label_tiles"] == 1 and grid["masked"] <= 0.10
        assert grid["blocks"] == 512
        assert grid["local_bytes"] == 0  # no spills
        if grid["blocks_per_sm"] >= 2:
            assert grid["registers"] <= 128


# The streamed fold's accumulating Gramian (gram_sym_acc).


def _upper_tiles(d):
    idx = torch.arange(d) // 128
    return idx[:, None] <= idx[None, :]


@pytest.mark.cuda
class TestGramSymAccOnCard:
    # (n, d): ragged rows and width, aligned, one row, one-column last tiles.
    @pytest.mark.parametrize("n,d", [(1000, 300), (4096, 512), (1, 130), (777, 129),
                                     (300, 257)])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("in_place", [False, True])
    def test_against_plain_version(self, cuda_device, n, d, dtype, in_place):
        rng = np.random.default_rng(0)
        F = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda_device).to(dtype)
        G0 = torch.from_numpy(rng.normal(size=(d, d)).astype(np.float32)).to(cuda_device)
        want = cuda_ops.gram_sym_acc_ref(G0, F)
        before = cuda_ops.launches["gram_sym_acc"]
        G = G0.clone()
        got = cuda_ops.gram_sym_acc(G, F, out=G if in_place else None)
        torch.cuda.synchronize()
        assert cuda_ops.launches["gram_sym_acc"] == before + 1
        assert (got is G) == in_place
        Ff = F.float()
        scale = G0.abs() + Ff.abs().T @ Ff.abs()
        upper = _upper_tiles(d).to(cuda_device)
        assert float(((got - want).abs() / scale)[upper].max()) <= 1e-5
        if in_place:  # the lower tiles keep G's values
            assert torch.equal(got[~upper], G0[~upper])

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("d", [129, 257, 300])
    def test_row_strides_and_in_place_give_the_same_bits(self, cuda_device, dtype, d):
        # F at a row stride of d, of d rounded up to 16 bytes (the 16-byte
        # copies, the last chunk in part), wider, and at a base one element
        # off (element-wise): the same bits in every layout; in place those
        # of a new buffer, the strictly-lower tiles untouched.
        rng = np.random.default_rng(3)
        n = 555
        F = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda_device)
        G0 = torch.from_numpy(rng.normal(size=(d, d)).astype(np.float32)).to(cuda_device)
        upper = _upper_tiles(d).to(cuda_device)
        chunk = 4 if dtype == torch.float32 else 8
        first = None
        for ld, off in ((d, 0), (-(-d // chunk) * chunk, 0), (d + 9, 0), (d + 8, 1)):
            wide = torch.full((n, ld + off), float("nan"), device=cuda_device, dtype=dtype)
            Fk = wide[:, off:off + d]
            Fk.copy_(F)
            staged = cuda_ops.staged["gram_sym_acc"]
            fresh = cuda_ops.gram_sym_acc(G0, Fk)
            G = G0.clone()
            cuda_ops.gram_sym_acc(G, Fk, out=G)
            torch.cuda.synchronize()
            assert torch.equal(G[upper], fresh[upper]) and torch.equal(G[~upper], G0[~upper])
            first = fresh if first is None else first
            assert torch.equal(fresh[upper], first[upper])
            # bf16 F is read by TMA: a layout whose base or row stride is not
            # whole 16-byte chunks is copied into TMA-ready rows, each call.
            misaligned = dtype == torch.bfloat16 and (ld % 8 != 0 or off != 0)
            assert cuda_ops.staged["gram_sym_acc"] == staged + 2 * misaligned

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_has_the_bits_of_gram_corr_sym(self, cuda_device, dtype):
        # float32 F: the same Gramian tiles as gram_corr_sym's: G0 + FᵀF is
        # G0 plus its Gramian, bit for bit (one fmaf chain an entry, then one
        # add). bf16 F runs on the tensor cores, gram_corr_sym_acc's bf16
        # kernel with no labels (bf16 gram_corr_sym stays on the FMA tile):
        # the Gramian of gram_corr_sym_acc, bit for bit, its labels and
        # correlation whatever they are.
        rng = np.random.default_rng(4)
        F = torch.from_numpy(rng.normal(size=(1200, 259)).astype(np.float32)).to(cuda_device)
        F = F.to(dtype)
        G0 = torch.from_numpy(rng.normal(size=(259, 259)).astype(np.float32)).to(cuda_device)
        upper = _upper_tiles(259).to(cuda_device)
        if dtype == torch.float32:
            R = torch.zeros((1200, 1), device=cuda_device)
            want = G0 + cuda_ops.gram_corr_sym(F, R)[0]
        else:
            R = torch.from_numpy(rng.normal(size=(1200, 9)).astype(np.float32)).to(cuda_device)
            C0 = torch.zeros((259, 9), device=cuda_device)
            # gram_corr_sym_acc reads bf16 F in place only: rows of 264.
            Fa = torch.empty((1200, 264), dtype=dtype, device=cuda_device)[:, :259].copy_(F)
            want = cuda_ops.gram_corr_sym_acc(G0, C0, Fa, R)[0]
        assert torch.equal(cuda_ops.gram_sym_acc(G0, F)[upper], want[upper])

    @pytest.mark.parametrize("bf16", [False, True])
    def test_streamed_tile_grid(self, cuda_device, bf16):
        # d = 16,384: 128 · 129 / 2 = 8,256 upper tiles, no spills. float32
        # F: 16-byte copies, 2 blocks an SM at <= 128 registers; a base one
        # element off copies element by element. bf16 F: the tensor cores,
        # read in place, one block an SM (62.5 waves of 132); a base one
        # element off is staged.
        F = torch.empty((2, 16384), device=cuda_device)
        F = F.to(torch.bfloat16) if bf16 else F
        grid = cuda_ops.gram_sym_acc_grid(F)
        assert grid["blocks"] == 8256
        assert grid["local_bytes"] == 0
        if bf16:
            assert grid["tensor_cores"] and not grid["staged"] and grid["blocks_per_sm"] == 1
            assert cuda_ops.gram_sym_acc_grid(F[:, 1:])["staged"]
        else:
            assert grid["vec"] and not grid["tensor_cores"]
            assert grid["blocks_per_sm"] >= 2 and grid["registers"] <= 128
            assert not cuda_ops.gram_sym_acc_grid(F[:, 1:])["vec"]

    def test_same_bits_every_run(self, cuda_device):
        rng = np.random.default_rng(1)
        F = torch.from_numpy(rng.normal(size=(5000, 384)).astype(np.float32)).to(cuda_device)
        G0 = torch.zeros((384, 384), device=cuda_device)
        first = cuda_ops.gram_sym_acc(G0, F)
        upper = _upper_tiles(384).to(cuda_device)
        assert all(torch.equal(first[upper], cuda_ops.gram_sym_acc(G0, F)[upper])
                   for _ in range(3))

    def test_bf16_same_bits_every_run(self, cuda_device):
        # The tensor-core Gramian in both epilogues: fixed order, so every
        # run gives the same bits, and block_gram_sym's are gram_sym_acc's on
        # G = 0, mirrored.
        rng = np.random.default_rng(5)
        F = torch.from_numpy(rng.normal(size=(5000, 384)).astype(np.float32)).to(cuda_device)
        F = F.to(torch.bfloat16)
        G0 = torch.zeros((384, 384), device=cuda_device)
        first = cuda_ops.gram_sym_acc(G0, F)
        gram = cuda_ops.block_gram_sym(F, 0, 384)
        upper = _upper_tiles(384).to(cuda_device)
        for _ in range(3):
            assert torch.equal(first[upper], cuda_ops.gram_sym_acc(G0, F)[upper])
            assert torch.equal(gram, cuda_ops.block_gram_sym(F, 0, 384))
        assert torch.equal(gram, _mirrored(first))

    def test_bad_operands_raise(self, cuda_device):
        F = torch.zeros((8, 16), device=cuda_device)
        with pytest.raises(ValueError):
            cuda_ops.gram_sym_acc(torch.zeros((8, 8), device=cuda_device), F)
        with pytest.raises(TypeError):
            cuda_ops.gram_sym_acc(torch.zeros((16, 16), device=cuda_device), F.double())

    def test_streamed_fold_launches_for_every_tile(self, cuda_device):
        # On the card the fold takes the kernel for every tile: a tile with
        # strided columns is copied to contiguous rows, and a float64 tile
        # raises instead of taking the plain version.
        from keystone_tpu_torch.parallel import streaming

        rng = np.random.default_rng(2)
        X = torch.from_numpy(rng.normal(size=(1300, 16)).astype(np.float32))
        Y = torch.from_numpy(rng.normal(size=(1300, 5)).astype(np.float32))
        W = torch.from_numpy(rng.normal(size=(300, 16)).astype(np.float32))

        def column_major(X_t):
            return torch.cos(X_t @ W.to(X_t.device).T).T.contiguous().T

        want = streaming.gram_stats(X, Y, column_major, 300, 512, valid=1200)
        before = cuda_ops.launches["gram_sym_acc"]
        got = streaming.gram_stats(X.to(cuda_device), Y.to(cuda_device), column_major, 300,
                                   512, valid=1200)
        assert cuda_ops.launches["gram_sym_acc"] == before + 3
        # Each statistic against its own sums' scale (|F|ᵀ|F|, |F|ᵀ|Y|, ΣY²
        # over the 1,200 valid rows, featurized on the CPU), as the other
        # gram_sym_acc tests hold theirs: the card and the CPU sum the rows
        # in different orders, and entries that cancel to near zero say
        # nothing of that rounding.
        F, Yv = column_major(X[:1200]).abs(), Y[:1200]
        scales = (F.T @ F, F.T @ Yv.abs(), (Yv * Yv).sum())
        for g, w, scale in zip(got, want, scales, strict=True):
            assert ((g.cpu() - w).abs() <= 1e-5 * scale).all()
        with pytest.raises(TypeError):
            streaming.gram_stats(X.to(cuda_device), Y.to(cuda_device),
                                 lambda X_t: column_major(X_t).double(), 300, 512)


@pytest.mark.cuda
class TestBlockStreamedOnCard:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("center", [False, True])
    def test_against_the_plain_run(self, cuda_device, dtype, center):
        # The block-streamed program on the card (cosine_features,
        # gram_corr_sym, block_corr, block_residual_update) against the same
        # program through the plain versions on the CPU, ragged rows: the
        # weights within 1e-4 relative in float32 (reordered float32 sums)
        # and 5e-3 in bf16 (one-step bf16 rounding flips of features that
        # agree to float32 rounding; tests/test_torch_block_streamed.py,
        # whose slab test holds that the program honours feat_dtype, since
        # the weights alone cannot).
        from keystone_tpu_torch.parallel import streaming

        rng = np.random.default_rng(5)
        X = torch.from_numpy(rng.normal(size=(3000, 40)).astype(np.float32))
        Y = torch.from_numpy((np.cos(X.numpy() @ rng.normal(size=(40, 7)) * 0.2)
                              + 0.5).astype(np.float32))
        Wrf = torch.from_numpy((0.2 * rng.normal(size=(512, 40))).astype(np.float32))
        brf = torch.from_numpy(rng.uniform(0, 2 * np.pi, 512).astype(np.float32))
        kw = dict(block_size=128, lam=1e-2, num_iter=3, n_true=2987, feat_dtype=dtype,
                  center=center)
        want = streaming.streaming_block_bcd_mesh(X, Y, Wrf, brf, **kw)
        before = dict(cuda_ops.launches)
        got = streaming.streaming_block_bcd_mesh(
            *(t.to(cuda_device) for t in (X, Y, Wrf, brf)), **kw)
        torch.cuda.synchronize()
        launched = {name: cuda_ops.launches[name] - before[name]
                    for name in ("cosine_features", "gram_corr_sym", "block_corr",
                                 "block_residual_update")}
        assert launched == {"cosine_features": 12, "gram_corr_sym": 4, "block_corr": 8,
                            "block_residual_update": 12}
        got, want = (got, want) if center else ((got,), (want,))
        tol = 1e-4 if dtype == torch.float32 else 5e-3
        for g, w in zip(got, want, strict=True):
            assert float((g.cpu() - w).norm() / w.norm()) <= tol
