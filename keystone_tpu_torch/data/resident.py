"""Compressed-resident COO tier: int16 indices + bf16 values, chunk-tiled.

Port of ``keystone_tpu/data/resident.py``, one device. The Amazon working
set at padded-COO int32+f32 is 8 bytes per stored cell; the same data
lives at 4 bytes a cell (int16 index + bf16 value) with the decode fused
into the gram fold: the fold's densify step already casts indices to
int64 and values to its ``val_dtype`` (``ops/sparse.py::_dense_rows``), so
compressed chunks cost no extra pass.

  - :class:`CompressedCOOChunks` — encode/decode with the overflow boundary
    enforced (an index that does not fit int16 raises; it must never wrap
    silently), a stated value-drift policy, and chunk-tiled operands in
    the ``_resident_chunk_fn`` contract of
    ``ops/learning/lbfgs.py::run_lbfgs_gram_streamed``.
  - :data:`COMPRESSED_BYTES_PER_NNZ` (4.0 against the raw 8.0) and
    :func:`compressible_dim`, which ``SparseLBFGSwithL2.resident_bytes``
    prices.

The reference keeps its buffers in numpy, bf16 through ``ml_dtypes``; the
port keeps them as tensors on the device they were encoded on and rounds
to bf16 with ``Tensor.to(torch.bfloat16)``, which is round-to-nearest-even
as ``ml_dtypes`` is (tests/test_torch_sparse.py holds the bits equal).
:meth:`CompressedCOOChunks.partition` splits the chunk axis into one
contiguous partition a device, and ``index_base`` stores a partition's
lanes rebased to its own column base, each partition re-validating the
int16 boundary on its own range (the reference's mesh residency layout).

**Value-drift policy**: indices round-trip exactly or :meth:`encode`
raises. Values quantize f32 -> bf16 with round-to-nearest-even:
bf16-representable values (±1 labels, the intercept's 1.0) round-trip
exactly; others drift by at most one bf16 ulp (2⁻⁸ relative). This is the
same quantization the ``gram_dtype="bf16"`` fold applies in its densify,
so a compressed-resident fit has the bits of the bf16-engine fit over the
same rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from keystone_tpu_torch.data.dataset import as_tensor

__all__ = [
    "COMPRESSED_BYTES_PER_NNZ",
    "CompressedCOOChunks",
    "INT16_MAX_INDEX",
    "compressible_dim",
    "raw_chunk_tiles",
]

# int16 index (2 B) + bf16 value (2 B) per stored cell, against the raw
# tier's 8 B (int32 + f32).
COMPRESSED_BYTES_PER_NNZ = 4.0
# Largest column index an int16 lane can carry. The append-ones intercept
# column lives at index d, so a d-wide problem with intercept needs
# d <= INT16_MAX_INDEX.
INT16_MAX_INDEX = int(np.iinfo(np.int16).max)  # 32767

def compressible_dim(d: int, index_base: int = 0) -> bool:
    """Whether a feature width fits the int16 index encoding (indices
    0..d-1; callers appending an intercept lane at index d pass d+1). Past
    it the compressed tier is infeasible: ``resident_bytes`` prices it at
    infinity rather than wrapping indices.

    ``index_base`` is a mesh partition's rebase: a partition that stores
    indices relative to its own column base gates on the rebased width
    ``d - index_base``, not the global one."""
    return int(d) - 1 - int(index_base) <= INT16_MAX_INDEX


def _tile(t: torch.Tensor, nchunks: int, chunk_rows: int, fill) -> torch.Tensor:
    """Pad ``t``'s rows with ``fill`` to ``nchunks * chunk_rows`` and view it
    as (nchunks, chunk_rows, ·)."""
    pad = nchunks * chunk_rows - t.shape[0]
    if pad:
        t = torch.cat([t, torch.full((pad,) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                                     device=t.device)])
    return t.reshape((nchunks, chunk_rows) + tuple(t.shape[1:]))


def raw_chunk_tiles(indices, values, labels, chunk_rows: int):
    """Tile uncompressed padded-COO rows (plus labels) into the
    ``(nchunks, chunk_rows, ·)`` operand triple every streamed fold
    consumes. The ragged tail pads with index −1 / value 0 / label 0 — the
    lanes the fold's densify drops — so pad rows contribute nothing.
    Dtypes pass through; tensors stay on their device."""
    values = as_tensor(values)
    indices = as_tensor(indices, values.device)
    labels = as_tensor(labels, values.device)
    c = int(chunk_rows)
    nchunks = -(-int(indices.shape[0]) // c)
    return (
        _tile(indices, nchunks, c, -1),
        _tile(values, nchunks, c, 0),
        _tile(labels, nchunks, c, 0),
    )


class CompressedCOOChunks:
    """Padded-COO rows encoded int16 + bf16 and tiled into fold chunks.

    ``idx_t (nchunks, chunk_rows, w) int16`` (−1 = inactive lane),
    ``val_t (nchunks, chunk_rows, w) bf16``, ``y_t (nchunks, chunk_rows, k)
    float32`` — the operand triple ``lbfgs._resident_chunk_fn`` slices, so
    a compressed set rides ``run_lbfgs_gram_streamed(operands=
    chunks.operands(), val_dtype=torch.bfloat16)`` with no solver change.
    """

    def __init__(self, idx_t: torch.Tensor, val_t: torch.Tensor, y_t: torch.Tensor,
                 n_true: int, d: int, index_base: int = 0):
        self.idx_t = idx_t
        self.val_t = val_t
        self.y_t = y_t
        self.n_true = int(n_true)
        self.d = int(d)
        # A partition's column rebase: stored lanes hold ``index -
        # index_base`` (0 for the whole-set encoding).
        self.index_base = int(index_base)

    @classmethod
    def encode(
        cls,
        indices,
        values,
        labels,
        chunk_rows: int,
        d: Optional[int] = None,
        n_true: Optional[int] = None,
        index_base: int = 0,
    ) -> "CompressedCOOChunks":
        """Encode (n, w) padded-COO rows + (n, k) labels, on the device the
        values lie on (numpy input is encoded on the CPU).

        Raises :class:`ValueError` at the int16 overflow boundary (any
        active index > :data:`INT16_MAX_INDEX`): a wrapped index would add
        a value into the wrong Gramian row and corrupt the fit without a
        single NaN. Values quantize f32 -> bf16 per the module's drift
        policy. The ragged tail pads with inactive (−1) lanes and zero
        labels to whole chunks.

        ``index_base``: a mesh partition stores its lanes rebased to its own
        column base (``stored = index - base``), and the boundary is checked
        on the rebased, partition-local range: an active index below the
        base, or at ``base + 32768`` or past it, raises here, since a
        wrapped rebased index would corrupt that one device's Gramian
        partial while every other device's stays clean.
        """
        values = as_tensor(values)
        indices = as_tensor(indices, values.device)
        labels = as_tensor(labels, values.device)
        if labels.dim() == 1:
            labels = labels[:, None]
        n = int(indices.shape[0])
        n_true = n if n_true is None else int(n_true)
        index_base = int(index_base)
        if index_base:
            # Rebase only active lanes; -1 stays the inactive marker.
            active = indices >= 0
            if bool(active.any()) and int(indices[active].min()) < index_base:
                raise ValueError(
                    f"active index {int(indices[active].min())} < index_base "
                    f"{index_base}: this partition does not own that column — "
                    f"rebasing would wrap negative"
                )
            indices = torch.where(active, indices - index_base, indices.new_full((), -1))
        max_idx = int(indices.max()) if indices.numel() else -1
        d = max_idx + 1 + index_base if d is None else int(d)
        if max_idx > INT16_MAX_INDEX:
            raise ValueError(
                f"index {max_idx + index_base} (rebased {max_idx} at base "
                f"{index_base}) does not fit the int16 encoding (max "
                f"{INT16_MAX_INDEX}); the compressed-resident tier is infeasible "
                f"at this width — use the raw int32 tier (a wrapped index would "
                f"silently corrupt the Gramian)"
            )
        if indices.numel() and int(indices.min()) < -1:
            raise ValueError(
                f"index {int(indices.min())} < -1: only -1 marks an inactive lane"
            )
        idx16 = indices.to(torch.int16)
        # The boundary check above makes this structural; check the round
        # trip anyway: index quantization is never allowed loss.
        assert torch.equal(idx16.to(indices.dtype), indices)
        c = int(chunk_rows)
        nchunks = max(-(-n // c), 1)
        return cls(
            _tile(idx16, nchunks, c, -1),
            _tile(values.to(torch.bfloat16), nchunks, c, 0),
            _tile(labels.to(torch.float32), nchunks, c, 0),
            n_true=n_true, d=d, index_base=index_base,
        )

    def decode(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Back to (n, w) int32 indices / f32 values / (n, k) labels as
        numpy — what the fold's casts produce, for the round-trip tests
        (indices exact; values exact iff the input was bf16-representable)."""
        _, c, w = self.idx_t.shape
        rows = self.num_chunks * c
        keep = min(rows, self.n_true) if self.n_true else rows
        idx = self.idx_t.reshape(-1, w).to(torch.int32)
        if self.index_base:
            idx = torch.where(idx >= 0, idx + self.index_base, idx)
        val = self.val_t.reshape(-1, w).to(torch.float32)
        y = self.y_t.reshape(rows, -1)
        return (idx[:keep].cpu().numpy(), val[:keep].cpu().numpy(),
                y[:keep].cpu().numpy())

    def _validate_boundary(self) -> None:
        """The int16 boundary on THIS partition's buffers: gating on the
        global width is not enough once chunks partition across devices,
        so each partition re-validates at its own (d, index_base)."""
        if not compressible_dim(self.d, self.index_base):
            raise ValueError(
                f"partition at index_base {self.index_base} cannot represent "
                f"width {self.d} in int16 (local range {self.d - self.index_base} > "
                f"{INT16_MAX_INDEX + 1})"
            )
        if self.idx_t.numel():
            lo, hi = int(self.idx_t.min()), int(self.idx_t.max())
            if lo < -1 or hi + self.index_base >= self.d:
                raise ValueError(
                    f"partition holds indices [{lo}, {hi}] at base {self.index_base} "
                    f"outside width {self.d} — refusing to build a corrupt "
                    f"per-device Gramian"
                )

    def partition(self, num_partitions: int) -> "list[CompressedCOOChunks]":
        """Split the chunk axis into ``num_partitions`` contiguous
        per-device partitions (partition j feeds device j: chunks
        ``[j·cpd, (j+1)·cpd)``). Ragged tails pad with dead chunks
        (inactive lanes, zero labels) so every partition carries exactly
        ``cpd`` chunks; ``n_true`` splits by true-row ownership. Every
        partition re-validates the int16 boundary. The partitions lie on
        this set's device."""
        m = int(num_partitions)
        if m < 1:
            raise ValueError(f"num_partitions must be >= 1, got {m}")
        cpd = -(-self.num_chunks // m)
        c, w, k = self.chunk_rows, self.idx_t.shape[2], self.y_t.shape[2]
        dev = self.idx_t.device
        parts = []
        for j in range(m):
            lo = j * cpd
            # Wholly dead trailing partitions clamp to an empty [lo, lo).
            hi = max(min((j + 1) * cpd, self.num_chunks), lo)
            idx = torch.full((cpd, c, w), -1, dtype=self.idx_t.dtype, device=dev)
            val = torch.zeros((cpd, c, w), dtype=self.val_t.dtype, device=dev)
            y = torch.zeros((cpd, c, k), dtype=torch.float32, device=dev)
            idx[: hi - lo] = self.idx_t[lo:hi]
            val[: hi - lo] = self.val_t[lo:hi]
            y[: hi - lo] = self.y_t[lo:hi]
            n_local = int(np.clip(self.n_true - lo * c, 0, (hi - lo) * c))
            part = CompressedCOOChunks(idx, val, y, n_true=n_local, d=self.d,
                                       index_base=self.index_base)
            part._validate_boundary()
            parts.append(part)
        return parts

    @property
    def num_chunks(self) -> int:
        return int(self.idx_t.shape[0])

    @property
    def chunk_rows(self) -> int:
        return int(self.idx_t.shape[1])

    @property
    def nbytes(self) -> int:
        """Resident footprint of the compressed operands (indices + values +
        labels)."""
        return sum(t.numel() * t.element_size() for t in (self.idx_t, self.val_t, self.y_t))

    @property
    def bytes_per_nnz(self) -> float:
        return float(self.idx_t.element_size() + self.val_t.element_size())

    def operands(self):
        """The operand triple for ``run_lbfgs_gram_streamed(
        _resident_chunk_fn, ...)``, on the device it was encoded on. int16
        and bf16 stay compressed; the fold's densify is the decode."""
        return self.idx_t, self.val_t, self.y_t

    @staticmethod
    def value_drift(values) -> float:
        """Max absolute bf16 quantization error over ``values`` — the
        drift-policy audit helper (0.0 for bf16-representable input)."""
        v = as_tensor(values).to(torch.float32)
        if not v.numel():
            return 0.0
        return float((v.to(torch.bfloat16).to(torch.float32) - v).abs().max())
