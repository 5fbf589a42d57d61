"""Shared per-class statistics and feature-block slicing for the weighted
solvers (BWLS mixes class and population moments —
BlockWeightedLeastSquares.scala:120-150).

Port of ``keystone_tpu/ops/learning/classstats.py``: the two helpers that
``bwls.py`` and ``rwls.py`` call.
"""

from __future__ import annotations

from typing import List

import torch


def mixed_class_means(X, class_of_row, counts, pop_mean, k: int, mw: float,
                      absent_to_pop: bool = False) -> torch.Tensor:
    """Per-class mixed means ``classMean·mw + popMean·(1−mw)`` as one device
    segment sum over the rows.

    ``absent_to_pop=True`` maps classes with no rows to the population mean
    outright (a zero classMean scaled by mw would bias the intercept);
    ``False`` keeps the raw mix (BWLS never reads absent rows).
    """
    sums = torch.zeros((k, X.shape[1]), dtype=X.dtype, device=X.device)
    sums.index_add_(0, class_of_row, X)
    class_means = sums / torch.clamp_min(counts, 1.0)[:, None]
    mixed = class_means * mw + pop_mean[None, :] * (1.0 - mw)
    if absent_to_pop:
        absent = (counts < 0.5).to(X.dtype)[:, None]
        mixed = mixed * (1.0 - absent) + pop_mean[None, :] * absent
    return mixed


def column_blocks(X, block_size: int, d_eff: int, pad_rows: int) -> List[torch.Tensor]:
    """Slice X into feature-column blocks (the VectorSplitter convention:
    ceil(d/bs) blocks, last one ragged), each zero-padded by ``pad_rows``
    extra rows so per-class row windows never run past the end."""
    return [
        torch.nn.functional.pad(X[:, s:min(s + block_size, d_eff)], (0, 0, 0, pad_rows))
        for s in range(0, d_eff, block_size)
    ]
