"""Sparse feature nodes and the padded-COO compute substrate.

Port of ``keystone_tpu/ops/sparse.py`` (reference:
nodes/util/CommonSparseFeatures.scala:20-64, AllSparseFeatures.scala:15-27,
SparseFeatureVectorizer.scala:7-17, Densify.scala:10-21,
Sparsify.scala:10-20).

Sparse batch format: padded COO per row —
``{"indices": (n, max_nnz) int (−1 padding), "values": (n, max_nnz)}``
carried as a dict-payload Dataset.

The gather engine never densifies: :func:`sparse_matmul` (X @ W) is a
gather over the model rows plus a reduction over the nnz axis, and
:func:`sparse_matmul_t` (Xᵀ V) a segment-sum scatter over the flattened
active indices (``index_add_``; on CUDA its atomics add in no fixed order,
so its results agree with the reference to rounding, not bit for bit).
Indices outside [0, d) are dropped by both, and by every densify: the X
and Xᵀ operators must agree or gradients silently corrupt.

The gram engine (:func:`sparse_gram_fold`) densifies each row chunk into a
(c, d) slab and folds it into (G = AᵀA, AᵀY, ΣY²) through the hand-written
``cuda_ops.gram_corr_sym_acc`` kernel, accumulating in place: a tensor on
the CPU takes the kernel's plain version, a CUDA tensor launches the kernel
or raises — there is no ``use_pallas`` knob. A bf16 slab's row stride is
d rounded up to 64 elements (the pad columns are never read): the kernel
reads bf16 F in place through TMA. The densify adds duplicate
(row, index) lanes in lane order and writes each column once, so a slab
has the same bits on every run and device; the compressed-resident and
bf16 gram engines therefore give the same bits on the card too.

Carry width: the reference pads d to its TPU syrk tile
(:func:`gram_pad_dim`, 512 or 1024 columns); the port's kernel masks
ragged edges, so the (G, AtY) carry is sized at d itself. The reference's
padded rows of W stay exactly zero through every iterate, so ``W[:d]`` is
the same function; at the Amazon geometry (d₁ = 16,385 against a bf16 pad
of 17,408) the fold does 11% fewer FLOPs. :func:`gram_pad_dim` is still
ported for callers that ask for it.

The sparse feature-space nodes declare their signatures to the plan
verifier (``workflow/verify.py``): ``output_signature``,
``check_fit_signature`` and ``fitted_signature``.
"""

from __future__ import annotations

import heapq
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.ops import cuda_ops
from keystone_tpu_torch.workflow import Estimator, Transformer


def _item_pairs(item) -> List[Tuple[Any, float]]:
    """Normalize a sparse item: dict or iterable of (feature, value)."""
    if isinstance(item, dict):
        return list(item.items())
    return list(item)


def sparse_batch_from_items(
    items: Sequence, feature_index: Dict[Any, int], max_nnz: Optional[int] = None
) -> Dataset:
    """Host items (feature, value) -> padded-COO batch over a vocabulary."""
    rows = []
    for item in items:
        pairs = [
            (feature_index[f], v) for f, v in _item_pairs(item) if f in feature_index
        ]
        pairs.sort()
        rows.append(pairs)
    width = max(max_nnz or max((len(r) for r in rows), default=1), 1)
    n = len(rows)
    indices = np.full((n, width), -1, dtype=np.int32)
    values = np.zeros((n, width), dtype=np.float32)
    for i, pairs in enumerate(rows):
        pairs = pairs[:width]
        if pairs:
            idx, val = zip(*pairs)
            indices[i, : len(idx)] = idx
            values[i, : len(val)] = val
    return Dataset({"indices": indices, "values": values}, n=n)


def is_sparse_dataset(data: Dataset) -> bool:
    return (
        not data.is_host
        and isinstance(data.data, dict)
        and set(data.data.keys()) == {"indices", "values"}
    )


def _coo(data: Dataset):
    """A sparse dataset's (indices, values) as tensors on the values' device."""
    values = as_tensor(data.data["values"])
    return as_tensor(data.data["indices"], values.device), values


def densify_dataset(data: Dataset, num_features: Optional[int] = None) -> Dataset:
    """Padded-COO batch -> dense (n, d) batch (one scatter per batch)."""
    if not is_sparse_dataset(data):
        return data
    indices, values = _coo(data)
    d = num_features if num_features is not None else int(indices.max()) + 1
    return Dataset(_dense_rows(indices, values, d, values.dtype), n=data.n)


def _dense_rows(indices, values, d: int, dtype, row_align: int = 1) -> torch.Tensor:
    """(c, w) padded-COO rows -> a dense, contiguous (c, d) slab of
    ``dtype``. Lanes outside [0, d) are dropped; values are cast to
    ``dtype`` first and duplicates of a column within a row add in lane
    order in ``dtype`` (the reference's scatter-add into zeros). Each column
    is then written once by a plain scatter, so the slab has the same bits
    on every run and device, where a scatter-add would add duplicates in
    whatever order its atomics land.

    ``row_align`` > 1 gives the slab a row stride of d rounded up to a
    multiple of ``row_align`` elements instead: the (c, d) view of a wider
    zeroed buffer, whose pad columns are never read. The values are the
    same."""
    c, w = indices.shape
    device = values.device
    ld = -(-d // row_align) * row_align
    dense = torch.zeros((c, ld), dtype=dtype, device=device)[:, :d]
    if c == 0 or w == 0:
        return dense
    idx = indices.to(device=device, dtype=torch.int64)
    live = (idx >= 0) & (idx < d)
    # Dropped lanes take column d: they sort last and are never written.
    idx = torch.where(live, idx, d)
    vals = torch.where(live, values, torch.zeros((), dtype=values.dtype, device=device))
    idx, order = torch.sort(idx, dim=1, stable=True)
    vals = torch.gather(vals.to(dtype), 1, order)
    same = idx[:, 1:] == idx[:, :-1]
    if bool(same.any()):
        for j in range(1, w):
            vals[:, j] = torch.where(same[:, j - 1], vals[:, j - 1] + vals[:, j], vals[:, j])
    last = torch.ones_like(live)
    last[:, :-1] = ~same
    keep = last & (idx < d)
    rows = torch.arange(c, device=device)[:, None].expand(c, w)
    dense[rows[keep], idx[keep]] = vals[keep]
    return dense


# Label widths up to this take the per-column formulation (one (n, w)
# intermediate a column); wider labels run the (chunk, w, k) form over row
# chunks bounded at _CHUNK_ELEMS elements, as the reference does.
_COLWISE_MAX_K = 32
_CHUNK_ELEMS = 1 << 20


def _chunk_rows(n: int, w: int, k: int) -> int:
    """Rows per chunk of the wide-k paths: the (chunk, w, k) transient at
    about _CHUNK_ELEMS elements, capped at n."""
    return min(max(n, 1), max(1, _CHUNK_ELEMS // max(w * k, 1)))


def _masked(indices, values, d: int, fill: int, dtype):
    """(safe indices, values) with lanes outside [0, d) sent to ``fill``
    with value 0, values cast to ``dtype``."""
    idx = indices.to(torch.int64)
    mask = (idx >= 0) & (idx < d)
    safe = torch.where(mask, idx, fill)
    vals = torch.where(mask, values, torch.zeros((), dtype=values.dtype, device=values.device))
    return safe, vals.to(dtype)


def sparse_matmul(indices, values, W) -> torch.Tensor:
    """X @ W for a padded-COO X without densifying.

    out[i] = Σ_j values[i, j] · W[indices[i, j], :] — a gather of the model
    rows at the active indices plus a reduction over the nnz axis (the
    active-index loops of LeastSquaresSparseGradient, Gradient.scala:58-123).
    Cost is O(n · max_nnz · k) independent of d. Indices outside [0, d) are
    dropped.
    """
    values = as_tensor(values, W.device)
    indices = as_tensor(indices, W.device)
    n, w = indices.shape
    k = W.shape[1]
    safe, vals = _masked(indices, values, W.shape[0], 0, W.dtype)
    if k <= _COLWISE_MAX_K:
        cols = [(vals * W[:, c][safe]).sum(dim=1) for c in range(k)]
        return torch.stack(cols, dim=1) if cols else vals.new_zeros((n, 0))
    out = torch.empty((n, k), dtype=W.dtype, device=W.device)
    step = _chunk_rows(n, w, k)
    for s in range(0, n, step):
        out[s:s + step] = torch.einsum("cw,cwk->ck", vals[s:s + step], W[safe[s:s + step]])
    return out


def sparse_matmul_t(indices, values, V, d: int) -> torch.Tensor:
    """Xᵀ @ V for a padded-COO X via segment-sum scatters.

    Every active (i, j) contributes ``values[i, j] · V[i, :]`` to output row
    ``indices[i, j]``; padding and out-of-range lanes scatter into a ghost
    row d that is sliced off (dropped, as in :func:`sparse_matmul`).
    Together the two give the gradient Xᵀ(XW − Y) without a dense design
    matrix. Small k scatters one output column at a time; wide k adds
    row-chunked scatters.
    """
    values = as_tensor(values, V.device)
    indices = as_tensor(indices, V.device)
    n, w = indices.shape
    k = V.shape[1]
    safe, vals = _masked(indices, values, d, d, V.dtype)
    out = torch.zeros((d + 1, k), dtype=V.dtype, device=V.device)
    if k <= _COLWISE_MAX_K:
        flat = safe.reshape(-1)
        for c in range(k):
            out[:, c].index_add_(0, flat, (vals * V[:, c][:, None]).reshape(-1))
        return out[:d]
    step = _chunk_rows(n, w, k)
    for s in range(0, n, step):
        contrib = vals[s:s + step, :, None] * V[s:s + step, None, :]
        out.index_add_(0, safe[s:s + step].reshape(-1), contrib.reshape(-1, k))
    return out[:d]


def gram_pad_dim(d: int, val_dtype) -> int:
    """The reference's column padding for its dense slabs: d rounded up to
    its accumulating-syrk column tile (1024 for bf16, else 512). The port's
    fold does not pad (the kernel masks ragged edges); kept for callers
    that ask for the reference's width."""
    tile = 1024 if val_dtype == torch.bfloat16 else 512
    return -(-d // tile) * tile


def sparse_gram_init(d: int, k: int, device=None):
    """Zero (G_raw, AtY, yty) carry for :func:`sparse_gram_fold`, at width d
    (no padding: see the module docstring)."""
    return (
        torch.zeros((d, d), dtype=torch.float32, device=device),
        torch.zeros((d, k), dtype=torch.float32, device=device),
        torch.zeros((), dtype=torch.float32, device=device),
    )


def gram_finalize(G) -> torch.Tensor:
    """Mirror the accumulated upper triangle into a full symmetric G."""
    return torch.triu(G) + torch.triu(G, 1).T


def sparse_gram_stream(chunk_fn, num_chunks: int, d: int, k: int,
                       val_dtype=torch.float32, pipeline: bool = True):
    """Fold (G = AᵀA, AᵀY, ΣY²) over padded-COO row chunks — the sparse arm
    of the out-of-core streaming tier.

    ``chunk_fn(cid)`` returns ``(indices (c, w) int, values (c, w), Y (c, k))``
    for chunk ``cid``: sliced from resident (possibly int16/bf16-compressed)
    buffers, or regenerated/loaded per chunk so the full dataset never
    exists on the device. Negative indices are inactive lanes. Each chunk
    is densified into a (c, d) slab and folded through
    ``cuda_ops.gram_corr_sym_acc``; returns (G, AtY, yty) with G mirrored
    to full symmetry. For a fold over several calls use
    :func:`sparse_gram_fold` and :func:`gram_finalize` once at the end.
    """
    G, AtY, yty = sparse_gram_fold(None, range(num_chunks), chunk_fn, d, k,
                                   val_dtype=val_dtype, pipeline=pipeline)
    return gram_finalize(G), AtY, yty


# Row alignment, in elements, of the gram fold's slabs: 64 bf16 are one
# 128-byte TMA box row of the kernel's bf16 form, 4 float32 one 16-byte
# cp.async chunk of its float32 form.
_SLAB_ROW_ALIGN = {torch.bfloat16: 64, torch.float32: 4}


def sparse_gram_fold(carry, cids, chunk_fn, d: int, k: int, val_dtype=torch.float32,
                     pipeline: bool = True):
    """Fold the chunk ids ``cids`` into the (G_raw, AtY, yty) carry.

    ``carry=None`` starts fresh (:func:`sparse_gram_init`, on the first
    chunk's device); a given carry's G and AtY are accumulated IN PLACE
    (the reference donates its carry). G_raw carries the accumulating-syrk
    upper-triangle contract: call :func:`gram_finalize` after the last
    fold. ``val_dtype`` is the slab dtype (float32 or bfloat16); labels are
    rounded to it in the correlation, as the reference's kernel does.

    Two chunk-loop structures with the same chunk order and the same
    results: ``pipeline=True`` densifies chunk i+1 before folding chunk i
    (the reference's double-buffered scan; two slabs resident),
    ``pipeline=False`` densifies and folds one chunk at a time (one slab
    resident; for folds beside large resident operands).
    """
    cids = [int(c) for c in cids]

    # A bf16 slab is read by the kernel's TMA loads in place: its rows
    # start on 16-byte boundaries (``cuda_ops.gram_corr_acc_ok``). A float32
    # slab's rows do too, so the kernel copies them in 16-byte chunks; the
    # pad columns are never read.
    row_align = _SLAB_ROW_ALIGN.get(val_dtype, 1)

    def densify(cid):
        indices, values, Yc = chunk_fn(cid)
        return _dense_rows(indices, values, d, val_dtype, row_align), Yc

    def fold(carry, slab, Yc):
        if carry is None:
            carry = sparse_gram_init(d, k, device=slab.device)
        G, AtY, yty = carry
        cuda_ops.gram_corr_sym_acc(G, AtY, slab, Yc, out=(G, AtY))
        Yf = Yc.to(torch.float32)
        return G, AtY, yty + (Yf * Yf).sum()

    if pipeline and len(cids) > 1:
        staged = densify(cids[0])
        for cid in cids[1:]:
            nxt = densify(cid)
            carry = fold(carry, *staged)
            staged = nxt
        return fold(carry, *staged)
    for cid in cids:
        slab, Yc = densify(cid)
        carry = fold(carry, slab, Yc)
        del slab
    return carry


class Densify(Transformer):
    """Sparse batch -> dense batch (reference: Densify.scala:10-21)."""

    def __init__(self, num_features: Optional[int] = None):
        self.num_features = num_features

    def apply(self, x):
        if isinstance(x, dict) and set(x.keys()) == {"indices", "values"}:
            idx = np.asarray(as_tensor(x["indices"]).cpu())
            val = as_tensor(x["values"])
            d = self.num_features or int(np.max(idx)) + 1
            out = np.zeros(d, dtype=np.float32)
            m = idx >= 0
            out[idx[m]] = np.asarray(val.float().cpu())[m]
            return torch.from_numpy(out).to(val.device)
        return as_tensor(x)

    def batch_apply(self, data: Dataset) -> Dataset:
        return densify_dataset(data, self.num_features)


def padded_coo_rows(X: torch.Tensor, chunk_elements: int = 1 << 27):
    """(indices, values) of the padded-COO form of the dense rows ``X`` on
    ``X``'s device: each row's nonzero columns in ascending order, then -1
    lanes with zero values, as wide as the densest row (at least 1) — the
    reference's padded-COO layout. Rows are converted in chunks of about
    ``chunk_elements`` elements."""
    X = X.float()
    n, d = X.shape
    counts = (X != 0).sum(dim=1)
    width = max(int(counts.max()) if n else 0, 1)
    indices = torch.full((n, width), -1, dtype=torch.int32, device=X.device)
    values = torch.zeros((n, width), dtype=torch.float32, device=X.device)
    rows = max(1, chunk_elements // max(d, 1))
    for lo in range(0, n, rows):
        block = X[lo:lo + rows]
        mask = block != 0
        rank = torch.cumsum(mask, dim=1, dtype=torch.int32) - 1
        r, c = torch.nonzero(mask, as_tuple=True)
        slot = rank[r, c].long()
        indices[lo + r, slot] = c.to(torch.int32)
        values[lo + r, slot] = block[r, c]
    return indices, values


class Sparsify(Transformer):
    """Dense batch -> padded-COO sparse batch (reference: Sparsify.scala:10-20).

    Rows are converted on their own device by :func:`padded_coo_rows`."""

    def apply(self, x):
        if isinstance(x, dict) and "indices" in x and "values" in x:
            return x  # already a sparse item: identity (mirrors Densify)
        x = np.asarray(as_tensor(x).float().cpu())
        idx = np.nonzero(x)[0]
        return {"indices": idx.astype(np.int32), "values": x[idx].astype(np.float32)}

    def batch_apply(self, data: Dataset) -> Dataset:
        if is_sparse_dataset(data):
            # Already padded-COO (a Sparsify -> SparseLBFGS chain fitted on
            # sparse input): sparsifying is the identity.
            return data
        X = as_tensor(data.array)
        indices, values = padded_coo_rows(X)
        if not X.is_cuda:
            # Host rows give host arrays, as the reference's loop does; rows
            # on the card stay there for the fit.
            indices, values = indices.numpy(), values.numpy()
        return Dataset({"indices": indices, "values": values}, n=data.n)


class SparseFeatureVectorizer(Transformer):
    """Map items to sparse vectors in a fixed feature space
    (reference: SparseFeatureVectorizer.scala:7-17)."""

    def __init__(self, feature_space: Dict[Any, int], max_nnz: Optional[int] = None):
        self.feature_space = feature_space
        self.num_features = len(feature_space)
        self.max_nnz = max_nnz

    @property
    def sparse_output_dim(self) -> int:
        """Declared output width (largest feature id + 1)."""
        space = self.feature_space.values()
        return (max(space) + 1) if space else 0

    def apply(self, item):
        pairs = sorted(
            (self.feature_space[f], v)
            for f, v in _item_pairs(item)
            if f in self.feature_space
        )
        idx = np.asarray([p[0] for p in pairs], dtype=np.int32)
        val = np.asarray([p[1] for p in pairs], dtype=np.float32)
        return {"indices": idx, "values": val}

    def batch_apply(self, data: Dataset) -> Dataset:
        return sparse_batch_from_items(data.to_list(), self.feature_space, self.max_nnz)

    def output_signature(self, sig):
        """Verifier declaration: weighted host items in, padded-COO
        sparse batch out (`sparse` kind — the dict batch the sparse
        solvers consume)."""
        from keystone_tpu_torch.workflow.verify import HostSig, expect_host

        sig = expect_host(sig, ("tf_dict", "ngram_counts"), self)
        return HostSig("sparse", n=sig.n, datum=sig.datum)


def _check_sparse_fit_input(est, input_sigs):
    """Shared fit-input contract for the sparse feature-space estimators:
    the DATA input must be weighted host items (a raw token stream here
    means the TermFrequency/weighting stage was dropped)."""
    from keystone_tpu_torch.workflow.verify import HostSig, expect_host

    if input_sigs and isinstance(input_sigs[0], HostSig):
        expect_host(input_sigs[0], ("tf_dict", "ngram_counts"), est)


def _sparse_fitted_signature(input_sigs):
    from keystone_tpu_torch.workflow.verify import HostSig

    sig = input_sigs[0] if input_sigs else None
    return HostSig("sparse", n=getattr(sig, "n", None), datum=getattr(sig, "datum", False))


class CommonSparseFeatures(Estimator):
    """Keep the top-K features by document frequency, deterministic tie-break
    (reference: CommonSparseFeatures.scala:20-64)."""

    def __init__(self, num_features: int, max_nnz: Optional[int] = None):
        self.num_features = num_features
        self.max_nnz = max_nnz

    def fit(self, data: Dataset) -> SparseFeatureVectorizer:
        doc_freq: Counter = Counter()
        for item in data.to_list():
            for f, _ in _item_pairs(item):
                doc_freq[f] += 1
        # Deterministic: sort by (-count, repr), the analog of the
        # reference's zipWithUniqueId tie-break.
        top = heapq.nsmallest(
            self.num_features, doc_freq.items(), key=lambda kv: (-kv[1], repr(kv[0]))
        )
        return SparseFeatureVectorizer({f: i for i, (f, _) in enumerate(top)}, self.max_nnz)

    def check_fit_signature(self, input_sigs):
        _check_sparse_fit_input(self, input_sigs)

    def fitted_signature(self, input_sigs):
        return _sparse_fitted_signature(input_sigs)


class AllSparseFeatures(Estimator):
    """Use every observed feature (reference: AllSparseFeatures.scala:15-27)."""

    def __init__(self, max_nnz: Optional[int] = None):
        self.max_nnz = max_nnz

    def fit(self, data: Dataset) -> SparseFeatureVectorizer:
        seen: Dict[Any, int] = {}
        for item in data.to_list():
            for f, _ in _item_pairs(item):
                if f not in seen:
                    seen[f] = len(seen)
        return SparseFeatureVectorizer(seen, self.max_nnz)

    def check_fit_signature(self, input_sigs):
        _check_sparse_fit_input(self, input_sigs)

    def fitted_signature(self, input_sigs):
        return _sparse_fitted_signature(input_sigs)
