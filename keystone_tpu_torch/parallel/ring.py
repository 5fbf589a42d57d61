"""Ring collectives over the mesh ``data`` axis: sequence-parallel kernel
computation.

Port of ``keystone_tpu/parallel/ring.py``. The n×n kernel matrix is never
made on one device: training rows stay sharded over the ``data`` axis, and
at each step every shard computes the kernel block between its resident
rows and a *visiting* shard that then moves one place along the ring (the
block-rotation schedule of ring attention).

The reference's ring bodies are a ``fori_loop`` with a ``ppermute`` inside,
one program over the mesh. The port is a single controller, which cannot
hand a shard to its neighbour in the middle of a body, so a ring here is a
loop at the controller's level: P steps, each one pass over the shards (one
kernel launch a shard) followed by one rotation (``mesh.ppermute``: a peer
copy to the neighbour's device, or the same tensor where the two shards
share a device). The shards of one step run one after another, so with 8
shards on one card a ring's wall is no evidence of scaling. On a
multi-process mesh each process runs its own shards and the rotation
crosses processes point to point (``mesh.ppermute(group=)``).

Primitives:
  - :func:`ring_pairwise_gaussian`: the full row-sharded n×n Gaussian
    kernel, one ``gaussian_kernel_block`` launch a shard a step.
  - :func:`ring_kernel_apply`: K(test, train) @ W with the train rows *and*
    the dual model W sharded, one ``gaussian_resid_block`` launch a shard
    a step.
  - :func:`ring_attention`: exact softmax attention over a sharded
    sequence with an online softmax.
  - :func:`ring_gram`: AᵀA with the reduction scattered over the shards
    (``mesh.psum_scatter``).

The products of :func:`ring_attention` and :func:`ring_gram` are XLA in the
reference, not Pallas kernels; here they are ``torch.matmul`` in float32
(TF32 is off in this package: "f32 means f32").
"""

from __future__ import annotations

from typing import List, Optional

import torch

from keystone_tpu_torch.ops import cuda_ops

from . import mesh as mesh_lib


def row_norms(x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The squared row norms the Gaussian kernels take, summed in ``dtype``
    (default: the rows' dtype, at least float32)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32) if dtype is None else dtype)
    return (xf * xf).sum(dim=1)


def _gaussian_plain(x, y, gamma: float, xn=None, yn=None) -> torch.Tensor:
    """exp(−γ·max(‖x‖² + ‖y‖² − 2x·y, 0)) in the rows' dtype (float64 rows)."""
    xn = row_norms(x) if xn is None else xn
    yn = row_norms(y) if yn is None else yn
    sq = xn[:, None] + yn[None, :] - 2.0 * (x @ y.T)
    return torch.exp(-float(gamma) * torch.clamp_min(sq, 0.0))


def _gaussian(x, y, gamma: float, xn=None, yn=None) -> torch.Tensor:
    """One shard's Gaussian kernel block inside a ring step: the
    ``gaussian_kernel_block`` kernel (its plain version on CPU tensors), in
    the rows' dtype. float64 rows keep a plain float64 block, as the
    reference keeps XLA for x64 so that ring results stay double precision
    on its CPU test backend: the kernel computes in float32."""
    if x.dtype == torch.float64:
        return _gaussian_plain(x, y, gamma, xn, yn)
    xn = row_norms(x) if xn is None else xn
    yn = row_norms(y) if yn is None else yn
    return cuda_ops.gaussian_kernel_block(x, y, xn, yn, gamma).to(x.dtype)


def _shards(x, mesh: mesh_lib.Mesh) -> mesh_lib.ShardedRows:
    """``x`` row-sharded over ``mesh``'s ``data`` axis (a plain tensor is
    sharded first; its rows must divide over the axis)."""
    if isinstance(x, mesh_lib.ShardedRows):
        if x.num_shards != mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS):
            raise ValueError(
                f"{x.num_shards} shards on a mesh whose data axis has "
                f"{mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS)}")
        return x
    return mesh_lib.shard_rows(x, mesh)


def _mesh_of(mesh, *xs) -> mesh_lib.Mesh:
    if mesh is not None:
        return mesh
    for x in xs:
        if isinstance(x, mesh_lib.ShardedRows):
            return x.mesh
    return mesh_lib.default_mesh()


def ring_pairwise_gaussian(X, gamma: float, mesh: Optional[mesh_lib.Mesh] = None
                           ) -> mesh_lib.ShardedRows:
    """The full n×n Gaussian kernel over row-sharded X, its rows sharded as
    X's. At step s shard ``me`` holds the shard that started at
    ``(me − s) mod P`` and writes its (n/P, n/P) block into its stripe's
    columns of that shard, so the n×n matrix exists only sharded."""
    mesh = _mesh_of(mesh, X)
    xs = _shards(X, mesh)
    p, ln, group = xs.num_shards, xs.shard_rows, xs.group
    devices = [s.device for s in xs.shards]
    norms = [row_norms(s) for s in xs.shards]
    visiting, vnorms = list(xs.shards), list(norms)
    cols = [torch.empty((ln, ln * p), dtype=s.dtype, device=s.device) for s in xs.shards]
    perm = mesh_lib.ring_perm(p)
    for step in range(p):
        for j, me in enumerate(xs.indices):
            src = (me - step) % p
            cols[j][:, src * ln:(src + 1) * ln] = _gaussian(
                xs.shards[j], visiting[j], gamma, norms[j], vnorms[j])
        if step < p - 1:
            visiting = mesh_lib.ppermute(visiting, perm, devices, group=group)
            vnorms = mesh_lib.ppermute(vnorms, perm, devices, group=group)
    return mesh_lib.ShardedRows(cols, mesh, xs.axis, xs.indices)


def ring_kernel_apply(X_test, X_train, W, gamma: float,
                      mesh: Optional[mesh_lib.Mesh] = None) -> mesh_lib.ShardedRows:
    """predictions = K(test, train) @ W with the train rows and W
    row-sharded alike (the distributed KernelBlockLinearMapper apply,
    reference KernelBlockLinearMapper.scala:28-115, with neither operand
    gathered).

    The (train shard, model shard) pair circulates the ring; each shard
    accumulates the partial product for its resident test rows. Each
    step's ``K(test_local, train_shard) @ W_shard`` is one
    ``gaussian_resid_block`` launch a shard, its operands in the order
    ``(train_shard, test_local, W_shard)``: the kernel contracts the block
    tile by tile (``K(train_shard, test_local)ᵀ W_shard``), so the block is
    never stored. float64 rows take the plain float64 block and product.

    X_test: (m, d), X_train: (n, d), W: (n, k), each row-sharded over
    ``data`` (plain tensors are sharded first). Returns (m, k) row-sharded.
    """
    mesh = _mesh_of(mesh, X_test, X_train, W)
    xt, xtr, ws = (_shards(a, mesh) for a in (X_test, X_train, W))
    p, group = xt.num_shards, xt.group
    devices = [s.device for s in xt.shards]
    tnorms = [row_norms(s) for s in xt.shards]
    visiting = list(xtr.shards)
    vnorms = [row_norms(s) for s in xtr.shards]
    vw = list(ws.shards)
    acc: List[Optional[torch.Tensor]] = [None] * len(xt.shards)
    perm = mesh_lib.ring_perm(p)
    for step in range(p):
        for j in range(len(xt.shards)):
            if xt.dtype == torch.float64:
                part = _gaussian_plain(xt.shards[j], visiting[j], gamma, tnorms[j],
                                       vnorms[j]) @ vw[j].to(torch.float64)
            else:
                part = cuda_ops.gaussian_resid_block(
                    visiting[j], xt.shards[j], vnorms[j], tnorms[j], vw[j], gamma)
            acc[j] = part if acc[j] is None else acc[j].add_(part)
        if step < p - 1:
            visiting = mesh_lib.ppermute(visiting, perm, devices, group=group)
            vnorms = mesh_lib.ppermute(vnorms, perm, devices, group=group)
            vw = mesh_lib.ppermute(vw, perm, devices, group=group)
    out_dtype = ws.dtype if xt.dtype != torch.float64 else torch.float64
    return mesh_lib.ShardedRows([a.to(out_dtype) for a in acc], mesh, xt.axis, xt.indices)


def ring_attention(Q, K, V, mesh: Optional[mesh_lib.Mesh] = None, causal: bool = False,
                   scale: Optional[float] = None, n_valid: Optional[int] = None
                   ) -> mesh_lib.ShardedRows:
    """Exact softmax attention over a sequence sharded across the mesh
    (Ring Attention, Liu et al. 2023): queries stay resident, the (K, V)
    shard pair circulates the ring, and each step folds one block of scores
    into an online softmax (row max ``m``, normalizer ``l``, weighted
    accumulator), so neither the n×n scores nor the whole K, V exist on one
    shard.

    Q, K, V: (n, d) row-sharded over ``data`` alike. ``causal=True`` masks
    by GLOBAL sequence position (query i attends to keys j ≤ i across shard
    boundaries). Rows padded on by ``mesh.pad_rows`` must be masked through
    ``n_valid``: a zero key row scores 0 and still gets weight under
    softmax, unlike the Gramian and moment sums the zero-padding invariant
    covers; padded query rows come out zero. The state (m, l, acc) is
    float32 whatever the operands' dtype (float64 stays float64): bf16
    operands are widened to float32 for the products, which is exact for
    their products, and the result is cast to the operands' common dtype
    once at the end. Returns (n, d) row-sharded, equal to
    ``softmax(QKᵀ·scale [+ mask]) V``.
    """
    mesh = _mesh_of(mesh, Q, K, V)
    qs, ks, vs = (_shards(a, mesh) for a in (Q, K, V))
    p, n_loc, d = qs.num_shards, qs.shard_rows, qs.shape[1]
    sc = (1.0 / d ** 0.5) if scale is None else float(scale)
    out_dtype = torch.promote_types(torch.promote_types(qs.dtype, ks.dtype), vs.dtype)
    acc_dtype = torch.promote_types(out_dtype, torch.float32)
    neg = -1e30
    devices, group = [s.device for s in qs.shards], qs.group
    q_pos = [me * n_loc + torch.arange(n_loc, device=devices[j])
             for j, me in enumerate(qs.indices)]
    k_blk, v_blk = list(ks.shards), list(vs.shards)
    m = [torch.full((n_loc,), neg, dtype=acc_dtype, device=dev) for dev in devices]
    l_ = [torch.zeros((n_loc,), dtype=acc_dtype, device=dev) for dev in devices]
    acc = [torch.zeros((n_loc, vs.shape[1]), dtype=acc_dtype, device=dev) for dev in devices]
    perm = mesh_lib.ring_perm(p)
    for step in range(p):
        for me, gme in enumerate(qs.indices):
            src = (gme - step) % p  # origin shard of the visiting block
            q = qs.shards[me].to(acc_dtype)
            scores = (q @ k_blk[me].to(acc_dtype).T) * sc
            k_pos = src * n_loc + torch.arange(n_loc, device=devices[me])
            if causal:
                scores = torch.where(q_pos[me][:, None] >= k_pos[None, :], scores, neg)
            if n_valid is not None:
                scores = torch.where(k_pos[None, :] < n_valid, scores, neg)
            m_new = torch.maximum(m[me], scores.max(dim=1).values)
            # Step 0 visits the shard's own block, where every valid query's
            # own key is unmasked, so m is finite before an all-masked block
            # can arrive (padded query rows may see one; they are zeroed).
            alpha = torch.exp(m[me] - m_new)
            p_blk = torch.exp(scores - m_new[:, None])
            l_[me] = l_[me] * alpha + p_blk.sum(dim=1)
            acc[me] = acc[me] * alpha[:, None] + p_blk @ v_blk[me].to(acc_dtype)
            m[me] = m_new
        if step < p - 1:
            k_blk = mesh_lib.ppermute(k_blk, perm, devices, group=group)
            v_blk = mesh_lib.ppermute(v_blk, perm, devices, group=group)
    outs = []
    for me in range(len(qs.shards)):
        out = acc[me] / torch.clamp_min(l_[me], 1e-30)[:, None]
        if n_valid is not None:
            out = out * (q_pos[me] < n_valid)[:, None].to(out.dtype)
        outs.append(out.to(out_dtype))
    return mesh_lib.ShardedRows(outs, mesh, qs.axis, qs.indices)


def ring_attention_dataset(q_data, k_data=None, v_data=None,
                           mesh: Optional[mesh_lib.Mesh] = None, causal: bool = False,
                           scale: Optional[float] = None):
    """Dataset-aware :func:`ring_attention`: ``Dataset.n`` becomes
    ``n_valid``, so the mesh's zero padding is never softmax-weighted.
    ``k_data`` defaults to ``q_data`` (self-attention) and ``v_data`` to
    ``k_data``; all must share one padded length and true row count. The
    mesh defaults to the one ``q_data`` is sharded over."""
    from keystone_tpu_torch.data import Dataset

    k_data = q_data if k_data is None else k_data
    v_data = k_data if v_data is None else v_data
    if not (q_data.n == k_data.n == v_data.n):
        raise ValueError(
            f"ring_attention_dataset needs matching true row counts, got "
            f"{q_data.n}, {k_data.n}, {v_data.n}")
    mesh = mesh or q_data.mesh
    out = ring_attention(q_data.array, k_data.array, v_data.array, mesh=mesh,
                         causal=causal, scale=scale, n_valid=q_data.n)
    return Dataset(out, n=q_data.n, mesh=mesh)


def ring_gram(A, mesh: Optional[mesh_lib.Mesh] = None) -> mesh_lib.ShardedRows:
    """AᵀA over row-sharded A, the (d, d) result scattered over the mesh:
    each shard ends with a (d/P, d) row stripe (``mesh.psum_scatter``)
    instead of every shard holding the whole Gramian. Each shard's partial
    is one float32 product (float64 rows: float64). Returns the result
    row-sharded over ``data``.

    Requires d to be divisible by the mesh size."""
    mesh = _mesh_of(mesh, A)
    a = _shards(A, mesh)
    p, d = a.num_shards, a.shape[1]
    if d % p != 0:
        raise ValueError(f"feature dim {d} not divisible by mesh size {p}")
    acc = torch.promote_types(a.dtype, torch.float32)
    parts = [s.to(acc).T @ s.to(acc) for s in a.shards]
    stripes = mesh_lib.psum_scatter(parts, [s.device for s in a.shards], group=a.group)
    return mesh_lib.ShardedRows(stripes, mesh, a.axis, a.indices)
