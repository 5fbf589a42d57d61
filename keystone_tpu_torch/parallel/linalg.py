"""Linear algebra for the block solvers: the in-tree replacement for mlmatrix.

Port of ``keystone_tpu/parallel/linalg.py`` for one device: the ridge
normal-equations solve, the stepwise block coordinate descent, the
stacked fused BCD whose first-epoch Gramian + correlation runs through the
``gram_corr_sym`` CUDA kernel, and the flat fused BCD, whose block updates
read each column window of one (n, d) feature matrix in place through the
``block_gram_sym`` / ``block_corr`` / ``block_residual_update`` kernels.
The shared block update keeps the reference's ``sym`` switch: ``False``
takes the dense form's ``gram_corr`` wrapper instead of ``gram_corr_sym``
(in the port both launch the one kernel of ``csrc/gram_corr.cu``).
``tsqr_r`` is the tall-skinny QR's R factor.

On a multi-device mesh (``parallel/mesh.py``, rows sharded over ``data``)
``bcd_least_squares(mesh=)`` runs each block step as the reference's
``_mesh_bcd_step``: each shard's Gramian and correlation through
``gram_corr_sym`` (its plain version on the CPU), one ``psum`` of the two,
the solve on the axis's first device, and each shard's residual update on
its own rows; ``tsqr_r`` takes each shard's local R and factors their
stack.

Conventions (matching the reference solvers):
  - ridge solve is ``(AᵀA + λI) x = AᵀB`` with *raw* λ (not scaled by n)
    (reference: nodes/learning/LinearMapper.scala:80-98 via mlmatrix
    NormalEquations; BlockWeightedLeastSquares.scala:270-276).
  - block coordinate descent is Gauss-Seidel over feature blocks maintaining
    the residual ``R = B - Σ_b A_b W_b`` (the in-tree pattern at
    BlockWeightedLeastSquares.scala:177-313, subsuming mlmatrix
    BlockCoordinateDescent.solveLeastSquaresWithL2 / solveOnePassL2).

The reference's ``lax.scan`` / ``fori_loop`` sweeps become Python loops
over the blocks and epochs (a block's window start is a Python int); its ``lax.cond`` rescue of a failed Cholesky solve is decided
on the host (one scalar read per solve). Products outside the kernels —
the residual update, later-epoch correlations, the small solves — are
plain ``torch`` contractions, as the reference leaves them to XLA.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.ops import cuda_ops

from . import mesh as mesh_lib


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """At-least-f32 accumulation dtype (f64 stays f64)."""
    return torch.promote_types(dtype, torch.float32)


def _corr(a: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """AᵀR with at-least-f32 accumulation — the correlation contraction
    shared by every BCD path. R is rounded to A's dtype first, as in the
    reference."""
    acc = _acc_dtype(a.dtype)
    return a.T.to(acc) @ r.to(a.dtype).to(acc)


def _psd_factor(gram: torch.Tensor, lam: float) -> torch.Tensor:
    """Cholesky factor of (gram + lam I) — loop-invariant across BCD epochs
    for a fixed block, so multi-epoch sweeps stash it next to the Gramian.
    ``gram`` may be a (batch, d, d) stack, factored in one batched call.
    A failed factorization is not raised here: its (non-finite or garbage)
    factor is caught by :func:`_solve_psd`'s acceptance check."""
    eye = torch.eye(gram.shape[-1], dtype=gram.dtype, device=gram.device)
    chol, _ = torch.linalg.cholesky_ex(gram + lam * eye)
    return chol


def _solve_psd(gram, rhs, lam: float, chol=None):
    """Solve (gram + lam I) x = rhs via Cholesky (gram PSD).

    Rank-deficient Gramians (fewer rows than block columns) with zero/tiny
    lam defeat the f32 Cholesky. Those solves rescue through a second
    Cholesky with a strong scale-relative jitter, and as a last resort a
    diagonal-preconditioned step; healthy Gramians keep the exact path.
    Acceptance is by the linear system's relative residual, not factor
    finiteness (a failed f32 factorization can also be finite garbage).
    Pass ``chol`` (from :func:`_psd_factor` on the same gram/lam) to skip
    the factorization.
    """
    d = gram.shape[0]
    if chol is None:
        chol = _psd_factor(gram, lam)
    sol = torch.cholesky_solve(rhs, chol)
    lin_res = gram @ sol + lam * sol - rhs
    ok = bool(
        torch.isfinite(sol).all()
        & (torch.linalg.norm(lin_res) <= 1e-2 * (torch.linalg.norm(rhs) + 1e-30))
    )
    if ok:
        return sol
    # 1e-3·(tr/d) keeps the condition number within f32 Cholesky's
    # reliable range (~1e6) while shrinking the fit by ~0.1%.
    mean_diag = torch.trace(gram) / d
    jitter = mean_diag * 1e-3 + lam
    eye = torch.eye(d, dtype=gram.dtype, device=gram.device)
    chol_j, _ = torch.linalg.cholesky_ex(gram + jitter * eye)
    sol_j = torch.cholesky_solve(rhs, chol_j)
    if bool(torch.isfinite(sol_j).all()):
        return sol_j
    return rhs / (mean_diag + lam + 1e-30)


def normal_equations_solve(A, B, lam: float = 0.0):
    """Exact least-squares / ridge solve via normal equations.

    A: (n, d) rows (zero-padding rows are harmless). B: (n, k). Returns (d, k).
    """
    A = as_tensor(A)
    B = as_tensor(B, A.device)
    return _solve_psd(A.T @ A, A.T @ B, float(lam))


# ---------------------------------------------------------------------------
# Block coordinate descent least squares
# ---------------------------------------------------------------------------


def _gram_cache_ok(num_iter: int, gram_bytes: int) -> bool:
    """Stash per-block Gramians across epochs only when the stash is small
    beside device memory (at most 1 GiB)."""
    return num_iter > 1 and gram_bytes <= (1 << 30)


def _mesh_bcd_step(mesh, lam: float):
    """Per-block BCD step for a row-sharded design matrix: (step,
    step_cached).

    Each shard's Gramian and correlation go through ``gram_corr_sym`` (one
    launch a shard; float64 blocks keep plain contractions), then one
    ``psum`` of both over the ``data`` axis: the explicit-collective form
    of the reference's per-partition Gramians + treeReduce (mlmatrix
    NormalEquations). The solve runs on the axis's first device; each
    shard's residual update is its own rows' product. Later epochs pass
    the stashed Gramian to ``step_cached``, which psums the correlation
    alone."""
    axis = mesh_lib.DATA_AXIS

    def gram_corr_body(a, r):
        if _acc_dtype(a.dtype) == torch.float32:
            return cuda_ops.gram_corr_sym(a, r.to(torch.float32))
        acc = _acc_dtype(a.dtype)
        return a.T.to(acc) @ a.to(acc), _corr(a, r)

    sharded_gram_corr = mesh_lib.shard_map(
        gram_corr_body, mesh, in_specs=(axis, axis), out_specs=(None, None))
    sharded_corr = mesh_lib.shard_map(
        lambda a, r: _corr(a, r), mesh, in_specs=(axis, axis), out_specs=None)
    residual_update = mesh_lib.shard_map(
        lambda a, r, dw: r - (a @ dw.to(a.dtype)).to(r.dtype), mesh,
        in_specs=(axis, axis, None), out_specs=axis)

    def finish(Ab, Wb, R, gram, corr):
        Wb = Wb.to(gram.dtype)
        Wb_new = _solve_psd(gram, corr + gram @ Wb, lam)
        return Wb_new, residual_update(Ab, R, Wb_new - Wb)

    def step(Ab, Wb, R):
        gram, corr = sharded_gram_corr(Ab, R)
        Wb_new, R_new = finish(Ab, Wb, R, gram, corr)
        return Wb_new, R_new, gram

    def step_cached(Ab, Wb, R, gram):
        """Later epochs: the Gramian is loop-invariant; only the
        correlation re-reads the sharded rows."""
        return finish(Ab, Wb, R, gram, sharded_corr(Ab, R))

    return step, step_cached


def bcd_least_squares(
    A_blocks: Sequence,
    B,
    lam: float = 0.0,
    num_iter: int = 1,
    mesh=None,
) -> List:
    """Block coordinate descent ridge regression over feature blocks.

    A_blocks: list of (n, d_b) tensors (feature-axis blocks of the design
    matrix). B: (n, k). Returns the list of per-block weights W_b, each
    (d_b, k), minimizing ``||B - Σ_b A_b W_b||² + λ Σ_b ||W_b||²``.

    The stepwise form: each block step is plain tensor code (the reference
    runs it as one jitted XLA step, not through a Pallas kernel, on one
    device). Loop-invariant per-block Gramians are stashed across epochs
    when the stash is small.

    ``mesh`` (more than one shard on ``data``): the blocks and B are rows
    sharded over the axis (:class:`~keystone_tpu_torch.parallel.mesh.
    ShardedRows`, zero-padded; plain tensors are sharded first), and each
    step is :func:`_mesh_bcd_step`'s. The weights come back on the axis's
    first device. The psum reassociates the one-device sums, so the
    weights are not bit-equal to the one-device fit's.
    """
    if mesh is not None and mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS) > 1:
        return _bcd_least_squares_mesh(A_blocks, B, float(lam), num_iter, mesh)
    B = as_tensor(B)
    k = B.shape[1]
    Ws = [torch.zeros((Ab.shape[1], k), dtype=B.dtype, device=B.device) for Ab in A_blocks]
    R = B
    gram_bytes = sum(
        int(a.shape[1]) ** 2 * _acc_dtype(as_tensor(a).dtype).itemsize
        for a in A_blocks
    )
    cache_grams = _gram_cache_ok(max(num_iter, 1), gram_bytes)
    grams: List = [None] * len(A_blocks)
    lam = float(lam)

    for _ in range(max(num_iter, 1)):
        for b, Ab in enumerate(A_blocks):
            Ab = as_tensor(Ab, B.device)
            gram = grams[b] if grams[b] is not None else Ab.T @ Ab
            rhs = Ab.T @ R + gram @ Ws[b]
            Wb_new = _solve_psd(gram, rhs, lam)
            R = R - Ab @ (Wb_new - Ws[b])
            Ws[b] = Wb_new
            if cache_grams:
                grams[b] = gram
    return Ws


def _bcd_least_squares_mesh(A_blocks, B, lam: float, num_iter: int, mesh) -> List:
    """:func:`bcd_least_squares` on a multi-device mesh."""
    def sharded(x):
        return x if isinstance(x, mesh_lib.ShardedRows) else mesh_lib.shard_rows(
            as_tensor(x), mesh)

    A_blocks = [sharded(a) for a in A_blocks]
    R = sharded(B).map(lambda r: r.clone())
    k = R.shape[1]
    dev = mesh.axis_devices(mesh_lib.DATA_AXIS)[0]
    Ws = [torch.zeros((Ab.shape[1], k), dtype=R.dtype, device=dev) for Ab in A_blocks]
    step, step_cached = _mesh_bcd_step(mesh, lam)
    gram_bytes = sum(int(a.shape[1]) ** 2 * _acc_dtype(a.dtype).itemsize for a in A_blocks)
    cache_grams = _gram_cache_ok(max(num_iter, 1), gram_bytes)
    grams: List = [None] * len(A_blocks)
    for _ in range(max(num_iter, 1)):
        for b, Ab in enumerate(A_blocks):
            if grams[b] is not None:
                Ws[b], R = step_cached(Ab, Ws[b], R, grams[b])
            else:
                Ws[b], R, gram = step(Ab, Ws[b], R)
                if cache_grams:
                    grams[b] = gram
    return Ws


def _residual_dtype(feat_dtype, label_dtype):
    """Residual/solve dtype: at least f32 (bf16 features still accumulate in
    f32), promoted to f64 when either operand is double."""
    return torch.promote_types(_acc_dtype(feat_dtype), _acc_dtype(label_dtype))


def _bcd_block_update(Ab, R, Wb, lam: float, gram=None, chol=None, sym: bool = True):
    """One Gauss-Seidel block update shared by the fused solvers.

    Solves (AbᵀAb + λI) Wb' = AbᵀR + (AbᵀAb) Wb and returns
    (R - Ab (Wb' - Wb), Wb', AbᵀAb, cholesky). The residual delta is
    accumulated in f32 regardless of the feature dtype so bf16 features
    never quantize the running residual. Pass ``gram`` (and ``chol``) to
    reuse the loop-invariant Gramian/factor — only the correlation then
    recomputes. The first-epoch Gramian + correlation of f32/bf16 blocks
    is a kernel (its plain version on the CPU): ``gram_corr_sym``, upper
    tiles only, or with ``sym=False`` ``gram_corr``, every tile in the
    reference — the reference's switch (in the port both wrappers launch
    the one upper-tile kernel and give the same bits); both fused solvers
    pass ``True``, as the
    reference's public callers do. f64 blocks keep plain contractions, as
    the reference keeps them on XLA.
    """
    feat_dtype = Ab.dtype
    acc_dtype = _acc_dtype(feat_dtype)
    if gram is None and acc_dtype == torch.float32:
        fn = cuda_ops.gram_corr_sym if sym else cuda_ops.gram_corr
        gram, corr = fn(Ab, R)
    else:
        if gram is None:
            gram = Ab.T.to(acc_dtype) @ Ab.to(acc_dtype)
        corr = _corr(Ab, R)
    if chol is None:
        chol = _psd_factor(gram, lam)
    rhs = corr + gram @ Wb
    Wb_new = _solve_psd(gram, rhs, lam, chol=chol)
    delta = Ab.to(acc_dtype) @ (Wb_new - Wb).to(feat_dtype).to(acc_dtype)
    return R - delta, Wb_new, gram, chol


def bcd_least_squares_fused(
    A_stack,
    B,
    lam: float = 0.0,
    num_iter: int = 1,
):
    """Block coordinate descent over equal-sized stacked blocks.

    A_stack: (num_blocks, n, d_b) stacked feature blocks — may be bfloat16,
    in which case the products accumulate in float32 (the solve and
    residual stay float32). The (epochs × blocks) Gauss-Seidel sweep runs
    as a host loop; the first epoch computes each block's Gramian and
    correlation with the ``gram_corr_sym`` kernel and, for multi-epoch
    sweeps whose stash fits (``_gram_cache_ok``), stashes the Gramian and
    its Cholesky factor so later epochs pay only the correlation, the two
    triangular solves and the residual update.
    """
    A_stack = as_tensor(A_stack)
    B = as_tensor(B, A_stack.device)
    B = B.to(_residual_dtype(A_stack.dtype, B.dtype))
    if A_stack.dtype != torch.bfloat16:
        # Unify operand dtypes up front (except the intentional bf16 feature
        # layout) so the block updates run entirely in the residual dtype.
        A_stack = A_stack.to(B.dtype)
    nb, _, db = A_stack.shape
    k = B.shape[1]
    W = [torch.zeros((db, k), dtype=B.dtype, device=B.device) for _ in range(nb)]
    acc_itemsize = _acc_dtype(A_stack.dtype).itemsize
    # x2: the stash holds Gramians AND their Cholesky factors.
    cache_stash = _gram_cache_ok(int(num_iter), 2 * nb * db * db * acc_itemsize)
    lam = float(lam)

    R = B
    stash: List = [None] * nb
    for epoch in range(max(int(num_iter), 1)):
        for b in range(nb):
            gram, chol = stash[b] if stash[b] is not None else (None, None)
            R, W[b], gram, chol = _bcd_block_update(
                A_stack[b], R, W[b], lam, gram=gram, chol=chol
            )
            if epoch == 0 and cache_stash:
                stash[b] = (gram, chol)
    return torch.stack(W)


def _strided_update(F, col_start: int, block: int, R, Wb, lam: float,
                    gram=None, chol=None):
    """Block update whose every access to F reads the column window
    ``F[:, col_start:col_start+block]`` in place through the kernels — no
    (n, block) copy of the window per block, which would be pure memory
    traffic. Pass ``gram`` and ``chol`` to reuse the stashed Gramian and
    factor; only the correlation then recomputes."""
    if gram is None:
        gram = cuda_ops.block_gram_sym(F, col_start, block)
    corr = cuda_ops.block_corr(F, col_start, block, R)
    if chol is None:
        chol = _psd_factor(gram, lam)
    rhs = corr + gram @ Wb
    Wb_new = _solve_psd(gram, rhs, lam, chol=chol)
    R_new = cuda_ops.block_residual_update(
        F, col_start, block, (Wb_new - Wb).to(F.dtype), R
    )
    return R_new, Wb_new, gram, chol


def bcd_least_squares_fused_flat(
    F,
    B,
    block_size: int,
    lam: float = 0.0,
    num_iter: int = 1,
    return_residual: bool = False,
):
    """Block coordinate descent over a *flat* (n, d) feature matrix.

    Functionally identical to :func:`bcd_least_squares_fused` on the column
    blocks ``F[:, i*block : (i+1)*block]``, but the features live in one
    buffer: at large n the stacked layout cannot be produced without a
    second full-size copy, which is the difference between fitting in
    device memory and not. Multi-epoch runs stash each block's Gramian and
    Cholesky factor when the stash is small beside device memory
    (``_gram_cache_ok``), so later epochs pay only the correlation, the
    two triangular solves and the residual update.

    Float32 and bfloat16 features that pass ``cuda_ops.strided_gram_ok``
    take the column-window kernels. Anything else (float64 features) takes
    the generic block update on a window view, as the reference does when
    its guard says no. Returns the (nb, block, k) weight stack (and the
    final residual when ``return_residual``).
    """
    F = as_tensor(F)
    B = as_tensor(B, F.device)
    B = B.to(_residual_dtype(F.dtype, B.dtype))
    if F.dtype != torch.bfloat16:
        F = F.to(B.dtype)
    n, d = F.shape
    if d % block_size != 0:
        raise ValueError(f"feature dim {d} not divisible by block {block_size}")
    nb = d // block_size
    k = B.shape[1]
    acc_itemsize = _acc_dtype(F.dtype).itemsize
    # x2: the stash holds Gramians AND their Cholesky factors.
    cache_grams = _gram_cache_ok(
        int(num_iter), 2 * nb * block_size * block_size * acc_itemsize
    )
    strided = _acc_dtype(F.dtype) == torch.float32 and cuda_ops.strided_gram_ok(
        F, block_size
    )
    lam = float(lam)
    W = [torch.zeros((block_size, k), dtype=B.dtype, device=B.device) for _ in range(nb)]
    stash: List = [None] * nb
    R = B
    for epoch in range(max(int(num_iter), 1)):
        for bi in range(nb):
            gram, chol = stash[bi] if stash[bi] is not None else (None, None)
            start = bi * block_size
            if strided:
                R, W[bi], gram, chol = _strided_update(
                    F, start, block_size, R, W[bi], lam, gram=gram, chol=chol
                )
            else:
                R, W[bi], gram, chol = _bcd_block_update(
                    F[:, start:start + block_size], R, W[bi], lam, gram=gram, chol=chol
                )
            if epoch == 0 and cache_grams:
                stash[bi] = (gram, chol)
    W_stack = torch.stack(W)
    return (W_stack, R) if return_residual else W_stack


# ---------------------------------------------------------------------------
# TSQR
# ---------------------------------------------------------------------------


def tsqr_r(A, mesh=None) -> torch.Tensor:
    """R factor of a tall-skinny QR (the analog of mlmatrix ``TSQR().qrR``),
    computed shard-locally then combined: each data shard's local R, then
    a QR of their stack on the axis's first device. A direct QR when the
    rows are not sharded (``A`` a plain tensor and no ``mesh``). Sign
    convention: R has a non-negative diagonal."""
    if isinstance(A, mesh_lib.ShardedRows):
        mesh = mesh or A.mesh
    if mesh is None or mesh_lib.DATA_AXIS not in mesh.shape:
        r = torch.linalg.qr(as_tensor(A), mode="r")[1]
    else:
        locals_ = mesh_lib.shard_map(
            lambda a: torch.linalg.qr(a, mode="r")[1], mesh,
            in_specs=mesh_lib.DATA_AXIS, out_specs=mesh_lib.DATA_AXIS,
        )(A if isinstance(A, mesh_lib.ShardedRows) else mesh_lib.shard_rows(as_tensor(A), mesh))
        r = torch.linalg.qr(locals_.gather(), mode="r")[1]
    signs = torch.sign(torch.diagonal(r))
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return r * signs[:, None]
