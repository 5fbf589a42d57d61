"""The mesh solvers run the same way on a one-process mesh and on one
process of a multi-process mesh (tests/test_torch_multihost.py): every
input is made from seeded numpy draws as a global array, each process
keeps its own shards (``shard_rows``), and every sharded output is read
back whole through ``process_allgather``. Imports no JAX: the worker
processes import it."""

import numpy as np
import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.ops import stats
from keystone_tpu_torch.ops.learning import lbfgs, streaming_ls
from keystone_tpu_torch.parallel import linalg, ring, streaming
from keystone_tpu_torch.parallel import mesh as mesh_lib

N, N_TRUE, D_IN, D_FEAT, K, BS = 96, 90, 5, 16, 3, 8


def _whole(sharded) -> np.ndarray:
    """A sharded array's global rows, on every process."""
    local = torch.cat([s.cpu() for s in sharded.shards]).numpy()
    return mesh_lib.process_allgather(local).reshape((-1,) + local.shape[1:])


def _chunks(n=1000, d=24, w=6, k=2, c=64):
    rng = np.random.default_rng(0)
    idx = rng.integers(0, d, size=(n, w)).astype(np.int32)
    idx[rng.random((n, w)) < 0.2] = -1
    val = rng.normal(size=(n, w)).astype(np.float32)
    y = rng.normal(size=(n, k)).astype(np.float32)
    nchunks = -(-n // c)
    pad = nchunks * c - n
    ops = (np.pad(idx, ((0, pad), (0, 0)), constant_values=-1).reshape(nchunks, c, w),
           np.pad(val, ((0, pad), (0, 0))).reshape(nchunks, c, w),
           np.pad(y, ((0, pad), (0, 0))).reshape(nchunks, c, k))
    return n, d, k, nchunks, tuple(torch.from_numpy(o) for o in ops)


def run_solvers(mesh) -> dict:
    """Every mesh solver and ring primitive on ``mesh``'s ``data`` axis;
    each output as a numpy array (its global rows where it is sharded)."""
    rng = np.random.default_rng(11)
    X = rng.normal(size=(N, D_IN)).astype(np.float32)
    X[N_TRUE:] = 0
    Y = rng.normal(size=(N, K)).astype(np.float32)
    Y[N_TRUE:] = 0
    Wrf = (rng.normal(size=(D_FEAT, D_IN)) * 0.3).astype(np.float32)
    brf = rng.uniform(0, 2 * np.pi, size=D_FEAT).astype(np.float32)
    Xs, Ys = mesh_lib.shard_rows(X, mesh), mesh_lib.shard_rows(Y, mesh)
    out = {}
    bank = streaming_ls.CosineBankFeaturize(torch.from_numpy(Wrf), torch.from_numpy(brf))
    for i, t in enumerate(streaming.gram_stats_mesh(Xs, Ys, bank, D_FEAT, 16, mesh,
                                                    n_true=N_TRUE, moments=True)):
        out[f"gram_stats_{i}"] = t.numpy()
    W, M, ymean = streaming.streaming_block_bcd_mesh(
        Xs, Ys, torch.from_numpy(Wrf), torch.from_numpy(brf), block_size=BS, lam=1e-2,
        num_iter=2, mesh=mesh, n_true=N_TRUE, center=True)
    out.update(block_W=W.numpy(), block_M=M.numpy(), block_ymean=ymean.numpy())
    Ws = linalg.bcd_least_squares([Xs], Ys, lam=1e-2, num_iter=2, mesh=mesh)
    out["bcd_W"] = Ws[0].numpy()
    out["tsqr_r"] = linalg.tsqr_r(Xs, mesh).numpy()
    scaler = stats.StandardScaler().fit(Dataset(Xs, n=N_TRUE, mesh=mesh))
    out.update(scaler_mean=scaler.mean.numpy(), scaler_std=scaler.std.numpy())
    out["ring_attention"] = _whole(ring.ring_attention(Xs, Xs, Ys, mesh=mesh, causal=True,
                                                       n_valid=N_TRUE))
    out["ring_gram"] = _whole(ring.ring_gram(mesh_lib.shard_rows(X[:, :4], mesh), mesh=mesh))
    out["ring_pairwise"] = _whole(ring.ring_pairwise_gaussian(Xs, 0.2, mesh=mesh))
    n, d, k, nchunks, ops = _chunks()
    W, loss = lbfgs.run_lbfgs_gram_streamed(
        lbfgs._resident_chunk_fn, nchunks, d, k, operands=ops, max_chunks_per_dispatch=2,
        mesh=mesh, n=n, device="cpu", lam=0.1, num_iterations=30, convergence_tol=1e-8)
    out.update(lbfgs_W=W.numpy(), lbfgs_loss=np.asarray(float(loss)))
    return out
