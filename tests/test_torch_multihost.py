"""The multi-process mesh, exercised for real: twins of
tests/test_multihost.py's three cases, plus the runtime's no-op and errors.

Two OS processes join one gloo process group through a ``file://`` store in
``tmp_path`` (no port, so xdist workers cannot collide) and build a hybrid
mesh whose DCN axis spans them, each process holding 2 CPU shards. Each
worker writes its result to ``tmp_path``; the pytest process compares it
with the reference run in-process, with the port's one-process mesh of the
same shards, and with the worker's own invariants.

Tolerances:
  - the KRR weight stack and the ring apply: the one-process 4-shard mesh's
    bits (the collectives add every shard's partial in global shard order,
    whatever process holds it); the reference's ``_krr_fit_fused`` within
    2e-4 (its own multihost test's);
  - the normal-equations solve: within 1e-9 of float64 numpy (the
    reference's, in float64), and the one-process mesh's bits;
  - Stupid Backoff: within 1e-12 of the one-host fit (the reference's);
  - every other mesh solver and ring primitive
    (tests/_torch_multihost_util.py): the one-process 4-shard mesh's bits.
"""

import datetime
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keystone_tpu.ops.learning import kernel as jkernel
from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.ops.learning import kernel as tkernel
from keystone_tpu_torch.parallel import linalg as tlinalg
from keystone_tpu_torch.parallel import mesh as tmesh

REPO = Path(__file__).resolve().parents[1]

# Each case's limit: a gloo pair joins and runs in a few seconds here.
WORKER_TIMEOUT_S = 120

KRR_N, KRR_D, KRR_K, KRR_BS, KRR_EPOCHS = 256, 8, 3, 64, 2
KRR_GAMMA, KRR_LAM = 0.05, 0.2
TEST_N = 100  # the ring apply's rows: 25 a shard

_PRELUDE = textwrap.dedent(
    """
    import sys
    import numpy as np
    import torch

    from keystone_tpu_torch.parallel import mesh as mesh_lib

    store, pid, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    mesh_lib.init_distributed(f"file://{store}", num_processes=2, process_id=pid,
                              backend="gloo", timeout_s=60)
    import torch.distributed as dist

    assert dist.get_world_size() == 2 and dist.get_rank() == pid
    """
)

_SOLVE_WORKER = _PRELUDE + textwrap.dedent(
    """
    from keystone_tpu_torch.parallel import linalg

    # data across processes (DCN), model within one (ICI).
    mesh = mesh_lib.make_hybrid_mesh((1, 2), (2, 1), (mesh_lib.DATA_AXIS, mesh_lib.MODEL_AXIS),
                                     devices=["cpu", "cpu"])
    assert dict(mesh.shape) == {"data": 2, "model": 2}, dict(mesh.shape)
    assert mesh.local_shards(mesh_lib.DATA_AXIS) == [pid]
    try:
        mesh_lib.make_hybrid_mesh((2,), (4,), (mesh_lib.DATA_AXIS,))
        raise AssertionError("a DCN product of 4 on 2 processes built a mesh")
    except ValueError as e:
        dcn_error = str(e)

    rng = np.random.default_rng(0)
    A = rng.normal(size=(32, 6))
    B = rng.normal(size=(32, 3))
    A_sh = mesh_lib.shard_local_rows(torch.from_numpy(A[pid * 16:(pid + 1) * 16]), mesh)
    B_sh = mesh_lib.shard_local_rows(torch.from_numpy(B[pid * 16:(pid + 1) * 16]), mesh)
    W = linalg.normal_equations_solve(A_sh, B_sh, lam=1e-3)
    assert W.dtype == torch.float64
    np.savez(out, W=W.numpy(), dcn_error=np.array(dcn_error))
    print(f"proc {pid} OK")
    """
)

_LM_WORKER = _PRELUDE + textwrap.dedent(
    """
    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.ops.nlp import (
        NGram,
        NGramsFeaturizer,
        ShardedStupidBackoffModel,
        StupidBackoffEstimator,
        pack_ngram_pairs,
        partition_ngram_pairs,
        unpack_ngram_pairs,
    )

    # Each process holds half of the raw (ngram, count) stream.
    rng = np.random.default_rng(7)
    sents = [rng.integers(1, 40, size=12).tolist() for _ in range(30)]
    feats = NGramsFeaturizer([2, 3])
    all_pairs, unigrams = [], {}
    for s in sents:
        for w in s:
            unigrams[w] = unigrams.get(w, 0) + 1
        for g in feats.apply(s):
            all_pairs.append((NGram(g), 1))
    local_pairs = all_pairs[pid::2]

    # The counts cross the process boundary as one int64 array a process.
    packed = pack_ngram_pairs(local_pairs)
    m = (len(all_pairs) + 1) // 2
    if packed.shape[0] < m:
        packed = np.vstack([packed, np.zeros((m - packed.shape[0], 2), dtype=np.int64)])
    gathered = mesh_lib.process_allgather(packed)
    assert gathered.shape == (2, m, 2) and gathered.dtype == np.int64, gathered.shape
    pairs_all = []
    for part in gathered:
        pairs_all.extend(unpack_ngram_pairs(part[part[:, 1] > 0]))

    parts = partition_ngram_pairs(pairs_all, 2)
    est = StupidBackoffEstimator(unigrams)
    my_model = est.fit(Dataset.of(parts[pid]))
    full_model = est.fit(Dataset.of(all_pairs))
    assert len(my_model.scores) == len(parts[pid])
    worst = max(abs(score - full_model.scores[g]) for g, score in my_model.scores.items())
    sizes = mesh_lib.process_allgather(np.array([len(my_model.scores)]))
    sharded = ShardedStupidBackoffModel([est.fit(Dataset.of(p)) for p in parts])
    serve_worst = max(abs(sharded.score(g) - full_model.score(g))
                      for g in list(full_model.scores)[:50])
    np.savez(out, worst=worst, serve_worst=serve_worst, sizes=sizes.reshape(-1),
             table=len(full_model.scores))
    print(f"lm proc {pid} OK")
    """
)

_KRR_WORKER = _PRELUDE + textwrap.dedent(
    f"""
    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.ops.learning.kernel import (
        GaussianKernelGenerator,
        KernelRidgeRegression,
    )

    # The data axis spans 2 processes x 2 shards: the sweep's all_gather
    # and each step's psum cross the process boundary, and the ring apply's
    # rotation goes point to point between them.
    mesh = mesh_lib.make_hybrid_mesh((2,), (2,), (mesh_lib.DATA_AXIS,), devices=["cpu", "cpu"])
    assert dict(mesh.shape) == {{"data": 4}} and mesh.local_shards("data") == [2 * pid, 2 * pid + 1]

    n, d, k, bs, epochs = {KRR_N}, {KRR_D}, {KRR_K}, {KRR_BS}, {KRR_EPOCHS}
    rng = np.random.default_rng(3)
    X = rng.normal(size=(n, d)).astype(np.float32)
    Y = rng.normal(size=(n, k)).astype(np.float32)
    half = slice(pid * (n // 2), (pid + 1) * (n // 2))
    data = Dataset(mesh_lib.shard_local_rows(X[half], mesh), n=n, mesh=mesh)
    labels = Dataset(mesh_lib.shard_local_rows(Y[half], mesh), n=n, mesh=mesh)
    try:
        data.array.gather()
        raise AssertionError("a multi-process array gathered")
    except RuntimeError as e:
        gather_error = str(e)
    krr = KernelRidgeRegression(GaussianKernelGenerator({KRR_GAMMA}), {KRR_LAM}, bs, epochs)
    model = krr.fit(data, labels)
    stack = torch.stack([w for w in model.w_locals]).numpy()

    Xt = np.random.default_rng(4).normal(size=({TEST_N}, d)).astype(np.float32)
    test = Dataset(mesh_lib.shard_local_rows(Xt[pid * 50:(pid + 1) * 50], mesh), n={TEST_N},
                   mesh=mesh)
    pred = model.batch_apply(test).array
    local = np.concatenate([s.numpy() for s in pred.shards])
    every = mesh_lib.process_allgather(local).reshape(-1, k)
    np.savez(out, stack=stack, pred=every, gather_error=np.array(gather_error))
    print(f"krr proc {{pid}} OK")
    """
)

_SOLVERS_WORKER = _PRELUDE + textwrap.dedent(
    """
    sys.path.insert(0, sys.argv[4])
    import _torch_multihost_util as util

    mesh = mesh_lib.make_hybrid_mesh((2,), (2,), (mesh_lib.DATA_AXIS,), devices=["cpu", "cpu"])
    np.savez(out, **util.run_solvers(mesh))
    print(f"solvers proc {pid} OK")
    """
)


def _run_two_workers(tmp_path, source: str, ok_marker: str):
    script = tmp_path / "worker.py"
    script.write_text(source)
    store = tmp_path / "store"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["GLOO_SOCKET_IFNAME"] = "lo"
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(key, None)
    outs = [tmp_path / f"out{pid}.npz" for pid in range(2)]
    procs = [
        subprocess.Popen([sys.executable, str(script), str(store), str(pid), str(outs[pid]),
                          str(Path(__file__).resolve().parent)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                         cwd=str(tmp_path))
        for pid in range(2)
    ]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, text) in enumerate(zip(procs, texts)):
        assert p.returncode == 0, f"proc {pid} failed:\n{text}"
        assert ok_marker.format(pid=pid) in text
    return [dict(np.load(o)) for o in outs]


def _krr_problem():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(KRR_N, KRR_D)).astype(np.float32)
    Y = rng.normal(size=(KRR_N, KRR_K)).astype(np.float32)
    return X, Y


def test_two_process_distributed_solve(tmp_path):
    res = _run_two_workers(tmp_path, _SOLVE_WORKER, "proc {pid} OK")
    rng = np.random.default_rng(0)
    A = rng.normal(size=(32, 6))
    B = rng.normal(size=(32, 3))
    want = np.linalg.solve(A.T @ A + 1e-3 * np.eye(6), A.T @ B)
    one = tmesh.make_mesh((2,), devices=["cpu"] * 2)
    W_one = tlinalg.normal_equations_solve(tmesh.shard_rows(torch.from_numpy(A), one),
                                           tmesh.shard_rows(torch.from_numpy(B), one),
                                           lam=1e-3).numpy()
    for r in res:
        np.testing.assert_allclose(r["W"], want, atol=1e-9)
        np.testing.assert_array_equal(r["W"], W_one)
        assert "make 4 processes" in str(r["dcn_error"]) and "has 2" in str(r["dcn_error"])


def test_two_process_stupid_backoff_counts(tmp_path):
    res = _run_two_workers(tmp_path, _LM_WORKER, "lm proc {pid} OK")
    for r in res:
        assert float(r["worst"]) < 1e-12
        assert float(r["serve_worst"]) < 1e-12
        # The two partitions tile the global table exactly.
        assert int(r["sizes"].sum()) == int(r["table"])
    np.testing.assert_array_equal(res[0]["sizes"], res[1]["sizes"])


def test_two_process_fused_krr_fit(tmp_path):
    """The mesh sweep with its data axis over two processes gives the
    one-process 4-shard mesh's weight stack bit for bit, the reference's
    fused sweep within 2e-4, and the ring apply across the processes the
    one-process ring's predictions bit for bit."""
    res = _run_two_workers(tmp_path, _KRR_WORKER, "krr proc {pid} OK")
    X, Y = _krr_problem()
    one = tmesh.make_mesh((4,), devices=["cpu"] * 4)
    est = tkernel.KernelRidgeRegression(tkernel.GaussianKernelGenerator(KRR_GAMMA), KRR_LAM,
                                        KRR_BS, KRR_EPOCHS)
    model = est.fit(TDataset.of(torch.from_numpy(X)).shard(one),
                    TDataset.of(torch.from_numpy(Y)).shard(one))
    want_stack = torch.stack(model.w_locals).numpy()
    Xt = np.random.default_rng(4).normal(size=(TEST_N, KRR_D)).astype(np.float32)
    want_pred = model.batch_apply(TDataset.of(torch.from_numpy(Xt)).shard(one)).to_numpy()

    nb = KRR_N // KRR_BS
    order = jnp.asarray(np.tile(np.arange(nb, dtype=np.int32), KRR_EPOCHS))
    _, ref_stack = jkernel._krr_fit_fused(jnp.asarray(X), jnp.asarray(Y), order, KRR_GAMMA,
                                          KRR_LAM, KRR_BS, KRR_N, nb, False)
    for r in res:
        np.testing.assert_array_equal(r["stack"], want_stack)
        np.testing.assert_allclose(r["stack"], np.asarray(ref_stack), atol=2e-4)
        np.testing.assert_array_equal(r["pred"][:TEST_N], want_pred)
        assert "process_allgather" in str(r["gather_error"])


def test_two_process_mesh_solvers_keep_the_one_process_bits(tmp_path):
    """Every mesh solver and ring primitive on a data axis over two
    processes of two shards gives the one-process 4-shard mesh's bits: the
    psum-ending shard_map programs (the streamed fold's statistics, the
    mesh BCD, TSQR, the scaler's sums), the block-streamed sweep, the ring
    rotations across the process boundary and the gram-streamed fold."""
    from tests._torch_multihost_util import run_solvers

    res = _run_two_workers(tmp_path, _SOLVERS_WORKER, "solvers proc {pid} OK")
    want = run_solvers(tmesh.make_mesh((4,), devices=["cpu"] * 4))
    for r in res:
        assert sorted(r) == sorted(want)
        for key, value in want.items():
            np.testing.assert_array_equal(r[key], value, err_msg=key)


class TestRuntime:
    def test_init_distributed_without_a_coordinator_is_a_no_op(self, monkeypatch):
        import torch.distributed as dist

        for key in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
            monkeypatch.delenv(key, raising=False)
        tmesh.init_distributed()
        assert not dist.is_initialized()
        # torchrun's variables, but not all three: still single-process.
        monkeypatch.setenv("MASTER_ADDR", "localhost")
        tmesh.init_distributed()
        assert not dist.is_initialized()

    def test_init_distributed_errors(self, tmp_path):
        with pytest.raises(ValueError, match="num_processes and process_id"):
            tmesh.init_distributed(f"file://{tmp_path}/store")
        with pytest.raises(ValueError, match="outside a group of 2"):
            tmesh.init_distributed(f"file://{tmp_path}/store", num_processes=2, process_id=2)

    def test_a_missing_peer_fails_within_the_timeout(self, tmp_path):
        import time

        import torch.distributed as dist

        t0 = time.perf_counter()
        with pytest.raises(RuntimeError):
            tmesh.init_distributed(f"file://{tmp_path}/store", num_processes=2, process_id=0,
                                   backend="gloo", timeout_s=1)
        assert time.perf_counter() - t0 < 30
        assert not dist.is_initialized()
        assert tmesh.DIST_TIMEOUT_S <= 60

    def test_dcn_axes_need_a_process_group(self):
        with pytest.raises(ValueError, match=r"DCN axes \(2, 1\) span 2 processes"):
            tmesh.make_hybrid_mesh((4, 1), (2, 1), ("data", "model"))
        m = tmesh.make_hybrid_mesh((2, 2), (1, 1), ("data", "model"), devices=["cpu"] * 4)
        assert dict(m.shape) == {"data": 2, "model": 2} and not m.is_multi_process

    def test_a_one_process_mesh_owns_every_shard(self):
        m = tmesh.make_mesh((4,), devices=["cpu"] * 4)
        assert m.local_shards("data") == [0, 1, 2, 3] and m.group("data") is None
        x = tmesh.shard_rows(torch.arange(8.0)[:, None], m)
        assert x.indices == (0, 1, 2, 3) and x.group is None
        np.testing.assert_array_equal(x.gather().numpy().ravel(), np.arange(8.0))
        np.testing.assert_array_equal(tmesh.process_allgather(np.arange(3)), [[0, 1, 2]])

    def test_multi_process_layout_and_refusals(self, monkeypatch):
        # A mesh owned by two ranks, seen from rank 1, without a group: the
        # layout, the local shards and the refusal to gather need none.
        grid = np.array([torch.device("cpu")] * 4, dtype=object)
        monkeypatch.setattr(tmesh, "_process_rank", lambda: 1)
        m = tmesh.Mesh(grid, ("data",), owners=[0, 0, 1, 1])
        assert m.is_multi_process and m.local_shards("data") == [2, 3]
        monkeypatch.setattr(tmesh.ShardGroup, "of",
                            staticmethod(lambda owners, rank: tmesh.ShardGroup(tuple(owners),
                                                                               rank)))
        x = tmesh.shard_rows(torch.arange(8.0)[:, None], m)
        assert x.indices == (2, 3) and x.num_shards == 4 and tuple(x.shape) == (8, 1)
        np.testing.assert_array_equal(torch.cat(x.shards).numpy().ravel(), [4, 5, 6, 7])
        with pytest.raises(RuntimeError, match="process_allgather"):
            x.gather()
        with pytest.raises(RuntimeError, match="process_allgather"):
            TDataset(x, n=8, mesh=m).to_numpy()
        y = tmesh.shard_local_rows(torch.arange(4.0)[:, None], m)
        assert y.indices == (2, 3)
        assert datetime.timedelta(seconds=tmesh.DIST_TIMEOUT_S).total_seconds() > 0
