"""The mesh-sharded streamed gram fold (``run_lbfgs_gram_streamed(mesh=)``:
each device folds its own contiguous chunks, one psum a fit) and the
``tools/multichip.py`` runner, ported from tests/test_multichip.py's
``TestMeshFoldParity`` and ``TestMultichipRunner``. The port's fold runs
on an 8-shard CPU mesh and is held against its own one-device fold and
against the JAX package's mesh fold on its 8-device CPU mesh
(tests/conftest.py forces 8 host devices).

Inputs: the reference tests' padded-COO problem, from the same seeded
numpy draws, float32 on both sides.

Tolerances and why:
  - mesh fold against the one-device fold in the port: the reference
    test's ``PARITY_TOL`` (3.43e-7 max |dW|), the same arithmetic
    reassociated (per-device partial carries and one reduction);
  - the port's mesh fold against the reference's: the same bound; the
    final losses 1e-5 relative, as the reference test holds its own.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keystone_tpu import obs as jobs
from keystone_tpu.obs import tracer as jtracer_mod
from keystone_tpu.ops.learning import lbfgs as jl
from keystone_tpu.parallel import mesh as jmesh
from keystone_tpu_torch import obs as tobs
from keystone_tpu_torch.obs import tracer as ttracer_mod
from keystone_tpu_torch.ops import cuda_ops
from keystone_tpu_torch.ops.learning import lbfgs as tl
from keystone_tpu_torch.parallel import mesh as tmesh

PARITY_TOL = 3.43e-07
CPU8 = ["cpu"] * 8


def _coo_problem(n=1000, d=24, w=6, k=2, c=64, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(n, w)).astype(np.int32)
    idx[rng.random((n, w)) < 0.2] = -1
    val = rng.normal(size=(n, w)).astype(np.float32)
    Y = rng.normal(size=(n, k)).astype(np.float32)
    nchunks = -(-n // c)
    pad = nchunks * c - n
    operands = (
        np.pad(idx, ((0, pad), (0, 0)), constant_values=-1).reshape(nchunks, c, w),
        np.pad(val, ((0, pad), (0, 0))).reshape(nchunks, c, w),
        np.pad(Y, ((0, pad), (0, 0))).reshape(nchunks, c, k),
    )
    return n, d, k, nchunks, c, w, operands


_KW = dict(lam=0.1, num_iterations=30, convergence_tol=1e-8)


def _clamped(cid, idx_t, val_t, y_t):
    # The one-device segmented fold hands ids past the last chunk to the
    # chunk function (and zeroes what it returns).
    cid = min(int(cid), int(idx_t.shape[0]) - 1)
    return idx_t[cid], val_t[cid], y_t[cid]


def _ops(operands):
    return tuple(torch.from_numpy(o) for o in operands)


def _one_device(nchunks, d, k, operands, n):
    return tl.run_lbfgs_gram_streamed(_clamped, nchunks, d, k, operands=_ops(operands),
                                      max_chunks_per_dispatch=4, n=n, device="cpu", **_KW)


def _maxabs(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


class TestMeshFoldParity:
    def test_resident_mesh_fold_matches_single_device(self, monkeypatch):
        n, d, k, nchunks, c, _, operands = _coo_problem()
        rows = []
        real = cuda_ops.gram_corr_sym_acc

        def counting(G, AtY, slab, Yc, **kw):
            rows.append(int(slab.shape[0]))
            return real(G, AtY, slab, Yc, **kw)

        monkeypatch.setattr(cuda_ops, "gram_corr_sym_acc", counting)
        W1, loss1 = _one_device(nchunks, d, k, operands, n)
        rows.clear()
        W8, loss8 = tl.run_lbfgs_gram_streamed(
            tl._resident_chunk_fn, nchunks, d, k, operands=_ops(operands),
            max_chunks_per_dispatch=2, mesh=tmesh.make_mesh((8,), devices=CPU8), n=n,
            device="cpu", **_KW)
        jW8, jloss8 = jl.run_lbfgs_gram_streamed(
            jl._resident_chunk_fn, nchunks, d, k, operands=operands,
            max_chunks_per_dispatch=2, mesh=jmesh.make_mesh(), n=n, val_dtype=jnp.float32,
            **_KW)
        assert _maxabs(W1, W8) <= PARITY_TOL
        assert _maxabs(W8, jW8) <= PARITY_TOL
        np.testing.assert_allclose(float(loss1), float(loss8), rtol=1e-5)
        np.testing.assert_allclose(float(loss8), float(jloss8), rtol=1e-5)
        # 16 chunks over 8 devices, 2 each, one segment: every device folds
        # its two chunks, one kernel call a chunk.
        assert rows == [c] * 16

    def test_2d_mesh_folds_on_data_axis_only(self):
        # Model-axis replicas hold identical shards; the fold must not
        # count them twice (the psum runs over data only).
        n, d, k, nchunks, _, _, operands = _coo_problem(seed=1)
        W1, _ = _one_device(nchunks, d, k, operands, n)
        mesh42 = tmesh.make_mesh((4, 2), (tmesh.DATA_AXIS, tmesh.MODEL_AXIS), devices=CPU8)
        W42, _ = tl.run_lbfgs_gram_streamed(
            tl._resident_chunk_fn, nchunks, d, k, operands=_ops(operands),
            max_chunks_per_dispatch=2, mesh=mesh42, mesh_axis=tmesh.DATA_AXIS, n=n,
            device="cpu", **_KW)
        jW42, _ = jl.run_lbfgs_gram_streamed(
            jl._resident_chunk_fn, nchunks, d, k, operands=operands,
            max_chunks_per_dispatch=2,
            mesh=jmesh.make_mesh((4, 2), (jmesh.DATA_AXIS, jmesh.MODEL_AXIS)),
            mesh_axis=jmesh.DATA_AXIS, n=n, val_dtype=jnp.float32, **_KW)
        assert _maxabs(W1, W42) <= PARITY_TOL
        assert _maxabs(W42, jW42) <= PARITY_TOL

    def test_streamed_per_lane_sources_match_and_tag_devices(self):
        n, d, k, nchunks, c, w, operands = _coo_problem()
        idx_t, val_t, y_t = operands
        m, seg = 8, 2
        cpd = -(-nchunks // m)
        num_local_segs = -(-cpd // seg)

        def mk_source(j):
            def load(s):
                sl_idx = np.full((seg, c, w), -1, np.int32)
                sl_val = np.zeros((seg, c, w), np.float32)
                sl_y = np.zeros((seg, c, k), np.float32)
                for r in range(seg):
                    g = j * cpd + s * seg + r
                    if g < nchunks:
                        sl_idx[r], sl_val[r], sl_y[r] = idx_t[g], val_t[g], y_t[g]
                return sl_idx, sl_val, sl_y

            return (load, num_local_segs)

        W1, _ = _one_device(nchunks, d, k, operands, n)
        with tobs.tracing() as t:
            Ws, _ = tl.run_lbfgs_gram_streamed(
                tl._resident_chunk_fn, nchunks, d, k,
                segment_source=[mk_source(j) for j in range(m)],
                max_chunks_per_dispatch=seg, mesh=tmesh.make_mesh((8,), devices=CPU8), n=n,
                device="cpu", **_KW)
        assert _maxabs(W1, Ws) <= PARITY_TOL
        # Per-device evidence: every read lane read.d0..read.d7 carried
        # tasks, and the fold spans carry the device group's tag.
        lanes = {(s.get("args") or {}).get("lane") for s in t.events
                 if s.get("type") == "span" and s["name"] == "runtime.task"}
        assert {f"read.d{j}" for j in range(m)} <= lanes, lanes
        folds = [s for s in t.events if s.get("type") == "span" and s["name"] == "fold.segment"]
        assert folds
        assert all((s.get("args") or {}).get("device") == "data[0-7]"
                   and (s.get("args") or {}).get("num_devices") == m for s in folds), folds[0]

    def test_mesh_path_refuses_checkpoint(self):
        from keystone_tpu_torch.data.durable import CheckpointSpec

        n, d, k, nchunks, _, _, operands = _coo_problem()
        with pytest.raises(ValueError, match="checkpoint"):
            tl.run_lbfgs_gram_streamed(
                tl._resident_chunk_fn, nchunks, d, k, operands=_ops(operands),
                max_chunks_per_dispatch=2, mesh=tmesh.make_mesh((8,), devices=CPU8), n=n,
                checkpoint=CheckpointSpec("/nonexistent-checkpoints", every_segments=4),
                device="cpu", **_KW)


class TestMultichipRunner:
    def test_runner_parity_and_layout_decision(self, capsys, monkeypatch):
        from keystone_tpu_torch.tools import multichip

        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", "ec2")
        try:
            with tobs.tracing() as t:
                rc = multichip.main([
                    "--device", "cpu", "--n", "2000", "--d", "48", "--nnz", "6",
                    "--chunk", "128", "--seg", "2", "--iters", "10",
                ])
        finally:
            ttracer_mod._ACTIVE = None
        assert rc == 0
        printed = capsys.readouterr().out
        assert "parity max|dW|" in printed and "OK" in printed
        # Eight shards on one CPU: no speedup claim.
        assert "speedup" not in printed
        assert "not device evidence" in printed
        decisions = [e for e in t.events if e.get("type") == "event"
                     and e["name"] == "cost.decision"
                     and e["args"]["decision"] == "mesh_layout"]
        assert len(decisions) == 1
        assert decisions[0]["args"]["winner"] == "mesh[data=8,model=1]"
        # Eight shards shared one device: their wall is no outcome of an
        # 8-device layout, so the decision stays unstamped.
        assert "outcome" not in decisions[0]["args"]

    def test_runner_stamps_a_layout_with_its_own_devices(self, capsys, monkeypatch):
        from keystone_tpu_torch.tools import multichip

        # At this geometry the EC2 prices pick 1 x 1: one shard on the one
        # CPU device, so the mesh wall is the layout's outcome.
        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", "ec2")
        try:
            with tobs.tracing() as t:
                rc = multichip.main([
                    "--device", "cpu", "--n", "256", "--d", "256", "--nnz", "4",
                    "--chunk", "64", "--seg", "2", "--iters", "5",
                ])
        finally:
            ttracer_mod._ACTIVE = None
        assert rc == 0
        printed = capsys.readouterr().out
        assert "speedup" in printed and "not device evidence" not in printed
        (decision,) = [e["args"] for e in t.events if e.get("type") == "event"
                       and e["name"] == "cost.decision"
                       and e["args"]["decision"] == "mesh_layout"]
        assert decision["winner"] == "mesh[data=1,model=1]"
        assert decision["outcome"]["measured_s"] > 0

    def test_runner_rejects_oversized_layout(self, capsys):
        from keystone_tpu_torch.tools import multichip

        rc = multichip.main(["--device", "cpu", "--layout", "16x2", "--n", "256", "--d", "16"])
        assert rc == 1
        assert "16x2" in capsys.readouterr().err

    def test_runner_fails_closed_past_its_tolerance(self, capsys):
        from keystone_tpu_torch.tools import multichip

        # No parity passes a negative tolerance: the verdict, not the fit,
        # decides the exit code.
        rc = multichip.main(["--device", "cpu", "--n", "512", "--d", "16", "--nnz", "4",
                             "--chunk", "64", "--iters", "5", "--tol", "-1"])
        assert rc == 1
        assert "FAIL" in capsys.readouterr().out


class TestMeshLayoutCost:
    """``choose_mesh_layout``'s prices and winner against the reference's
    under the EC2 family (the port's default; its tests hold every cost
    within 1e-12)."""

    @pytest.mark.parametrize("geom", [
        dict(n=65_000_000, d=16_385, k=2, nnz_per_row=83, num_devices=8),
        dict(n=2_000, d=48, k=2, nnz_per_row=6, num_devices=8),
        dict(n=2_200_000, d=16_384, k=147, nnz_per_row=None, num_devices=4),
        dict(n=500_000, d=4_096, k=10, nnz_per_row=None, num_devices=8),
    ])
    def test_prices_and_winner_match(self, monkeypatch, geom):
        from keystone_tpu.ops.learning import cost as jcost
        from keystone_tpu_torch.ops.learning import cost as tcost

        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", "ec2")
        budget = dict(hbm_bytes=16 << 30)
        try:
            with tobs.tracing() as t:
                win, _ = tcost.choose_mesh_layout(**geom, **budget)
            with jobs.tracing() as jt:
                jwin, _ = jcost.choose_mesh_layout(**geom, **budget)
        finally:
            ttracer_mod._ACTIVE = None
            jtracer_mod._ACTIVE = None
        assert tuple(win) == tuple(jwin)
        (dec,) = [e["args"] for e in t.events if e.get("name") == "cost.decision"]
        (jdec,) = [e["args"] for e in jt.events if e.get("name") == "cost.decision"]
        assert dec["winner"] == jdec["winner"]
        for mine, theirs in zip(dec["candidates"], jdec["candidates"]):
            assert mine["label"] == theirs["label"]
            assert mine["feasible"] == theirs["feasible"]
            assert mine["chip_resident"] == theirs["chip_resident"]
            assert mine["resident_bytes"] == pytest.approx(theirs["resident_bytes"], rel=1e-12)
            if theirs["cost_s"] is None:
                assert mine["cost_s"] is None
            else:
                assert mine["cost_s"] == pytest.approx(theirs["cost_s"], rel=1e-12)
        for layout in tcost.MESH_LAYOUTS:
            assert tcost.price_mesh_layout(geom["n"], geom["d"], geom["k"], *layout,
                                           nnz_per_row=geom["nnz_per_row"]) == pytest.approx(
                jcost.price_mesh_layout(geom["n"], geom["d"], geom["k"], *layout,
                                        nnz_per_row=geom["nnz_per_row"]), rel=1e-12)
        assert tcost.COMPRESSED_BYTES_PER_NNZ_DEFAULT == jcost.COMPRESSED_BYTES_PER_NNZ_DEFAULT
        assert tcost.MESH_LAYOUTS == jcost.MESH_LAYOUTS

    def test_no_layout_fits(self):
        from keystone_tpu_torch.ops.learning import cost as tcost

        with pytest.raises(ValueError, match="no candidate mesh layout"):
            tcost.choose_mesh_layout(100, 8, 1, layouts=((4, 1),), num_devices=2)
