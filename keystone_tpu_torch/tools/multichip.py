"""Mesh runner: ``python -m keystone_tpu_torch.tools.multichip`` (port of
``keystone_tpu/tools/multichip.py``).

Runs one synthetic padded-COO streamed gram fit twice, on a single device
and on a data-parallel mesh (``run_lbfgs_gram_streamed``'s ``mesh=`` path:
each device folds its own chunks, one psum a fit), and reports parity and
both walls. The mesh's layout is chosen by ``cost.choose_mesh_layout``
(``--layout auto``) and recorded as a ``mesh_layout`` cost decision,
stamped with the measured mesh wall when a tracer is active
(``--trace DIR``), so ``tools.calibrate`` joins predicted and measured
layouts as it joins solver decisions.

The layouts are priced for and built from ``MESH_POSITIONS`` (8) mesh
positions, or one a device where there are more. The devices are the CUDA
devices (or the CPU, ``--device cpu``); where there are fewer than the
positions the shards share them, as the reference's 8 forced host devices
split one CPU. The walls are then no evidence of scaling: the runner says
so rather than print a speedup, and leaves the decision unstamped, since a
shared device's wall is no outcome of the layout it priced (the
reference stamps it).

Exit code: 0 when the mesh fit matches the single-device fit within
``--tol``, 1 otherwise (or on setup errors).

``--scaling`` (:func:`run_scaling`) runs the same fit at 1, 2, 4 and 8
shards over device prefixes, each leg warmed, then the minimum of
``--reps``, its wall split into ``fold.segment`` span time and the rest
(the one psum and the replicated solve), and prints one ``scaling:
{json}`` line with the reference's keys. Unlike the reference, whose
``device_evidence`` is ``backend != "cpu"``, the port reports
``device_evidence: false`` wherever the shards of a leg share a device (8
shards on ``cuda:0``, or the CPU): one card's turns are no scaling.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

__all__ = ["main", "run", "run_scaling"]

# Max |dW| between the 1-device and mesh fits. The mesh fit is the same
# arithmetic scheduled differently (per-device partial folds and one
# reduction), so the bound is reassociation noise; the reference's
# default, with headroom over its 3.43e-07 dry-run reading.
DEFAULT_TOL = 5e-5

# Mesh positions on fewer devices: the reference's tests and chip leg
# force 8 host devices.
MESH_POSITIONS = 8


def _parse_layout(spec: str):
    try:
        p, q = spec.lower().split("x")
        return max(int(p), 1), max(int(q), 1)
    except ValueError:
        raise SystemExit(f"--layout {spec!r}: expected '<data>x<model>', e.g. 8x1")


def _synth_coo(args):
    """The runner's synthetic padded-COO problem (ragged rows through dead
    lanes), chunked for the streamed fold: the reference's draws."""
    import numpy as np

    n, d, w, k, c = args.n, args.d, args.nnz, args.k, args.chunk
    rng = np.random.default_rng(args.seed)
    idx = rng.integers(0, d, size=(n, w)).astype(np.int32)
    idx[rng.random((n, w)) < 0.2] = -1  # ragged rows: dead lanes
    val = rng.normal(size=(n, w)).astype(np.float32)
    Y = rng.normal(size=(n, k)).astype(np.float32)
    nchunks = -(-n // c)
    pad = nchunks * c - n
    idx_t = np.pad(idx, ((0, pad), (0, 0)), constant_values=-1)
    val_t = np.pad(val, ((0, pad), (0, 0)))
    y_t = np.pad(Y, ((0, pad), (0, 0)))
    return nchunks, (
        idx_t.reshape(nchunks, c, w),
        val_t.reshape(nchunks, c, w),
        y_t.reshape(nchunks, c, k),
    )


def _clamped_chunk(cid, idx_t, val_t, y_t):
    """Resident chunk ``cid``; ids past the last chunk (a ragged last
    segment's) read the last one, which the fold then zeroes."""
    cid = min(int(cid), int(idx_t.shape[0]) - 1)
    return idx_t[cid], val_t[cid], y_t[cid]


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args) -> int:
    import torch

    from keystone_tpu_torch import obs, resolve_device
    from keystone_tpu_torch.ops.learning import cost as cost_mod
    from keystone_tpu_torch.ops.learning.lbfgs import run_lbfgs_gram_streamed
    from keystone_tpu_torch.parallel import mesh as mesh_lib

    device = resolve_device(args.device)
    physical = (torch.cuda.device_count() if device.type == "cuda" else 1)
    avail = max(physical, MESH_POSITIONS)
    n, d, w, k, c = args.n, args.d, args.nnz, args.k, args.chunk

    if args.layout == "auto":
        (p, q), ref = cost_mod.choose_mesh_layout(n, d, k, nnz_per_row=w, num_devices=avail)
        layout_src = "cost.choose_mesh_layout"
    else:
        p, q = _parse_layout(args.layout)
        ref = None
        layout_src = "forced"
    if p * q > avail:
        print(f"multichip: layout {p}x{q} needs {p * q} devices, {avail} available "
              f"({device.type})", file=sys.stderr)
        return 1

    nchunks, arrays = _synth_coo(args)
    operands = tuple(torch.from_numpy(a).to(device) for a in arrays)
    kw = dict(lam=args.lam, num_iterations=args.iters, convergence_tol=1e-8, n=n,
              val_dtype=torch.float32, device=device)

    _sync(device)
    t0 = time.perf_counter()
    W1, loss1 = run_lbfgs_gram_streamed(
        _clamped_chunk, nchunks, d, k, operands=operands,
        max_chunks_per_dispatch=args.seg, **kw,
    )
    _sync(device)
    single_s = time.perf_counter() - t0

    if device.type == "cuda":
        devices = [torch.device("cuda", i % physical) for i in range(p * q)]
    else:
        devices = [device] * (p * q)
    if q > 1:
        mesh = mesh_lib.make_mesh((p, q), (mesh_lib.DATA_AXIS, mesh_lib.MODEL_AXIS),
                                  devices=devices)
    else:
        mesh = mesh_lib.make_mesh((p,), (mesh_lib.DATA_AXIS,), devices=devices)
    t0 = time.perf_counter()
    Wm, lossm = run_lbfgs_gram_streamed(
        _clamped_chunk, nchunks, d, k, operands=operands,
        max_chunks_per_dispatch=args.seg, mesh=mesh, **kw,
    )
    _sync(device)
    mesh_s = time.perf_counter() - t0
    shared = p * q > physical
    if ref is not None and not shared:
        ref.stamp(mesh_s, timing="wall")

    parity = float((W1 - Wm.to(W1.device)).abs().max())
    ok = parity <= args.tol
    print(f"backend={device.type} devices={physical} shards={avail} layout={p}x{q} "
          f"({layout_src})")
    print(f"geometry: n={n} d={d} nnz/row={w} k={k} chunk={c} seg={args.seg} "
          f"iters={args.iters}")
    print(f"single-device wall: {single_s:.3f}s (loss {float(loss1):.6f})")
    print(f"mesh wall:          {mesh_s:.3f}s (loss {float(lossm):.6f})")
    if shared:
        # Shards that share a device share its cycles: the mesh wall is
        # evidence that the program is right, never a speedup.
        print(f"note: {p * q} shards on {physical} {device.type} device(s) — walls are "
              "not device evidence (shards share a device); parity is the result here")
    else:
        print(f"speedup: {single_s / mesh_s:.2f}x (num_devices={p * q}, "
              f"single_device_baseline_s={single_s:.3f})")
    print(f"parity max|dW|: {parity:.3e} ({'OK' if ok else 'FAIL'}, tol {args.tol:.1e})")
    if obs.enabled():
        print("trace: mesh_layout decision + fold.segment device spans recorded")
    return 0 if ok else 1


def run_scaling(args) -> int:
    """``--scaling``: the fit at 1/2/4/8 shards (a data-parallel mesh over
    the first m device positions; one shard is the one-device fit), each
    leg warmed, then the minimum of ``--reps``. Each leg's wall splits into
    the fold (the ``fold.segment`` spans' time, the part that shards) and
    the rest (the one psum and the replicated L-BFGS solve on G, the
    Amdahl term). Prints one ``scaling: {json}`` line; the exit code is
    every leg's parity against the one-shard fit. On the card a fold span
    closes when its launches are queued (``queued``), so a leg
    synchronizes before its clock stops and the split reads enqueue time.
    Each leg records its kernel launches of one rep (``launches``)."""
    import json

    import torch

    from keystone_tpu_torch import obs, resolve_device
    from keystone_tpu_torch.ops import cuda_ops
    from keystone_tpu_torch.ops.learning.lbfgs import run_lbfgs_gram_streamed
    from keystone_tpu_torch.parallel import mesh as mesh_lib

    device = resolve_device(args.device)
    physical = torch.cuda.device_count() if device.type == "cuda" else 1
    positions = max(physical, MESH_POSITIONS)
    legs_m = [m for m in (1, 2, 4, 8) if m <= positions]
    nchunks, arrays = _synth_coo(args)
    operands = tuple(torch.from_numpy(a).to(device) for a in arrays)
    n, d, k = args.n, args.d, args.k
    kw = dict(lam=args.lam, num_iterations=args.iters, convergence_tol=1e-8, n=n,
              val_dtype=torch.float32, device=device)
    print(f"backend={device.type} devices={physical} scaling legs={legs_m}")
    print(f"geometry: n={n} d={d} nnz/row={args.nnz} k={k} chunk={args.chunk} "
          f"seg={args.seg} iters={args.iters}")

    legs, W_ref, worst = [], None, 0.0
    for m in legs_m:
        mesh = None
        if m > 1:
            devices = ([torch.device("cuda", i % physical) for i in range(m)]
                       if device.type == "cuda" else [device] * m)
            mesh = mesh_lib.make_mesh((m,), (mesh_lib.DATA_AXIS,), devices=devices)

        def fit():
            W, _ = run_lbfgs_gram_streamed(_clamped_chunk, nchunks, d, k, operands=operands,
                                           max_chunks_per_dispatch=args.seg, mesh=mesh, **kw)
            _sync(device)
            return W

        fit()  # warm: the first calls' one-time costs, untimed
        wall, fold_s, launches = float("inf"), None, {}
        for _ in range(max(args.reps, 1)):
            # An in-memory trace a rep (only where the caller is not
            # tracing) splits the wall into fold and the rest.
            tr = None if obs.enabled() else obs.tracing()
            before = dict(cuda_ops.launches)
            t0 = time.perf_counter()
            if tr is not None:
                with tr as t:
                    W = fit()
            else:
                W = fit()
            rep_wall = time.perf_counter() - t0
            launches = {name: c - before.get(name, 0) for name, c in cuda_ops.launches.items()
                        if c - before.get(name, 0)}
            if rep_wall < wall:
                wall = rep_wall
                if tr is not None:
                    fold_s = sum(e.get("dur_us", 0) for e in t.events
                                 if e.get("type") == "span"
                                 and e.get("name") == "fold.segment") / 1e6
        if W_ref is None:
            W_ref = W
        parity = float((W - W_ref.to(W.device)).abs().max())
        worst = max(worst, parity)
        leg = {"num_devices": m, "wall_s": round(wall, 4), "parity_max_dw": parity,
               "shared_device": m > physical, "launches": launches}
        if fold_s is not None:
            leg["fold_s"] = round(min(fold_s, wall), 4)
            leg["solve_s"] = round(max(wall - fold_s, 0.0), 4)
        legs.append(leg)
        print(f"  m={m}: wall {wall:.3f}s"
              + (f" (fold {leg['fold_s']:.3f}s, solve+psum {leg['solve_s']:.3f}s)"
                 if fold_s is not None else ""))

    t1 = legs[0]["wall_s"]
    for leg in legs:
        # Every speedup / efficiency claim carries its num_devices and
        # single_device_baseline_s in the same dict (the reference's rule).
        leg["speedup_vs_single_device"] = round(t1 / leg["wall_s"], 4)
        leg["scaling_efficiency"] = round(t1 / leg["wall_s"] / leg["num_devices"], 4)
        leg["single_device_baseline_s"] = t1
    if all("fold_s" in leg for leg in legs):
        first, last = legs[0], legs[-1]
        bend = {"phase": "gram_solve+psum",
                "note": (f"the fold phase shards across devices; the one psum and the "
                         f"replicated L-BFGS-on-G solve do not: their share grows from "
                         f"{first['solve_s'] / max(t1, 1e-9):.0%} of the 1-device wall to "
                         f"{last['solve_s'] / max(last['wall_s'], 1e-9):.0%} at "
                         f"{last['num_devices']} devices (Amdahl term)")}
    else:
        bend = {"phase": "unattributed", "note": "phase split unavailable (outer tracing active)"}
    device_evidence = device.type == "cuda" and legs_m[-1] <= physical
    if not device_evidence:
        print(f"note: {legs_m[-1]} shards on {physical} {device.type} device(s): walls are not "
              "device evidence (shards share a device); parity and the phase split are the "
              "result here")
    ok = worst <= args.tol
    print(f"parity max|dW| (worst leg): {worst:.3e} ({'OK' if ok else 'FAIL'}, "
          f"tol {args.tol:.1e})")
    print("scaling: " + json.dumps({
        "backend": device.type, "device_evidence": device_evidence,
        "legs": legs, "bend": bend,
        "geometry": {"n": n, "d": d, "nnz_per_row": args.nnz, "k": k, "chunk": args.chunk,
                     "seg": args.seg, "iters": args.iters},
        "parity_worst_max_dw": worst, "parity_tol": args.tol,
    }))
    return 0 if ok else 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        "keystone-multichip", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--layout", default="auto",
                        help="'<data>x<model>' mesh shape, or 'auto' "
                             "(cost.choose_mesh_layout picks and the decision is recorded)")
    parser.add_argument("--device", default=None,
                        help="fit device (default: the CUDA device; 'cpu' runs the "
                             "kernels' plain versions)")
    parser.add_argument("--scaling", action="store_true",
                        help="run the 1/2/4/8-shard scaling legs and print a "
                             "machine-readable 'scaling:' JSON line")
    parser.add_argument("--reps", type=int, default=2,
                        help="warm reps a scaling leg (the minimum is taken)")
    parser.add_argument("--n", type=int, default=20_000)
    parser.add_argument("--d", type=int, default=256)
    parser.add_argument("--nnz", type=int, default=16, help="active lanes per padded-COO row")
    parser.add_argument("--k", type=int, default=2)
    parser.add_argument("--chunk", type=int, default=512, help="rows per fold chunk")
    parser.add_argument("--seg", type=int, default=4, help="chunks per fold segment")
    parser.add_argument("--iters", type=int, default=30)
    parser.add_argument("--lam", type=float, default=0.1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tol", type=float, default=DEFAULT_TOL)
    parser.add_argument("--trace", default="",
                        help="write a trace directory (mesh_layout decision, device spans)")
    args = parser.parse_args(list(argv) if argv is not None else None)

    entry = run_scaling if args.scaling else run
    if args.trace:
        from keystone_tpu_torch import obs

        with obs.tracing(args.trace):
            rc = entry(args)
        print(f"trace written: {args.trace}")
        return rc
    return entry(args)


if __name__ == "__main__":
    sys.exit(main())
