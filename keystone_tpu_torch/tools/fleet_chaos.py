"""One-command fleet chaos drill: ``python -m
keystone_tpu_torch.tools.fleet_chaos`` (port of
``keystone_tpu/tools/fleet_chaos.py``; the port keeps no ``bin/``
wrapper).

Quick-fits a small MnistRandomFFT pipeline, ships it (split-plane
encoded, fingerprint-verified on arrival) to a multi-process serving
fleet behind the :class:`~keystone_tpu_torch.serving.fleet.FleetRouter`,
drives a multi-tenant open-loop Poisson storm, SIGKILLs one whole
plane PROCESS mid-storm, waits for the watchdog respawn, and prints
the accounting verdict as JSON:

  - ``books_balance`` — the fleet invariant ``offered == completed +
    rejected + failed`` with zero in flight, held EXACTLY across the
    process kill (in-flight requests on the dead plane fail loudly,
    never silently).
  - ``respawn_fired`` — the watchdog declared the plane dead off
    missed heartbeats and respawned it from the shipped plan (new
    pid) within the restart budget.
  - the per-plane books and the fleet-merged latency tail (the exact
    cross-process histogram merge).

The fit and the planes run on ``--device`` (default: the CUDA device;
``cpu`` runs the kernels' plain versions). Exit status: 0 when both
hold, 1 otherwise — the drill IS the check.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
from typing import Any, Dict, Optional, Sequence

__all__ = ["drill", "main", "verdict_ok"]


def _fit_and_ship(d_in: int, num_ffts: int, block_size: int, n: int,
                  max_batch: int, seed: int, device):
    """Quick-fit at drill scale on ``device`` and encode the plan ship.
    ONE padding bucket, as in the reference (whose FFT plan is not
    bit-identical across buckets on the CPU, and the plane lifecycle
    gate enforces bit-identity)."""
    import numpy as np
    import torch

    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels
    from keystone_tpu_torch.pipelines.mnist_random_fft import (
        MnistRandomFFTConfig,
        build_featurizer,
    )
    from keystone_tpu_torch.serving import export_plan
    from keystone_tpu_torch.serving.fleet_plane import encode_plan_ship

    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.normal(size=(n, d_in)).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.integers(0, 10, size=n)).to(device)
    labels = ClassLabelIndicatorsFromIntLabels(10)(Dataset.of(y))
    cfg = MnistRandomFFTConfig(
        num_ffts=num_ffts, block_size=block_size, image_size=d_in
    )
    fitted = build_featurizer(cfg, device=device).and_then(
        BlockLeastSquaresEstimator(block_size, 1, 1e-3),
        Dataset.of(X), labels,
    ).fit()
    plan = export_plan(fitted, np.zeros(d_in, np.float32),
                       max_batch=max_batch, buckets=[max_batch],
                       device=device)
    return plan, encode_plan_ship(fitted, plan)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        "keystone-fleet-chaos", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--planes", type=int, default=2,
                        help="plane processes in the fleet")
    parser.add_argument("--replicas", type=int, default=1,
                        help="replicas inside each plane")
    parser.add_argument("--tenants", type=int, default=4,
                        help="independent Poisson tenants")
    parser.add_argument("--rate", type=float, default=0.0,
                        help="aggregate offered rate in Hz (0 = "
                             "calibrate to --rate-x planes' worth of "
                             "measured single-request throughput)")
    parser.add_argument("--rate-x", type=float, default=1.0,
                        help="with --rate 0: aggregate rate as a "
                             "multiple of ONE plane's naive throughput")
    parser.add_argument("--duration-s", type=float, default=3.0,
                        help="storm window; the kill lands halfway in")
    parser.add_argument("--input-dim", type=int, default=16)
    parser.add_argument("--fit-n", type=int, default=96)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="fit and plane device (default: the CUDA "
                        "device; 'cpu' runs the kernels' plain versions)")
    args = parser.parse_args(list(argv) if argv is not None else None)

    from keystone_tpu_torch import resolve_device
    from keystone_tpu_torch.serving.fleet import FleetRouter

    device = resolve_device(args.device)
    plan, ship = _fit_and_ship(
        d_in=args.input_dim, num_ffts=2, block_size=args.input_dim,
        n=args.fit_n, max_batch=32, seed=args.seed, device=device,
    )
    single_s = plan.measure_single_request_s(reps=3)
    rate_hz = args.rate or (
        args.rate_x * max(1, args.replicas) / single_s
    )
    rates = {f"t{i}": rate_hz / args.tenants
             for i in range(args.tenants)}
    import numpy as np

    rng = np.random.default_rng(args.seed + 1)
    pool = rng.normal(size=(128, args.input_dim)).astype(np.float32)

    fleet = FleetRouter(
        ship, num_planes=args.planes,
        replicas_per_plane=max(1, args.replicas),
        heartbeat_interval_s=0.1, heartbeat_timeout_s=3.0,
        restart_budget=2, plane_cfg={"device": str(device)},
    )
    try:
        verdict = drill(fleet, pool, rates, duration_s=args.duration_s, seed=args.seed)
    finally:
        fleet.close()
    verdict.update(offered_rate_hz=round(rate_hz, 2), num_tenants=args.tenants)
    print(json.dumps(verdict, indent=2, sort_keys=True))
    if not verdict_ok(verdict):
        print("fleet-chaos: VERDICT FAILED (books_balance="
              f"{verdict['books_balance']}, respawn_fired={verdict['respawn_fired']}, "
              f"loadgen_books={verdict['loadgen_books_balance']})",
              file=sys.stderr)
        return 1
    return 0


def drill(fleet, pool, rates: Dict[str, float], duration_s: float, seed: int = 0,
          respawn_timeout_s: float = 30.0) -> Dict[str, Any]:
    """The drill on a running fleet: a multi-tenant open-loop storm of
    ``duration_s`` over ``pool``'s rows, the first plane (by name)
    SIGKILLed halfway, a bounded wait for the watchdog's respawn and for
    the books to settle. Returns the verdict; its request counts are the
    storm's own (the router's books since the drill began), so a fleet
    that served before still reads one storm."""
    from keystone_tpu_torch.serving.batcher import frozen_heap
    from keystone_tpu_torch.serving.loadgen import run_multi_tenant_open_loop

    victim: Dict[str, Any] = {}
    books = ("aggregate_offered", "completed", "rejected", "failed")
    s0 = fleet.stats()
    num_planes = s0["num_planes"]

    def kill_one_plane() -> None:
        pids = fleet.plane_pids()
        name = sorted(pids)[0]
        victim["name"], victim["pid"] = name, pids[name]
        os.kill(pids[name], signal.SIGKILL)

    timer = threading.Timer(duration_s / 2.0, kill_one_plane)
    timer.start()
    try:
        # The router owns this process's heap: it routes the storm with
        # that heap out of the collector's reach, as its planes serve
        # theirs (ROADMAP C.14).
        with frozen_heap():
            report = run_multi_tenant_open_loop(
                fleet.submit_tenant,
                lambda tenant, i: pool[i % len(pool)],
                rates, duration_s=duration_s, seed=seed,
            )
    finally:
        timer.cancel()
        timer.join()
    # The respawn races the storm's tail: give the watchdog a bounded
    # window to finish its work before reading the books.
    deadline = time.monotonic() + respawn_timeout_s
    respawn_fired = False
    while time.monotonic() < deadline:
        s = fleet.stats()
        if (s["restarts_total"] >= s0["restarts_total"] + 1
                and s["healthy_planes"] == num_planes):
            respawn_fired = True
            break
        time.sleep(0.05)
    drain_deadline = time.monotonic() + 15.0
    while not fleet.accounting_ok() and time.monotonic() < drain_deadline:
        time.sleep(0.05)
    stats = fleet.stats()
    storm = {k: stats[k] - s0[k] for k in books}
    return {
        "books_balance": fleet.accounting_ok(),
        "respawn_fired": respawn_fired,
        "loadgen_books_balance": report.accounting_ok(),
        "victim": victim.get("name"),
        "victim_pid": victim.get("pid"),
        "respawned_pid": fleet.plane_pids().get(victim.get("name")),
        "offered": storm["aggregate_offered"],
        "completed": storm["completed"],
        "rejected": storm["rejected"],
        "failed": storm["failed"],
        "inflight": stats["inflight"],
        "num_planes": stats["num_planes"],
        "healthy_planes": stats["healthy_planes"],
        "restarts_total": stats["restarts_total"],
        "fleet_p50_latency_s": stats["fleet_p50_latency_s"],
        "fleet_p99_latency_s": stats["fleet_p99_latency_s"],
        "planes": stats["planes"],
    }


def verdict_ok(verdict: Dict[str, Any]) -> bool:
    """The drill passed: the books balance on both sides and the killed
    plane came back under a new pid."""
    return bool(verdict["books_balance"] and verdict["respawn_fired"]
                and verdict["loadgen_books_balance"]
                and verdict["victim_pid"] is not None
                and verdict["respawned_pid"] != verdict["victim_pid"])


if __name__ == "__main__":
    sys.exit(main())
