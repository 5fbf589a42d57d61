"""Where ``run.py serve --fleet 2``'s served tail comes from (ROADMAP B.28).

    python3 scripts/torch_fleet_tail.py [--storms 3] [--rate 200] [--duration-s 2]
                                        [--device cpu]

Fits MnistRandomFFT as ``serve`` does at its defaults, exports the plan and
ships it to two plane processes behind a ``FleetRouter`` configured as
``serve --fleet 2`` configures it; then runs ``--storms`` open-loop Poisson
storms back to back on those planes, and the same storms on an in-process
``ReplicatedServer`` of 2 replicas, every storm inside ``frozen_heap()`` as
``serve`` runs it. Each storm prints the loadgen's p50 / p99, its five
slowest requests with their arrival times (seconds into the storm) and the
latencies of its first ten requests; each fleet storm also prints the
planes' own merged p99 so far. A tail paid once by fresh planes and
connections sits in the first storm's first requests; a tail of the hop
between router and plane is spread over every storm.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def storm(submit, pool, args, seed):
    """One open-loop storm; its readings, latencies in ms."""
    from keystone_tpu_torch.serving import run_open_loop
    from keystone_tpu_torch.serving.batcher import frozen_heap
    from keystone_tpu_torch.serving.loadgen import poisson_arrivals

    with frozen_heap():
        report = run_open_loop(submit, lambda i: pool[i % len(pool)], rate_hz=args.rate,
                               duration_s=args.duration_s, seed=seed)
    if report.completed != report.num_offered:
        raise SystemExit(f"a request was not served: {report.to_row_dict()}")
    arrivals = poisson_arrivals(args.rate, args.duration_s, seed=seed)
    ms = [round(s * 1e3, 3) for s in report.latencies_s]
    worst = sorted(range(len(ms)), key=ms.__getitem__)[-5:]
    return dict(p50_ms=round(report.p50_latency_s * 1e3, 3),
                p99_ms=round(report.p99_latency_s * 1e3, 3), n=len(ms),
                slowest=[(round(float(arrivals[i]), 3), ms[i]) for i in reversed(worst)],
                first_ten=ms[:10])


def main(argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("--storms", type=int, default=3)
    parser.add_argument("--rate", type=float, default=200.0)
    parser.add_argument("--duration-s", type=float, default=2.0)
    parser.add_argument("--device", default=None, help="'cpu' for a dry run")
    args = parser.parse_args(argv)

    import numpy as np

    from keystone_tpu_torch import resolve_device
    from keystone_tpu_torch.ops import cuda_ops
    from keystone_tpu_torch.run import _serve_build_fitted
    from keystone_tpu_torch.serving import ReplicatedServer, export_plan
    from keystone_tpu_torch.serving.fleet import FleetRouter
    from keystone_tpu_torch.serving.fleet_plane import encode_plan_ship

    device = resolve_device(args.device)
    smi = "the CPU"
    if device.type == "cuda":
        cuda_ops.build()
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip()
    # serve's defaults: MnistRandomFFT on 4,096 rows, buckets to 256, 5 ms
    # coalescing wait, queue depth 1,024, one replica a plane, budget 3.
    fit_args = argparse.Namespace(model="", pipeline="MnistRandomFFT", input_dim=784, seed=0,
                                  fit_n=4096, numFFTs=4, blockSize=2048)
    fitted, d_in = _serve_build_fitted(fit_args, device)
    plan = export_plan(fitted, np.zeros(d_in, np.float32), max_batch=256, device=device)
    pool = np.random.default_rng(1).normal(size=(256, d_in)).astype(np.float32)
    t0 = time.perf_counter()
    fleet = FleetRouter(encode_plan_ship(fitted, plan), num_planes=2, replicas_per_plane=1,
                        max_outstanding=1024, restart_budget=3,
                        plane_cfg={"max_wait_ms": 5.0, "max_queue_depth": 1024,
                                   "device": str(device)})
    print(f"planes booted in {time.perf_counter() - t0:.1f} s; {smi}", flush=True)
    try:
        for k in range(args.storms):
            row = storm(fleet.submit, pool, args, seed=k)
            row["planes_p99_ms_so_far"] = round(fleet.stats()["fleet_p99_latency_s"] * 1e3, 3)
            print(json.dumps(dict(server="fleet 2", storm=k, **row)), flush=True)
    finally:
        fleet.close()
    server = ReplicatedServer(plan, num_replicas=2, max_batch=256, max_wait_ms=5.0,
                              max_queue_depth=1024, restart_budget=3)
    try:
        for k in range(args.storms):
            row = storm(server.submit, pool, args, seed=k)
            print(json.dumps(dict(server="replicas 2", storm=k, **row)), flush=True)
    finally:
        server.close()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
