"""Where the time of the PyTorch port's TIMIT block slice goes, on one GPU.

    python3 scripts/torch_timit_profile.py [--out chiprun_out/torch_timit_profile.json]

Runs ``keystone_tpu_torch.pipelines.timit.run`` (``--solver block``) at the
shape ``chip_smoke.py`` drives (65,536 training rows, 4 x 4096 cosine
features, 147 classes, 3 epochs) once to warm up (kernel builds, CUDA
library handles), then three more times for warm fit and apply wall
seconds, then once more under
``torch.profiler`` for the device time by kernel name and the device's
busy share of that run's wall time. Prints a table and writes the numbers,
with the card's name and power limit, as JSON to ``--out``. Needs a CUDA
device; exits non-zero without one.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="chiprun_out/torch_timit_profile.json")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_timit_profile: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from torch.profiler import ProfilerActivity, profile

    from keystone_tpu_torch.ops import cuda_ops
    from keystone_tpu_torch.pipelines import timit
    from keystone_tpu_torch.workflow import PipelineEnv

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    config = timit.TimitConfig(solver="block", num_cosines=4, block_size=4096,
                               synthetic_n=65536, num_epochs=3)

    def one_run():
        PipelineEnv.get_or_create().reset()
        return timit.run(config, device="cuda")

    one_run()  # warm-up
    warm = []
    for _ in range(3):
        r = one_run()
        warm.append((r.fit_seconds, r.apply_seconds))
    cuda_ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = one_run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side events only (kernels, copies, memsets): each is counted
    # once, where the host ops that launched them would count it again.
    rows = sorted(
        ((e.key, _device_us(e) / 1e3, e.count) for e in prof.key_averages()
         if str(getattr(e, "device_type", "")).endswith("CUDA")),
        key=lambda row: -row[1],
    )
    rows = [row for row in rows if row[1] > 0]
    busy_ms = sum(row[1] for row in rows)
    result = dict(
        card=card,
        config=dict(n=config.synthetic_n, d=config.num_cosines * config.block_size,
                    block=config.block_size, epochs=config.num_epochs,
                    k=timit.NUM_CLASSES),
        warm_fit_seconds=[w[0] for w in warm],
        warm_apply_seconds=[w[1] for w in warm],
        profiled_run=dict(
            wall_seconds=wall, fit_seconds=r.fit_seconds, apply_seconds=r.apply_seconds,
            device_busy_ms=busy_ms, device_busy_share=busy_ms / 1e3 / wall,
            launches=dict(cuda_ops.launches),
            device_ms_by_name=[dict(name=k, ms=ms, count=c) for k, ms, c in rows[:25]],
        ),
    )
    print(card)
    print(f"warm fit s {result['warm_fit_seconds']}, apply s {result['warm_apply_seconds']}")
    print(f"profiled run: wall {wall:.4f} s (data generation included), device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / 1e3 / wall:.1f}%)")
    for name, ms, count in rows[:25]:
        print(f"  {ms:10.3f} ms  {count:6d}x  {name[:90]}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
