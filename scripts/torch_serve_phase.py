"""Phase 19 of ``chip_smoke.py`` (the serving path) alone on one card.

    python3 scripts/torch_serve_phase.py [a]

Builds the kernels, then runs 19(a) (the TIMIT scores plan: captures,
launches, bits, plain-kernel twins), and without ``a`` also 19(b) (``run.py
serve`` with one and two replicas), 19(c) (a hot swap under Poisson load)
and 19(d) (open-loop latency at three rates beside batch size 1), printing
each part's checks and readings and its cumulative seconds.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from keystone_tpu_torch.ops import cuda_ops  # noqa: E402
from keystone_tpu_torch.pipelines import timit  # noqa: E402


def main(argv):
    t0 = time.time()
    cuda_ops.build()
    print(f"build {time.time() - t0:.1f} s", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.time()
    plan, scores, pool, _, _ = cs.phase_serve_plan(cuda_ops, timit)
    print(f"a {time.time() - t0:.1f} s", flush=True)
    if argv != ["a"]:
        cs.phase_serve_cli(cuda_ops)
        print(f"b {time.time() - t0:.1f} s", flush=True)
        cs.phase_serve_swap(cuda_ops, timit, plan, pool)
        print(f"c {time.time() - t0:.1f} s", flush=True)
        cs.phase_serve_latency(plan, scores, pool, smi)
        print(f"d {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
