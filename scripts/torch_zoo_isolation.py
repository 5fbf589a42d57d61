"""Phase 22(b) of ``chip_smoke.py`` (the zoo's isolation drill) again and
again in one process on one card, for a pass rate (ROADMAP C.14).

    python3 scripts/torch_zoo_isolation.py [--rounds 20]

Builds the kernels, fits the two TIMIT plans phase 22 clones (seeds 0 and
1, phase 19's width), then runs ``chip_smoke.phase_zoo_isolation`` once a
round, as the script runs it, and prints each round's verdict and the
tally beside the card's name and power limit. Exits 1 if any round failed.
"""

import argparse
import os
import pickle
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main(argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=20)
    args = parser.parse_args(argv)

    from keystone_tpu_torch.ops import cuda_ops
    from keystone_tpu_torch.pipelines import timit

    t0 = time.time()
    cuda_ops.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    pool = cs.serve_pool()
    blobs = [pickle.dumps(cs.serve_scores(timit, s, pool[:1], "cuda")[0]) for s in (0, 1)]
    print(f"build and fits {time.time() - t0:.1f} s; {smi}", flush=True)
    passed = 0
    for r in range(args.rounds):
        t1 = time.time()
        try:
            cs.phase_zoo_isolation(blobs, pool)
            ok, why = True, ""
        except AssertionError as e:
            ok, why = False, str(e)[:300]
        passed += ok
        print(f"round {r}: {'passed' if ok else 'FAILED'} in {time.time() - t1:.2f} s {why}",
              flush=True)
    print(f"22(b): {passed} of {args.rounds} passed; {smi}", flush=True)
    return 0 if passed == args.rounds else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
