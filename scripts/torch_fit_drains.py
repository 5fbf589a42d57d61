"""Fit and apply seconds of two checkouts of the port, in turns on one card:
the TIMIT ``--solver block`` routes of ``chip_smoke.py``'s phase 2 (fit
first and apply first, 65,536 rows, 4 x 4,096 cosine features), phase
13's MnistRandomFFT routes (60,000 rows, apply first and fit first) and
phase 12(c)'s ``--solver auto`` at d = 204,800 (131,072 rows), with the
TIMIT and MNIST routes' train and test errors.

    python3 scripts/torch_fit_drains.py --root build/parent . [--turns 2]
                                        [--routes timit mnist wide]

Each root runs in a process of its own (its ``keystone_tpu_torch`` and
``chip_smoke.py`` on the path), in the order root 1, root 2, root 2, root 1
(``--turns 2``), so drift on the card lands on both. ``--routes`` picks
some of the three route groups (default: all). Prints one JSON line per
run, then one line of every root's numbers by route. Unpack the parent
first with ``git archive <commit> keystone_tpu_torch chip_smoke.py | tar
-x -C build/parent``.
"""

import argparse
import json
import os
import subprocess
import sys

_CHILD = r"""
import json, os, sys
root, routes = sys.argv[1], sys.argv[2].split(",")
sys.path.insert(0, root)
os.chdir(root)
import chip_smoke as cs
from keystone_tpu_torch.ops import cuda_ops
from keystone_tpu_torch.pipelines import timit
from keystone_tpu_torch.pipelines.timit import TimitConfig
cuda_ops.build()
out = {}
if "timit" in routes:
    _, flat, _ = cs.phase_timit_route(cuda_ops, timit, TimitConfig, fit_first=True)
    out["phase 2 fit first: fit s"] = flat["fit_seconds"]
    out["phase 2 fit first: apply (train + test) s"] = flat["apply_seconds"]
    out["phase 2 fit first: errors"] = [flat["train_error"], flat["test_error"]]
    _, stacked, _ = cs.phase_timit_route(cuda_ops, timit, TimitConfig, fit_first=False)
    out["phase 2 apply first: fit + train apply s"] = stacked["fit_seconds"]
    out["phase 2 apply first: test apply s"] = stacked["apply_seconds"]
    out["phase 2 apply first: errors"] = [stacked["train_error"], stacked["test_error"]]
if "mnist" in routes:
    for label, run in cs.phase_mnist(cuda_ops).items():
        if not isinstance(run, dict) or "fit_seconds" not in run:
            continue
        out[f"phase 13 {label}: fit s"] = run["fit_seconds"]
        out[f"phase 13 {label}: apply s"] = run["apply_seconds"]
        out[f"phase 13 {label}: errors"] = [run.get("train_error"), run.get("test_error")]
if "wide" in routes:
    wide = cs.phase_wide_auto(cuda_ops, timit, TimitConfig)
    out["phase 12(c): fit s"] = wide["fit_seconds"]
print("RESULT " + json.dumps(out), flush=True)
"""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", required=True, help="the first checkout (e.g. the parent)")
    parser.add_argument("other", help="the second checkout")
    parser.add_argument("--turns", type=int, default=2)
    parser.add_argument("--routes", nargs="+", default=["timit", "mnist", "wide"],
                        choices=["timit", "mnist", "wide"])
    args = parser.parse_args(argv)
    roots = [os.path.abspath(args.root), os.path.abspath(args.other)]
    order = []
    for t in range(args.turns):
        order += roots if t % 2 == 0 else roots[::-1]
    results = {root: [] for root in roots}
    for root in order:
        proc = subprocess.run([sys.executable, "-c", _CHILD, root, ",".join(args.routes)],
                              capture_output=True, text=True)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not line:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"{root} failed (rc {proc.returncode})")
        got = json.loads(line[0][len("RESULT "):])
        results[root].append(got)
        print(json.dumps({"root": root, **got}), flush=True)
    print(json.dumps({root: {key: [r[key] for r in runs] for key in runs[0]}
                      for root, runs in results.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
