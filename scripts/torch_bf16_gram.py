"""The bf16 Gramians' readings of several checkouts, in turns on one GPU.

    python3 scripts/torch_bf16_gram.py --root DIR [DIR ...] [--out build/torch_bf16_gram.json]

For each checkout, first to last and back (parent, change, change, parent
for two), one child process whose import path starts at that checkout runs
``chip_smoke.py``'s readings (this checkout's script, the child's
``keystone_tpu_torch``, its kernels built into its own ``build/``):

  - ``row8_bits``: SHA-256 of bf16 ``gram_corr_sym_acc``'s output on a
    fixed Amazon chunk (inputs from integer arithmetic, no random number
    generator), which shows whether a change kept that kernel's bits;
  - ``gram_f64_reading``: bf16 ``gram_sym_acc`` at the reference bench's
    streamed tile, F 65,536 x 16,384, against float64 sums, beside bf16
    ``addmm``;
  - ``bf16_route_fits``: the bf16 streamed fit at 1,310,720 rows and the
    bf16 flat fit on a 65,536 x 16,384 slab (and the float32 slab's), their
    fit seconds, launches and staged copies.

The weights of each turn are held against the first turn's (relative
Frobenius distance, and whether the bits are equal). Prints one line a
turn and writes the numbers, with the card's name and power limit, as JSON
to ``--out``. Needs a CUDA device; exits non-zero without one.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The sources the readings launch kernels of.
SOURCES = ["gram_corr", "gram_corr_sym_acc", "cosine_features", "block_corr",
           "block_residual_update"]


def child(root, out):
    """One turn: the readings with ``root``'s package; the numbers as JSON
    and the weights as tensors beside it."""
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(_REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from keystone_tpu_torch.ops import cuda_ops

    assert cuda_ops.__file__.startswith(os.path.abspath(root)), cuda_ops.__file__
    cuda_ops.build(SOURCES)
    gen = torch.Generator(device="cuda").manual_seed(2)
    result = dict(root=root, row8_sha256=smoke.row8_bits(cuda_ops),
                  row7_vs_f64=smoke.gram_f64_reading(cuda_ops, gen))
    fits = smoke.bf16_route_fits(cuda_ops)
    weights = dict(streamed=fits["streamed"].pop("model")["W_stack"].cpu(),
                   flat=fits["flat"].pop("W").cpu(), flat_f32=fits["flat"].pop("W32").cpu())
    result["fits"] = fits
    torch.save(weights, out + ".pt")
    with open(out, "w") as f:
        json.dump(result, f)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", nargs="+", required=True)
    parser.add_argument("--out", default="build/torch_bf16_gram.json")
    parser.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_bf16_gram: no CUDA device is available", file=sys.stderr)
        return 2
    if args.child:
        child(*args.child)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    roots = [os.path.abspath(root) for root in args.root]
    order = list(range(len(roots))) + list(reversed(range(len(roots))))
    turns, first = [], None
    with tempfile.TemporaryDirectory() as tmp:
        for turn, i in enumerate(order):
            out = os.path.join(tmp, f"turn{turn}.json")
            subprocess.run([sys.executable, os.path.abspath(__file__), "--root", roots[i],
                            "--child", roots[i], out], check=True)
            with open(out) as f:
                result = json.load(f)
            weights = torch.load(out + ".pt")
            first = first or weights
            result["weights_vs_first_turn"] = {
                name: dict(bits=bool(torch.equal(w, first[name])),
                           rel=float((w - first[name]).norm() / first[name].norm()))
                for name, w in weights.items()}
            fits = result["fits"]
            print(f"{result['root']}: row 8 bf16 {result['row8_sha256']}; row 7 bf16 vs "
                  f"float64 {result['row7_vs_f64']}; streamed fit "
                  f"{fits['streamed']['fit_seconds']:.3f} s, flat fit "
                  f"{fits['flat']['fit_seconds']:.3f} s (float32 slab "
                  f"{fits['flat']['f32_fit_seconds']:.3f} s); weights against the first turn "
                  f"{result['weights_vs_first_turn']}", flush=True)
            turns.append(result)
    print(card)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, turns=turns), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
