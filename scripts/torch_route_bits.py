"""Four routes' fits on one GPU, for each of several checkouts: their times,
errors and the bits of their weights.

    python3 scripts/torch_route_bits.py --root DIR [DIR ...] [--routes NAME ...]
                                        [--out FILE]

The routes are ``chip_smoke.py``'s, at its sizes: the streamed TIMIT fit
(``--solver streaming`` through ``timit.run``, 275,000 rows, 4 x 4,096
cosine features, 147 classes, 3 epochs), the optimizer-bound streamed fit
(the TIMIT featurizer composed with ``StreamingLeastSquaresChoice`` on
65,536 rows, which ``StreamedFitFusionRule`` binds into the fit) and the
sparse ridge fit with the gram engine on float32 slabs at the Amazon
geometry (n = 500,000, d = 16,384, 82 active a row, k = 2, 20 L-BFGS
iterations, through a ``Sparsify`` pipeline), and the CIFAR
RandomPatchCifarKernel fit and apply (``chip_smoke.cifar_config``: 50,000
training and 12,500 test images, 100 filters, KRR block 512, 1 epoch,
through ``run_random_patch_cifar_kernel``; its fitted pipeline holds the
convolution's training features). ``--routes`` picks some of them
(default: all). Each checkout runs in a
process of its own (this script with ``--child DIR``, that checkout's
package and ``chip_smoke.py`` first on the path, its kernels built into its
own ``build/``), in turns from the first checkout to the last and back
(parent, change, change, parent for two). Each route is fitted twice in a
process (the first fit warms the card); for each fit it records the fit's
wall seconds (ending in a device synchronize), the train and test error
(accuracy for the sparse fit) and a SHA-256 of every tensor the fitted
pipeline holds (each operator's tensors, in graph order), so two fits give
the same digest exactly when their weights have the same bits.

Prints one line a route and turn, and writes the numbers, with the card's
name and power limit, as JSON to ``--out``. Needs a CUDA device; exits
non-zero without one.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import torch

_SCRIPT = os.path.abspath(__file__)


def _tensors(value, seen):
    """The tensors of ``value``: itself, or inside its lists, tuples, dicts
    (by key) and the port's objects (by attribute name), each object once."""
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (list, tuple)):
        for item in value:
            yield from _tensors(item, seen)
    elif isinstance(value, dict):
        for key in sorted(value, key=str):
            yield from _tensors(value[key], seen)
    elif type(value).__module__.startswith("keystone_tpu_torch") and id(value) not in seen:
        seen.add(id(value))
        for key, item in sorted(vars(value).items()):
            yield from _tensors(item, seen)


def weights_digest(fitted):
    """(SHA-256, tensor count, elements) of every tensor the fitted
    pipeline's operators hold, in graph order."""
    h = hashlib.sha256()
    count = elements = 0
    seen = set()
    for op in fitted.transformer_graph.operators.values():
        for t in _tensors(op, seen):
            flat = t.detach().reshape(-1).contiguous()
            h.update(str(flat.dtype).encode())
            h.update(flat.view(torch.uint8).cpu().numpy().tobytes())
            count += 1
            elements += flat.numel()
    return h.hexdigest(), count, elements


def streamed_fit(cs, timit, TimitConfig):
    from keystone_tpu_torch.workflow import PipelineEnv

    PipelineEnv.get_or_create().reset()
    config = TimitConfig(solver="streaming", num_cosines=cs.NUM_COSINES, block_size=cs.BLOCK,
                         synthetic_n=cs.STREAM_N, num_epochs=cs.EPOCHS)
    result = timit.run(config, device="cuda")
    PipelineEnv.get_or_create().reset()
    return dict(fit_seconds=result.fit_seconds, train_error=result.train_eval.total_error,
                test_error=result.test_eval.total_error, weights=weights_digest(result.fitted))


def optimizer_bound_fit(cs, timit, TimitConfig):
    from keystone_tpu_torch.data.loaders import synthetic_timit
    from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
    from keystone_tpu_torch.ops.learning.streaming_ls import StreamingLeastSquaresChoice
    from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels, MaxClassifier
    from keystone_tpu_torch.workflow import PipelineEnv

    config = TimitConfig(solver="streaming", num_cosines=cs.NUM_COSINES, block_size=cs.BLOCK,
                         synthetic_n=cs.N_TRAIN, num_epochs=cs.EPOCHS)
    PipelineEnv.get_or_create().reset()
    train = synthetic_timit(cs.N_TRAIN, seed=config.seed, device="cuda")
    test = synthetic_timit(cs.N_TRAIN // 4, seed=config.seed + 1, device="cuda")
    labels = ClassLabelIndicatorsFromIntLabels(cs.K)(train.labels)
    pipeline = timit.build_featurizer(config, "cuda").and_then(
        StreamingLeastSquaresChoice(num_iter=cs.EPOCHS, lam=0.0, block_size_hint=cs.BLOCK),
        train.data, labels,
    ).and_then(MaxClassifier())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitted = pipeline.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    evaluator = MulticlassClassifierEvaluator(cs.K)
    errors = [evaluator.evaluate(fitted.apply(part.data), part.labels).total_error
              for part in (train, test)]
    PipelineEnv.get_or_create().reset()
    return dict(fit_seconds=fit_s, train_error=errors[0], test_error=errors[1],
                weights=weights_digest(fitted))


def sparse_f32_fit(cs, cuda_ops, rows):
    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.ops.learning.lbfgs import SparseLBFGSwithL2

    (idx, vals, cls, Y), (tidx, tvals, tcls, _) = rows
    n = idx.shape[0]
    train = Dataset({"indices": idx, "values": vals}, n=n)
    test = Dataset({"indices": tidx, "values": tvals}, n=tidx.shape[0])
    est = SparseLBFGSwithL2(lam=cs.AMAZON_LAM, num_iterations=cs.AMAZON_ITERS,
                            num_features=cs.AMAZON_D, gram_chunk_rows=cs.AMAZON_CHUNK,
                            solver="gram", gram_dtype="f32")
    fitted, fit_s, counts, _ = cs._sparse_fit(cuda_ops, est, train, Dataset(Y))
    return dict(fit_seconds=fit_s, launches=counts["gram_corr_sym_acc"],
                train_accuracy=cs._accuracy(fitted.apply(train), cls),
                test_accuracy=cs._accuracy(fitted.apply(test), tcls),
                weights=weights_digest(fitted))


def cifar_fit(cs):
    from keystone_tpu_torch.pipelines import cifar
    from keystone_tpu_torch.workflow import PipelineEnv

    PipelineEnv.get_or_create().reset()
    result = cifar.run_random_patch_cifar_kernel(cs.cifar_config(cifar), device="cuda")
    PipelineEnv.get_or_create().reset()
    return dict(fit_seconds=result.fit_seconds, apply_seconds=result.apply_seconds,
                train_error=result.train_eval.total_error,
                test_error=result.test_eval.total_error, weights=weights_digest(result.fitted))


ROUTES = ("streamed TIMIT", "optimizer-bound streamed", "sparse gram f32", "CIFAR")


def child(root, routes):
    """Both fits of each of ``routes`` with ``root``'s package; one JSON
    line."""
    sys.path.insert(0, root)
    import chip_smoke as cs
    from keystone_tpu_torch.ops import cuda_ops
    from keystone_tpu_torch.pipelines import timit
    from keystone_tpu_torch.pipelines.timit import TimitConfig

    cuda_ops.build()
    dev = torch.device("cuda")
    rows = None
    if "sparse gram f32" in routes:
        w_true = cs.planted_model(cs.AMAZON_D, 2)
        rows = [[torch.from_numpy(a).to(dev) for a in cs.amazon_rows(
            m, cs.AMAZON_D, cs.AMAZON_NNZ, cs.AMAZON_K, seed, w_true)]
            for m, seed in ((cs.AMAZON_N, 1), (cs.AMAZON_N // 4, 3))]
    fits = {"streamed TIMIT": lambda: streamed_fit(cs, timit, TimitConfig),
            "optimizer-bound streamed": lambda: optimizer_bound_fit(cs, timit, TimitConfig),
            "sparse gram f32": lambda: sparse_f32_fit(cs, cuda_ops, rows),
            "CIFAR": lambda: cifar_fit(cs)}
    out = {name: [fits[name]() for _ in range(2)] for name in routes}
    print(json.dumps(out))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", nargs="+", help="the checkouts to run, in turns")
    parser.add_argument("--routes", nargs="+", choices=ROUTES, default=list(ROUTES),
                        help="the routes to fit (default: all)")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    parser.add_argument("--out", default="build/torch_route_bits.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_route_bits: no CUDA device is available", file=sys.stderr)
        return 2
    if args.child:
        return child(os.path.abspath(args.child), args.routes)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    roots = [os.path.abspath(root) for root in args.root]
    order = list(range(len(roots))) + list(reversed(range(len(roots))))
    turns, first = [], {}
    for i in order:
        proc = subprocess.run([sys.executable, _SCRIPT, "--child", roots[i], "--routes",
                               *args.routes], cwd=roots[i], capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"the child for {roots[i]} failed ({proc.returncode})")
        routes = json.loads(proc.stdout.strip().splitlines()[-1])
        for name, fits in routes.items():
            ref = first.setdefault(name, fits[0]["weights"][0])
            for r in fits:
                r["bits_of_first_root"] = r["weights"][0] == ref
                print(f"{roots[i]}: {name}: fit {r['fit_seconds']:.3f} s, "
                      + ", ".join(f"{key} {value}" for key, value in r.items()
                                  if key not in ("fit_seconds", "weights"))
                      + f", weights {r['weights'][0][:16]} ({r['weights'][1]} tensors, "
                      f"{r['weights'][2]} elements)")
        turns.append(dict(root=roots[i], routes=routes))
    print(card)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, turns=turns), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
