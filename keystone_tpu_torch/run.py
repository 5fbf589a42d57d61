"""Command-line entry point: ``python -m keystone_tpu_torch.run <Pipeline> [flags]``.

Port of ``keystone_tpu/run.py``. Ported so far:

  - TimitPipeline, with ``--solver block`` (the resident block solver, the
    default) and ``--solver streaming`` (the out-of-core tile-streamed
    fit); ``--solver auto`` is not ported yet;
  - RandomPatchCifarKernel (the CIFAR random-patch featurizer and Gaussian
    kernel ridge regression), with the reference's flags plus
    ``--syntheticN`` (training images of the synthetic data), e.g.
    ``python -m keystone_tpu_torch.run RandomPatchCifarKernel --syntheticN 50000``.

Pipelines run on the CUDA device unless given ``--device cpu``.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict


def _timit(argv):
    from keystone_tpu_torch.pipelines import timit

    timit.main(argv)


def _cifar_kernel(argv):
    from keystone_tpu_torch.pipelines import cifar

    cifar.main(argv)


PIPELINES: Dict[str, Callable] = {
    "TimitPipeline": _timit,
    "Timit": _timit,
    "RandomPatchCifarKernel": _cifar_kernel,
}


def resolve(name: str) -> Callable:
    """Accept bare or fully-qualified (dotted) pipeline names."""
    bare = name.rsplit(".", 1)[-1]
    if bare not in PIPELINES:
        known = ", ".join(sorted(PIPELINES))
        raise SystemExit(f"Unknown pipeline {name!r}. Known pipelines: {known}")
    return PIPELINES[bare]


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("Pipelines:", ", ".join(sorted(PIPELINES)))
        return 0
    resolve(argv[0])(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
