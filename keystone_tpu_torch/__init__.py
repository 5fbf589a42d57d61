"""keystone_tpu_torch: the PyTorch/CUDA port of keystone_tpu.

Port of ``keystone_tpu/__init__.py``. The same pipeline framework —
lazily-executed typed DAGs of Transformers and Estimators, a rule-based
whole-pipeline optimizer with cross-pipeline state reuse, featurization
nodes and block solvers — over ``torch.Tensor`` on one CUDA device, with
the hot ops as hand-written CUDA kernels (``ops/cuda_ops.py``,
``csrc/``).

Entry points take an explicit ``device``. Left unset it means the CUDA
device; without one they raise instead of running on the CPU, so a run
that was meant for the card never quietly measures the host. Pass
``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""

import torch

# f32 means f32, the counterpart of keystone_tpu/__init__.py's matmul
# precision pin: float32 products run in full float32, never through
# TF32's 10-bit mantissa (the BCD solves and the Cholesky rescue test
# depend on it). bf16 compute is an explicit operand dtype only.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def default_device() -> torch.device:
    """The CUDA device, or an error when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "keystone_tpu_torch: no CUDA device is available; pass "
            "device='cpu' explicitly to run on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means :func:`default_device`.
    Asking for CUDA without a CUDA device raises."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        return default_device()  # raises with the message above
    return device


from keystone_tpu_torch.data import Dataset, LabeledData  # noqa: E402
from keystone_tpu_torch.workflow import (  # noqa: E402
    Chainable,
    Estimator,
    FittedPipeline,
    LabelEstimator,
    Pipeline,
    PipelineDataset,
    PipelineDatum,
    PipelineEnv,
    Transformer,
    transformer,
)

__version__ = "0.1.0"

__all__ = [
    "default_device",
    "resolve_device",
    "Dataset",
    "LabeledData",
    "Chainable",
    "Estimator",
    "FittedPipeline",
    "LabelEstimator",
    "Pipeline",
    "PipelineDataset",
    "PipelineDatum",
    "PipelineEnv",
    "Transformer",
    "transformer",
]
