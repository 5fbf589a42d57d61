"""Layout and device rules of the PyTorch port (keystone_tpu_torch/).

  - Neither the port nor the scripts that drive it on the card
    (chip_smoke.py, scripts/torch_timit_profile.py) import JAX or the JAX
    package, at any scope (an AST scan, so lazy imports inside functions
    count too).
  - The port mirrors the JAX package file for file, and each module's
    docstring names its counterpart.
  - Entry points raise without a CUDA device unless given device="cpu".
  - The package pins float32 products to full float32 (no TF32).
"""

import ast
from pathlib import Path

import pytest
import torch

import keystone_tpu_torch
from keystone_tpu_torch.data.loaders import synthetic_cifar, synthetic_timit
from keystone_tpu_torch.ops.stats import CosineRandomFeatures
from keystone_tpu_torch.pipelines import cifar, timit

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "keystone_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py"))
# Port modules without a same-named reference module, and what they name.
COUNTERPARTS = {
    "ops/cuda_ops.py": "keystone_tpu/ops/pallas_ops.py",
    "ops/cuda_images.py": "keystone_tpu/ops/pallas_images.py",
    "interop.py": None,
}


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "keystone_tpu")


def test_port_has_modules():
    rels = {p.relative_to(PORT).as_posix() for p in PORT_FILES}
    for rel in ("__init__.py", "ops/cuda_ops.py", "ops/stats.py", "parallel/linalg.py",
                "ops/learning/block.py", "ops/learning/linear.py", "workflow/fusion.py",
                "parallel/streaming.py", "ops/learning/streaming_ls.py",
                "pipelines/timit.py", "interop.py", "run.py",
                "utils/images.py", "ops/images/core.py", "ops/images/conv.py",
                "ops/cuda_images.py", "ops/learning/pca.py", "ops/learning/kernel.py",
                "pipelines/cifar.py"):
        assert rel in rels


@pytest.mark.parametrize(
    "path", PORT_FILES + [ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_timit_profile.py"],
    ids=lambda p: p.relative_to(ROOT).as_posix(),
)
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(PORT).as_posix())
def test_module_names_its_counterpart(path):
    rel = path.relative_to(PORT).as_posix()
    counterpart = COUNTERPARTS.get(rel, f"keystone_tpu/{rel}")
    if counterpart is None:
        return
    assert (ROOT / counterpart).exists(), f"{rel} mirrors no reference file"
    doc = ast.get_docstring(ast.parse(path.read_text())) or ""
    assert counterpart in doc or counterpart.split("/", 1)[1] in doc, (
        f"{rel}'s docstring does not name {counterpart}"
    )


def test_kernel_sources_sit_beside_the_package():
    sources = sorted(p.name for p in (PORT / "csrc").glob("*.cu"))
    assert sources == [
        "block_corr.cu", "block_gram_sym.cu", "block_residual_update.cu",
        "conv_featurize.cu", "cosine_features.cu", "gaussian_kernel_block.cu",
        "gaussian_resid_block.cu", "gram_corr_sym.cu", "gram_sym_acc.cu",
    ]
    for src in sources:
        text = (PORT / "csrc" / src).read_text()
        assert any(
            f"Replaces the TPU kernel keystone_tpu/ops/{ref}" in text
            for ref in ("pallas_ops.py", "pallas_images.py")
        )
        assert "Bound on an H100" in text


class TestDeviceRules:
    @pytest.fixture
    def no_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_default_device_raises_without_cuda(self, no_cuda):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            keystone_tpu_torch.default_device()
        with pytest.raises(RuntimeError):
            keystone_tpu_torch.resolve_device("cuda")
        assert keystone_tpu_torch.resolve_device("cpu") == torch.device("cpu")

    def test_entry_points_raise_without_cuda(self, no_cuda):
        with pytest.raises(RuntimeError):
            synthetic_timit(16, seed=0)
        with pytest.raises(RuntimeError):
            CosineRandomFeatures(4, 4, 1.0, seed=0)
        with pytest.raises(RuntimeError):
            timit.run(timit.TimitConfig(num_cosines=1, block_size=8, synthetic_n=16))
        with pytest.raises(RuntimeError):
            synthetic_cifar(4, seed=0)
        with pytest.raises(RuntimeError):
            cifar.run_random_patch_cifar_kernel(
                cifar.CifarConfig(synthetic_n=16, num_filters=2, whitener_size=20))

    def test_cpu_must_be_asked_for(self):
        data = synthetic_timit(16, seed=0, device="cpu")
        assert data.data.array.device == torch.device("cpu")
        assert data.data.array.dtype == torch.float32


def test_float32_products_stay_float32():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
