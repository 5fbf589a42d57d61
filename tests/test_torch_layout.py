"""Layout and device rules of the PyTorch port (keystone_tpu_torch/).

  - Neither the port nor the scripts that drive it on the card
    (chip_smoke.py, scripts/torch_*.py) import JAX, the JAX package, optax
    or ml_dtypes, at any scope (an AST scan, so lazy imports inside
    functions count too).
  - The port mirrors the JAX package file for file, and each module's
    docstring names its counterpart.
  - Entry points raise without a CUDA device unless given device="cpu".
  - The package pins float32 products to full float32 (no TF32).
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import keystone_tpu_torch
from keystone_tpu_torch import interop
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
    return top in ("jax", "jaxlib", "keystone_tpu", "optax", "ml_dtypes")


def test_port_has_modules():
    rels = {p.relative_to(PORT).as_posix() for p in PORT_FILES}
    for rel in ("__init__.py", "ops/cuda_ops.py", "ops/stats.py", "parallel/linalg.py",
                "ops/learning/block.py", "ops/learning/linear.py", "workflow/fusion.py",
                "parallel/streaming.py", "ops/learning/streaming_ls.py",
                "pipelines/timit.py", "interop.py", "run.py",
                "utils/images.py", "ops/images/core.py", "ops/images/conv.py",
                "ops/cuda_images.py", "ops/learning/pca.py", "ops/learning/kernel.py",
                "pipelines/cifar.py", "data/resident.py", "ops/sparse.py",
                "ops/learning/lbfgs.py", "ops/learning/sketch.py", "ops/learning/cost.py",
                "ops/nlp.py", "ops/learning/classifiers.py", "pipelines/mnist_random_fft.py",
                "pipelines/amazon_reviews.py", "ops/images/sift.py", "ops/images/lcs.py",
                "ops/images/fisher.py", "ops/learning/clustering.py", "ops/learning/bwls.py",
                "ops/learning/classstats.py", "pipelines/voc_sift_fisher.py",
                "pipelines/imagenet_sift_lcs_fv.py", "pipelines/newsgroups.py",
                "pipelines/stupid_backoff.py", "ops/lemmatizer.py", "utils/stats.py",
                "workflow/verify.py", "workflow/autocache.py", "tools/__init__.py",
                "tools/dryrun.py", "utils/faults.py", "utils/profiling.py",
                "obs/__init__.py", "obs/metrics.py", "obs/flight.py", "obs/tracer.py",
                "obs/slo.py", "obs/export.py", "data/durable.py", "serving/__init__.py",
                "serving/export.py", "serving/batcher.py", "serving/loadgen.py",
                "serving/replicas.py", "serving/lifecycle.py", "placement/__init__.py",
                "placement/engine.py", "data/runtime.py", "learning/__init__.py",
                "learning/continuous.py", "data/prefetch.py", "data/shards.py",
                "data/images.py", "native/__init__.py", "serving/zoo.py",
                "serving/autoscale.py", "obs/calibrate.py", "obs/live.py",
                "placement/planner.py", "tools/calibrate.py", "tools/trace.py",
                "tools/slo.py", "tools/plan.py", "serving/fleet_rpc.py",
                "serving/fleet_plane.py", "serving/fleet.py", "tools/fleet_chaos.py",
                "parallel/mesh.py", "tools/multichip.py"):
        assert rel in rels


@pytest.mark.parametrize(
    "path", PORT_FILES + [ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("torch_*.py")),
    ids=lambda p: p.relative_to(ROOT).as_posix(),
)
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize(
    "path", [ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("torch_*.py")),
    ids=lambda p: p.relative_to(ROOT).as_posix(),
)
def test_top_level_names_are_defined_once(path):
    """A second top-level function or class of one name silently replaces
    the first for every phase that calls it."""
    names = [node.name for node in ast.parse(path.read_text()).body
             if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))]
    assert not {n for n in names if names.count(n) > 1}


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


def _reference_exports(rel: str, module: str):
    """The names a reference package ``__init__`` imports from one of its
    modules (parsed, not imported)."""
    tree = ast.parse((ROOT / "keystone_tpu" / rel).read_text())
    return sorted(alias.name for node in ast.walk(tree)
                  if isinstance(node, ast.ImportFrom) and node.level == 1 and node.module == module
                  for alias in node.names)


def test_learning_package_exports_the_streaming_tiers():
    # The streamed tiers' public names, the block-streamed one and the
    # cosine bank's factory among them, as the reference's learning
    # package exports them.
    from keystone_tpu_torch.ops import learning

    names = _reference_exports("ops/learning/__init__.py", "streaming_ls")
    assert "BlockStreamedLeastSquares" in names and "cosine_bank_featurize" in names
    for name in names:
        assert name in learning.__all__ and hasattr(learning, name), name


@pytest.mark.parametrize("module", ["autoscale", "zoo", "loadgen", "replicas", "batcher",
                                    "export", "lifecycle"])
def test_serving_package_exports_the_references(module):
    # Every name the reference's serving package takes from each of its
    # modules (the zoo, the autoscaler, the multi-tenant loadgen among
    # them); the process fleet's modules (serving/fleet*.py) are imported
    # by module path in both packages, not re-exported.
    from keystone_tpu_torch import serving

    names = _reference_exports("serving/__init__.py", module)
    assert names
    for name in names:
        assert name in serving.__all__ and hasattr(serving, name), name


def test_kernel_sources_sit_beside_the_package():
    # gram_corr.cu holds the kernels of four TPU kernels (gram_corr_sym,
    # gram_corr, block_gram_sym and gram_sym_acc).
    sources = sorted(p.name for p in (PORT / "csrc").glob("*.cu"))
    assert sources == [
        "block_corr.cu", "block_residual_update.cu",
        "conv_featurize.cu", "cosine_features.cu", "countsketch_scatter.cu",
        "gaussian_kernel_block.cu", "gaussian_resid_block.cu", "gram_corr.cu",
        "gram_corr_sym_acc.cu", "row_stable_matmul.cu",
    ]
    for src in sources:
        text = (PORT / "csrc" / src).read_text()
        if src == "row_stable_matmul.cu":
            # The one kernel with no TPU twin: C.8's repair.
            assert "Replaces no TPU kernel" in text and "C.8" in text
        else:
            assert any(
                f"Replaces the TPU kernel keystone_tpu/ops/{ref}" in text
                for ref in ("pallas_ops.py", "pallas_images.py")
            )
        assert "Bound on an H100" in text


def _tpu_kernels():
    """(file, function) of each reference function that reaches
    ``pl.pallas_call``, from the JAX package's source (parsed, not
    imported)."""
    found = []
    for rel in ("ops/pallas_ops.py", "ops/pallas_images.py"):
        tree = ast.parse((ROOT / "keystone_tpu" / rel).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef) and any(
                    isinstance(sub, ast.Attribute) and sub.attr == "pallas_call"
                    for sub in ast.walk(node)):
                found.append((rel.split("/")[1], node.name))
    return found


def test_every_tpu_kernel_is_named_by_a_source():
    # Each of the reference's twelve Pallas kernels is replaced by a
    # hand-written kernel whose source says so (one source may replace
    # several).
    kernels = _tpu_kernels()
    assert len(kernels) == 12
    texts = [p.read_text() for p in sorted((PORT / "csrc").glob("*.cu"))]
    for file, name in kernels:
        line = re.compile(rf"Replaces the TPU kernel keystone_tpu/ops/{file}:{name}\b")
        assert any(line.search(text) for text in texts), f"no source replaces {file}:{name}"


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
        with pytest.raises(RuntimeError):
            interop.sparse_linear_mapper(np.zeros((4, 2)), np.zeros(2))

    @pytest.mark.parametrize("runner", ["LinearPixels", "RandomCifar", "RandomPatchCifar",
                                        "RandomPatchCifarAugmented"])
    def test_cifar_runners_raise_without_cuda(self, no_cuda, runner):
        with pytest.raises(RuntimeError):
            cifar.RUNNERS[runner](cifar.CifarConfig(synthetic_n=16, num_filters=2,
                                                    whitener_size=20))

    def test_newsgroups_raises_without_cuda(self, no_cuda):
        from keystone_tpu_torch.pipelines import newsgroups
        with pytest.raises(RuntimeError):
            newsgroups.run(newsgroups.NewsgroupsConfig(synthetic_n=16))

    def test_cpu_must_be_asked_for(self):
        data = synthetic_timit(16, seed=0, device="cpu")
        assert data.data.array.device == torch.device("cpu")
        assert data.data.array.dtype == torch.float32


def test_float32_products_stay_float32():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("demangled,want", [
    ("void <unnamed>::corr_kernel<float, (int)10, (bool)1>(float const*, float*, int)",
     "void <unnamed>::corr_kernel<float, (int)10, (bool)1>"),
    ("void (anonymous namespace)::gram_kernel<float>(float const*)",
     "void (anonymous namespace)::gram_kernel<float>"),
    ("<unnamed>::histogram_kernel(int const*, int*)", "<unnamed>::histogram_kernel"),
    ("_ZN7kt_pipe11corr_kernel", "_ZN7kt_pipe11corr_kernel"),
])
def test_chip_smoke_kernel_names_keep_template_arguments(demangled, want):
    """chip_smoke.py prints ptxas registers a kernel instance: only the
    parameter list is cut from its name, so instances stay apart."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.without_parameters(demangled) == want
