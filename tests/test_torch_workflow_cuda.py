"""Card-only cases of the port's workflow layer: single-datum programs
captured as CUDA graphs and replayed, the launch counters across replays,
the kernel wrappers' meta branches against their kernels' real outputs, and
the plan verifier's allocations on the card.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without
one. The file imports neither JAX nor the JAX package, so that it runs on
the machine with the card: ``python -m pytest
tests/test_torch_workflow_cuda.py -m cuda --noconftest``.

Tolerances: a replayed datum equals the same program's first (eager) run
bit for bit (the same kernels on the same inputs); against the batch apply
of the same rows 1e-6 relative (a one-row GEMM and a many-row GEMM sum in
different orders).
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.ops import cuda_images, cuda_ops


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels run only on the card")
    return torch.device("cuda")


def _fitted_cosine_ridge(device, n=512, d_in=24, d=64, k=3):
    """A fitted cosine featurizer -> LinearMapper on the card (the fit
    fuses the featurizer into LinearMapEstimator's fit)."""
    from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator
    from keystone_tpu_torch.ops.stats import CosineRandomFeatures
    from keystone_tpu_torch.workflow import PipelineEnv

    PipelineEnv.get_or_create().reset()
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.normal(size=(n, d_in)).astype(np.float32)).to(device)
    Y = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32)).to(device)
    crf = CosineRandomFeatures(d_in, d, 0.3, seed=0, device=device)
    fitted = crf.to_pipeline().and_then(LinearMapEstimator(lam=1e-2), Dataset(X),
                                        Dataset(Y)).fit()
    return fitted, X


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.cuda
class TestDatumProgramsOnCard:
    def test_capture_once_then_replay(self, cuda_device):
        fitted, X = _fitted_cosine_ridge(cuda_device)
        batch = fitted.apply(Dataset(X[:8])).array
        outs = [fitted.apply(X[i]) for i in range(8)]
        (program,) = fitted._datum_programs.values()
        assert program.mode == "graph" and program.captures == 1 and program.replays == 7
        assert program.launches_per_replay == {"cosine_features": 1, "row_stable_matmul": 1}
        for i, y in enumerate(outs):
            assert y.is_cuda and y.shape == batch[i].shape
            assert _rel(y, batch[i]) <= 1e-6
        again = fitted.apply(X[0])
        assert torch.equal(again, outs[0])

    def test_launch_counts_include_replays(self, cuda_device):
        fitted, X = _fitted_cosine_ridge(cuda_device)
        fitted.apply(X[0])
        cuda_ops.reset_launch_counts()
        for i in range(10):
            fitted.apply(X[i])
        assert cuda_ops.launches["cosine_features"] == 10
        assert cuda_ops.launches["row_stable_matmul"] == 10
        assert sum(cuda_ops.launches.values()) == 20

    def test_first_call_counts_its_eager_launches_only(self, cuda_device):
        fitted, X = _fitted_cosine_ridge(cuda_device)
        cuda_ops.reset_launch_counts()
        fitted.apply(X[0])  # eager run + capture (which launches nothing)
        assert cuda_ops.launches["cosine_features"] == 1

    def test_results_survive_later_replays(self, cuda_device):
        fitted, X = _fitted_cosine_ridge(cuda_device)
        first = fitted.apply(X[1])
        second = fitted.apply(X[2])
        kept = second.clone()
        fitted.apply(X[3])
        assert torch.equal(second, kept) and not torch.equal(first, second)

    def test_host_datum_and_new_shape(self, cuda_device):
        fitted, X = _fitted_cosine_ridge(cuda_device)
        host = X[5].cpu().numpy()
        a, b = fitted.apply(host), fitted.apply(host)
        assert a.is_cuda and torch.equal(a, b)
        assert _rel(a, fitted.apply(X[5])) <= 1e-6
        assert len(fitted._datum_programs) == 2  # numpy and tensor datums

    def test_capture_failure_raises_and_names_the_node(self, cuda_device):
        from keystone_tpu_torch.workflow import FittedPipeline, Transformer, TransformerGraph

        class ReadsHost(Transformer):
            def apply(self, x):
                return x

            def device_fn(self):
                return lambda X: X * float(X.sum().item())

        pipe = ReadsHost().to_pipeline()
        fitted = FittedPipeline(TransformerGraph.from_graph(pipe.executor.graph),
                                pipe.source, pipe.sink)
        x = torch.ones(4, device=cuda_device)
        stream = torch.cuda.current_stream()
        with pytest.raises(RuntimeError) as exc:
            fitted.apply(x)  # the eager run passes, the capture does not
        assert "capture" in str(exc.value) and "ReadsHost" in str(exc.value)
        (program,) = fitted._datum_programs.values()
        assert program.mode is None and program.captures == 0
        # The card is left as it was: its stream, and random draws.
        assert torch.cuda.current_stream() == stream
        assert torch.randn(8, device=cuda_device).shape == (8,)

    def test_verifier_allocates_nothing_on_the_card(self, cuda_device):
        from keystone_tpu_torch.ops.stats import CosineRandomFeatures
        from keystone_tpu_torch.ops.util import VectorCombiner
        from keystone_tpu_torch.workflow import Pipeline, verify

        branches = [CosineRandomFeatures(440, 4096, 0.05, seed=i, device=cuda_device)
                    .to_pipeline() for i in range(8)]
        pipe = Pipeline.gather(branches).and_then(VectorCombiner())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        before = dict(cuda_ops.launches)
        report = verify.verify_graph(
            pipe.executor.graph,
            source_sigs={pipe.source: verify.ArraySig((1_000_000, 440), "float32")})
        assert not report.findings
        assert report.sigs[pipe.sink].describe() == "batch f[1000000,32768]:float32"
        assert torch.cuda.max_memory_allocated() == start
        assert dict(cuda_ops.launches) == before


@pytest.mark.cuda
class TestMetaBranchesOnCard:
    @pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
    def test_cosine_meta_shape_is_the_kernels(self, cuda_device, out_dtype, compute):
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        X = torch.randn(300, 440, generator=gen, device=cuda_device)
        W = torch.randn(513, 440, generator=gen, device=cuda_device)
        b = torch.rand(513, generator=gen, device=cuda_device)
        before = dict(cuda_ops.launches)
        meta = cuda_ops.cosine_features(X.to("meta"), W, b, compute_dtype=compute,
                                        out_dtype=out_dtype)
        assert dict(cuda_ops.launches) == before
        real = cuda_ops.cosine_features(X, W, b, compute_dtype=compute, out_dtype=out_dtype)
        assert meta.device.type == "meta"
        assert (meta.shape, meta.dtype) == (real.shape, real.dtype)

    def test_cosine_meta_window(self, cuda_device):
        W = torch.randn(16, 8, device=cuda_device)
        b = torch.rand(16, device=cuda_device)
        window = torch.empty(5, 40, device="meta")[:, 8:24]
        assert cuda_ops.cosine_features(torch.empty(5, 8, device="meta"), W, b,
                                        out=window) is window

    def test_conv_meta_shape_is_the_kernels(self, cuda_device):
        gen = torch.Generator(device=cuda_device).manual_seed(1)
        images = torch.rand(6, 32, 32, 3, generator=gen, device=cuda_device) * 255
        filters = torch.randn(100, 6 * 6 * 3, generator=gen, device=cuda_device)
        means = torch.randn(6 * 6 * 3, generator=gen, device=cuda_device)
        before = dict(cuda_ops.launches)
        meta = cuda_images.conv_featurize(images.to("meta"), filters, means, patch_size=6)
        assert dict(cuda_ops.launches) == before
        real = cuda_images.conv_featurize(images, filters, means, patch_size=6)
        assert meta.device.type == "meta"
        assert (meta.shape, meta.dtype) == (real.shape, real.dtype)

    def test_meta_checks_still_raise(self, cuda_device):
        W = torch.randn(16, 8, device=cuda_device)
        with pytest.raises(ValueError):
            cuda_ops.cosine_features(torch.empty(5, 7, device="meta"), W,
                                     torch.rand(16, device=cuda_device))
        with pytest.raises(ValueError):  # the real operands on two devices
            cuda_ops.cosine_features(torch.empty(5, 8, device="meta"), W, torch.rand(16))
        with pytest.raises(ValueError):
            cuda_images.conv_featurize(torch.empty(2, 10, 10, 3, device="meta"),
                                       torch.randn(8, 27, device=cuda_device),
                                       torch.zeros(26, device=cuda_device), patch_size=3)
