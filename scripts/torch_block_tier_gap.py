"""The block-streamed tier against the stacked solve (``--solver block``
apply first) on TIMIT-shaped rows, in float32 and with float64 features.

    python3 scripts/torch_block_tier_gap.py [--rows 65536] [--block 4096]
                                            [--device cpu] [--threads 6]

``chip_smoke.py`` phase 12(b) holds the two on the card at phase 2's rows
and draws (``synthetic_timit`` of 65,536 rows, seed 123, four cosine
branches of 4,096, 3 epochs, λ 0). This runs the same pair on the CPU (or
another device), once on float32 features and once on the same features
cast to float64 (the stacked solve then centres and solves in float64;
the tier makes float64 slabs), and prints each gap (relative Frobenius, the
weights and the affine offset), the feature means' gap, and each program's
distance from its float64 self. A gap that float64 closes is rounding; one
that stays comes from the two programs. At phase 2's size it holds about
10 GB and takes a few minutes on 6 CPU threads.
"""

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from keystone_tpu_torch.data.loaders import synthetic_timit  # noqa: E402
from keystone_tpu_torch.ops import cuda_ops  # noqa: E402
from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels  # noqa: E402
from keystone_tpu_torch.parallel import linalg, streaming  # noqa: E402
from keystone_tpu_torch.pipelines import timit  # noqa: E402

BRANCHES, K, EPOCHS = 4, 147, 3


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, default=65536)
    parser.add_argument("--block", type=int, default=4096)
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--threads", type=int, default=6)
    args = parser.parse_args()
    torch.set_num_threads(args.threads)
    n, bs, dev = args.rows, args.block, args.device
    config = timit.TimitConfig(solver="block", num_cosines=BRANCHES, block_size=bs,
                               synthetic_n=n, num_epochs=EPOCHS)
    train = synthetic_timit(n, seed=config.seed, device=dev)
    X = train.data.array
    Y = ClassLabelIndicatorsFromIntLabels(K)(train.labels).array
    rfs = timit._cosine_models(config, dev)
    Wrf, brf = torch.cat([rf.W for rf in rfs]), torch.cat([rf.b for rf in rfs])
    models = {}
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        # --solver block apply first: explicitly centred blocks, the stacked sweep.
        stacked = torch.empty((BRANCHES, n, bs), dtype=dtype, device=dev)
        fmean = []
        for b in range(BRANCHES):
            F = cuda_ops.cosine_features(X, Wrf[b * bs:(b + 1) * bs], brf[b * bs:(b + 1) * bs])
            F = F.to(dtype)
            fmean.append(F.sum(dim=0) / n)
            stacked[b] = F - fmean[-1]
            del F
        ymean = Y.to(dtype).sum(dim=0) / n
        W_s = torch.stack(list(linalg.bcd_least_squares_fused(
            stacked, Y.to(dtype) - ymean, lam=0.0, num_iter=EPOCHS))).reshape(-1, K)
        del stacked
        t1 = time.perf_counter()
        W_t, fmean_t, ymean_t = streaming.streaming_block_bcd_mesh(
            X, Y, Wrf, brf, block_size=bs, lam=0.0, num_iter=EPOCHS, feat_dtype=dtype,
            center=True)
        W_t = W_t.reshape(-1, K)
        t2 = time.perf_counter()
        fmean = torch.cat(fmean)
        off_s = ymean.double() - fmean.double() @ W_s.double()
        off_t = ymean_t.double() - fmean_t.double() @ W_t.double()
        print(f"{str(dtype)[6:]} features, n {n}, blocks of {bs}: weights gap "
              f"{rel(W_t, W_s):.3e}, offset gap {rel(off_t, off_s):.3e}, feature means gap "
              f"{rel(fmean_t, fmean):.3e} (stacked {t1 - t0:.1f} s, tier {t2 - t1:.1f} s)",
              flush=True)
        models[dtype] = (W_s, W_t)
    for i, name in enumerate(("stacked solve", "block tier")):
        print(f"{name}: float32 from float64 "
              f"{rel(models[torch.float32][i], models[torch.float64][i]):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
