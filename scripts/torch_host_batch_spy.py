"""Which bundled pipelines of the port send a host collection through
``Transformer.batch_apply``'s stacked path (ROADMAP A.14)?

Runs each pipeline on the CPU at its CPU test's small size with a spy on
the inherited ``Transformer.batch_apply`` (host collections it is handed,
by node) and on ``workflow.pipeline._stack_items`` (collections that
stacked into one ``device_fn`` call, by batch shape), and prints one line
a pipeline. TIMIT and MNIST are left out: their datasets are arrays from
the loader on, so no host collection reaches a node.

    python3 scripts/torch_host_batch_spy.py
"""

import collections
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from keystone_tpu_torch.pipelines import (  # noqa: E402
    amazon_reviews, cifar, imagenet_sift_lcs_fv, newsgroups, voc_sift_fisher,
)
from keystone_tpu_torch.workflow import pipeline  # noqa: E402

RUNS = {
    "VOCSIFTFisher": lambda: voc_sift_fisher.run(voc_sift_fisher.VOCConfig(
        descriptor_dim=16, vocab_size=4, block_size=64, synthetic_n=12), device="cpu"),
    "ImageNetSiftLcsFV": lambda: imagenet_sift_lcs_fv.run(imagenet_sift_lcs_fv.ImageNetConfig(
        sift_pca_dim=16, lcs_pca_dim=16, vocab_size=4, block_size=128, synthetic_n=16,
        synthetic_classes=4), device="cpu"),
    "AmazonReviews": lambda: amazon_reviews.run(amazon_reviews.AmazonReviewsConfig(
        synthetic_n=300, common_features=200, num_iters=10), device="cpu"),
    "Newsgroups": lambda: newsgroups.run(newsgroups.NewsgroupsConfig(
        synthetic_n=240, synthetic_classes=6), device="cpu"),
    "RandomPatchCifarKernel": lambda: cifar.run_random_patch_cifar_kernel(cifar.CifarConfig(
        synthetic_n=192, num_filters=24, whitener_size=300, block_size=216), device="cpu"),
}


def main() -> int:
    handed, stacked = collections.Counter(), collections.Counter()
    batch_apply, stack_items = pipeline.Transformer.batch_apply, pipeline._stack_items

    def spy_batch_apply(self, data):
        if data.is_host:
            handed[type(self).__name__] += 1
        return batch_apply(self, data)

    def spy_stack_items(items):
        batch = stack_items(items)
        stacked[tuple(batch.shape)] += 1
        return batch

    pipeline.Transformer.batch_apply = spy_batch_apply
    pipeline._stack_items = spy_stack_items
    try:
        for name, run in RUNS.items():
            handed.clear()
            stacked.clear()
            run()
            print(f"{name}: host collections handed to Transformer.batch_apply "
                  f"{dict(handed)}; stacked {dict(stacked)}", flush=True)
    finally:
        pipeline.Transformer.batch_apply = batch_apply
        pipeline._stack_items = stack_items
    return 0


if __name__ == "__main__":
    sys.exit(main())
