"""Continuous-learning layer: trainers that re-fit pipelines as data
arrives and publish them through the serving lifecycle controller (port
of ``keystone_tpu/learning/__init__.py``).

  - :class:`TimedSegmentFeed` — arriving (X, y) shard segments with
    arrival stamps, index-addressable so a resumed trainer re-reads
    exactly the segments an uninterrupted one would have.
  - :class:`ContinuousTrainer` — incrementally folds normal equations
    over arriving segments on the checkpoint/resume machinery (a killed
    trainer resumes BIT-IDENTICALLY and republishes), and every K
    segments hands a candidate ``FittedPipeline`` to a
    :class:`~keystone_tpu_torch.serving.lifecycle.LifecycleController`
    for validation-gated, canaried publication.
"""

from .continuous import ContinuousTrainer, TimedSegmentFeed

__all__ = ["ContinuousTrainer", "TimedSegmentFeed"]
