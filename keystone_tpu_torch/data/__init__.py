"""Data plane: the Dataset abstraction and data loaders (port of
``keystone_tpu/data/__init__.py``; the out-of-core shard tier comes with
a later slice)."""

from .dataset import Dataset, LabeledData, one_hot_pm1

__all__ = ["Dataset", "LabeledData", "one_hot_pm1"]
