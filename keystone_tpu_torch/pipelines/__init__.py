"""Example end-to-end pipelines (port of ``keystone_tpu/pipelines/__init__.py``).

Launch by name via ``python -m keystone_tpu_torch.run <Name>``; modules are
imported lazily.
"""

__all__ = ["cifar", "timit"]
