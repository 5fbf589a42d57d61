"""Utilities (port of ``keystone_tpu/utils/__init__.py``): the image
helpers of ``images.py`` and ``stats.about_eq``."""
