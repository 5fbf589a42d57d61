"""Utilities (port of ``keystone_tpu/utils/__init__.py``; only the image
helpers the CIFAR slice needs so far)."""
