"""Linear algebra substrate (port of ``keystone_tpu/parallel/__init__.py``;
one device, so no mesh yet)."""
