"""Node library: featurizers, solvers, plumbing nodes and the CUDA kernels
(port of ``keystone_tpu/ops/__init__.py``)."""
