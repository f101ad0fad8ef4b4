"""PyTorch/CUDA port of forest_slam_tpu for NVIDIA Hopper (H100).

The JAX package ``forest_slam_tpu`` stays the reference; this package keeps
its layout (frontend/, stereo/, geometry/, core/, pipelines/, io/, eval/,
train/).
Each Pallas kernel on the ported path has a hand-written CUDA counterpart
under ``csrc/``, built by ``_build.py`` and bound with ctypes, beside a plain
PyTorch version that the CPU tests use.
"""
