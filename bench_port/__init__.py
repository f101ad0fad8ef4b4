"""The benchmark of forest_slam_tpu_torch: stereo VO pairs per second on one
CUDA card, with the output check against a plain reference. Driven by data:
``BENCHMARK.json`` at the checkout's root names the cells, and each
configuration, traffic mix, per-layer metric and cell's check limits is a
file of its own under this directory. See README.md."""
