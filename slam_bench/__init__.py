"""The benchmark of dr_slam_torch on one NVIDIA GPU: `run.py` runs one cell
of `BENCHMARK.json` once. See README.md."""
