"""The benchmark of lbm_tpu_torch on one NVIDIA H100: whole LBM jobs through
the port's own entry points (see harness.py and PERF.md)."""
