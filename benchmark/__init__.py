"""The benchmark of lcqpow_tpu_torch on the CUDA card (``run.py``)."""
