"""The benchmark of tinyknn_tpu_torch on NVIDIA GPUs (see README.md)."""
