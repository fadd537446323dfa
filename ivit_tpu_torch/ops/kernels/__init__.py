"""Hand-written CUDA kernels (``ivit_tpu_torch/csrc``) and their wrappers."""
