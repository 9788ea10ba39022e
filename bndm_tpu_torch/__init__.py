"""PyTorch/CUDA port of bndm_tpu for NVIDIA Hopper GPUs (see README.md)."""

__version__ = "0.1.0"
