"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), their plain
PyTorch versions, and the device dispatch in ``ops``."""
from . import ops

__all__ = ["ops"]
