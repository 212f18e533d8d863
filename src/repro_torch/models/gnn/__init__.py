"""Graph neural networks: DimeNet."""
from . import dimenet

__all__ = ["dimenet"]
