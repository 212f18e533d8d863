"""Model configurations."""
from .speedyfeed_arch import PROD

__all__ = ["PROD"]
