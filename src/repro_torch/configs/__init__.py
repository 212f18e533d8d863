"""Model configurations and the architecture registry:
``get_arch(name)`` / the train launcher's ``--arch <name>``.

10 assigned architectures + the paper's own (speedyfeed), as in the JAX
package's ``configs/__init__.py``."""
from __future__ import annotations

import functools

from .speedyfeed_arch import PROD


@functools.lru_cache(maxsize=1)
def _registry():
    from . import gnn_family, lm_family, recsys_family, speedyfeed_arch
    archs = (lm_family.archs() + recsys_family.archs() + gnn_family.archs()
             + speedyfeed_arch.archs())
    return {a.name: a for a in archs}


def get_arch(name: str):
    reg = _registry()
    if name not in reg:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(reg)}")
    return reg[name]


def list_archs():
    return sorted(_registry())


ASSIGNED = [
    "qwen3-14b", "chatglm3-6b", "qwen2-72b", "dbrx-132b",
    "llama4-scout-17b-a16e",
    "dimenet",
    "wide-deep", "dlrm-rm2", "bert4rec", "dcn-v2",
]

__all__ = ["PROD", "ASSIGNED", "get_arch", "list_archs"]
