"""TrainState: what the training runtime threads through every step.

``step`` is a host integer (the step draws need no device value) and
``rng`` the generator on the device from which each step takes its cache
gate and negatives. Parameters, Adam moments and the cache are updated in
place by the step; the state's tuple is rebuilt each step with the next
``step``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import CacheState


class TrainState(NamedTuple):
    params: Any               # parameter tree (dicts and lists of tensors)
    opt: Any                  # Adam state {"m", "v", "count"}
    cache: CacheState         # news-embedding cache (emb, written_step)
    step: int                 # global step
    rng: torch.Generator      # the step draws' generator, on the device


def make_state(params, opt, cache, *, step: int = 0,
               rng: torch.Generator | None = None) -> TrainState:
    if rng is None:
        rng = torch.Generator(device=cache.emb.device).manual_seed(0)
    return TrainState(params, opt, cache, int(step), rng)
