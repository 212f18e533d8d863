"""Trainer-name -> Trainer-factory registry.

Configuration modules register a factory at import time
(``@register_trainer("speedyfeed")``); launchers ask for a ready Trainer
by name. ``get_trainer`` imports the configurations lazily, so
registration has happened by lookup time without an import cycle
(configs -> training, never the reverse at import).
"""
from __future__ import annotations

_TRAINERS: dict = {}


def register_trainer(name: str, factory=None):
    """``factory(cfg=None, **kw) -> Trainer``. Usable as a decorator:
    ``@register_trainer("name")``."""
    if factory is None:
        def deco(f):
            _TRAINERS[name] = f
            return f
        return deco
    _TRAINERS[name] = factory
    return factory


def _load_configs():
    # configuration modules register their trainers at import time
    import repro_torch.configs.speedyfeed_arch  # noqa: F401


def get_trainer(name: str, **kw):
    if name not in _TRAINERS:
        _load_configs()
    if name not in _TRAINERS:
        raise KeyError(f"no trainer registered for {name!r}; "
                       f"have {sorted(_TRAINERS)}")
    return _TRAINERS[name](**kw)


def registered_trainers():
    _load_configs()
    return sorted(_TRAINERS)
