"""What each rank of ``tests/test_torch_dryrun_mesh.py`` runs (``launch.
mesh.run_on_mesh`` pickles it by name, so it lives in a module of its own
that imports torch and the port, never JAX): SpeedyFeed's conventional
step on a (data=2, model=2) mesh, pure data parallelism over every axis
(``make_conventional_step(cfg, mesh)``): the loss's gradient as Adam
takes it (summed over every axis) and 2 train steps.
"""
import torch

from repro_torch import core
from repro_torch.configs.speedyfeed_arch import (conventional_loss,
                                                 make_conventional_step)
from repro_torch.optim import adam_init
from repro_torch.optim.adam import leaves, sync_grads, unflatten

N_STEPS = 2


def conventional_cases(mesh, kw, params, batch):
    """{"loss", "grads", "losses", "grad_norms", "params"} of this rank:
    ``kw`` the config's keywords, ``params`` the whole tree, ``batch`` the
    whole batch (torch tensors)."""
    cfg = core.make_config(**kw)
    flat = [p.clone().requires_grad_() for _, p in leaves(params)]
    tree = unflatten(params, flat)
    loss, _ = conventional_loss(cfg, mesh)(tree, batch)
    g = torch.autograd.grad(loss, flat, allow_unused=True)
    every = tuple(mesh.axis_names)
    g = sync_grads(list(g), flat, [()] * len(flat), mesh,
                   [every] * len(flat))
    step = make_conventional_step(cfg, mesh)
    p = unflatten(params, [t.clone() for _, t in leaves(params)])
    opt = adam_init(p)
    losses, norms = [], []
    for _ in range(N_STEPS):
        p, opt, m = step(p, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"loss": loss.detach(), "grads": [x.detach() for x in g],
            "losses": losses, "grad_norms": norms,
            "params": [t.detach() for _, t in leaves(p)]}
