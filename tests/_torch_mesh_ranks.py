"""What each rank of the port's CPU mesh tests runs (``launch.mesh.
run_on_mesh`` pickles these functions by name, so they live in a module
of their own that imports torch and the port, never JAX)."""
import time
import zlib

import numpy as np
import torch

from repro_torch import data, training
from repro_torch.bridge import state_from_jax
from repro_torch.configs.speedyfeed_arch import make_sf_train_step
from repro_torch.launch import train
from repro_torch.optim.adam import leaves


def tree_crc(tree) -> int:
    """crc32 of every leaf's bytes, in ``leaves`` order."""
    crc = 0
    for _, t in leaves(tree):
        arr = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t)
        crc = zlib.crc32(np.ascontiguousarray(arr).view(np.uint8), crc)
    return crc


def _tensors(batch):
    return {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}


class Recording:
    """A started DynamicBatcher whose items are also kept, in the order
    they are taken (the order the trainer consumes them)."""

    def __init__(self, batcher, log: list):
        self._b, self._log = batcher, log

    def get(self, timeout: float = 5.0):
        item = self._b.get(timeout=timeout)
        if isinstance(item, dict):
            self._log.append(dict(item))     # the prefetcher pops keys
        return item

    def stop(self):
        self._b.stop()


class Replay:
    """Recorded items, then nothing more (a loader that has no batch
    ready: ``get`` waits and returns None)."""

    def __init__(self, items):
        self._items = [dict(i) for i in items]

    def get(self, timeout: float = 5.0):
        if self._items:
            return self._items.pop(0)
        time.sleep(min(timeout, 0.05))
        return None

    def stop(self):
        pass


def _steps(mesh, case):
    """Steps from a bridged JAX state with the JAX draws injected."""
    cfg = train.small_speedyfeed_config(**case["over"])
    params, opt, cache = case["state"]
    state = state_from_jax(params, opt, cache, case["step0"], device="cpu")
    shardings = training.state_shardings(state, mesh)
    state = training.place_state(state, shardings)
    step_fn = make_sf_train_step(cfg, mesh)
    p, o, c = state.params, state.opt, state.cache
    out = {"losses": [], "encoded": [], "reused": []}
    for i, (batch, (u, neg)) in enumerate(zip(case["batches"],
                                              case["draws"])):
        p, o, c, m = step_fn(p, o, c, case["step0"] + i, None,
                             _tensors(batch), u=u,
                             neg_idx=torch.as_tensor(neg))
        out["losses"].append(float(m["loss"]))
        out["encoded"].append(int(m["encoded"]))
        out["reused"].append(int(m["reused"]))
    out.update(emb=c.emb, written_step=c.written_step,
               params_crc=tree_crc(p), count=int(o["count"]),
               cache_rows=int(c.emb.shape[0]))
    if mesh.rank == 0:
        out["params"] = [t.detach() for _, t in leaves(p)]
    return out


def _fit(mesh, fit):
    """A mesh fit over the DynamicBatcher (n_threads=2), rank 0 recording
    the batches it consumed; then a second fit that resumes."""
    cfg = train.small_speedyfeed_config(**fit["over"])
    log = []
    if mesh.rank == 0:
        _, clicks, store, lcfg = train.make_loader(cfg, n_news=400,
                                                   n_users=80, seed=0)

        def make_batcher(epoch):
            return Recording(data.DynamicBatcher(
                clicks, store, lcfg, n_threads=2,
                seed=1_000_003 * epoch).start(), log)
    else:
        def make_batcher(epoch):
            raise AssertionError("only rank 0 loads")
    from repro_torch import obs
    obs.reset()
    trainer = training.get_trainer("speedyfeed", cfg=cfg, mesh=mesh)
    res = trainer.fit(make_batcher, steps=fit["steps"], log_every=2,
                      hosts=4, ckpt_dir=fit["dir"], ckpt_every=2)
    out = {"losses": res.losses, "steps": res.steps_done,
           "alloc": [obs.gauge("microbatch_alloc", host=str(h)).value
                     for h in range(4)],
           "stragglers": obs.gauge("straggler_hosts").value,
           "params_crc": tree_crc(res.state.params),
           "emb": res.state.cache.emb,
           "consumed": [{k: v for k, v in b.items()}
                        for b in log[:fit["steps"]]]}
    again = training.get_trainer("speedyfeed", cfg=cfg, mesh=mesh).fit(
        make_batcher, steps=fit["steps"] + 2, log_every=0,
        ckpt_dir=fit["dir"], ckpt_every=100)
    out.update(resumed_from=again.resumed_from, steps_again=again.steps_done)
    return out


def _restore(mesh, d, seed, over):
    """A checkpoint restored onto the mesh: this rank's leaves."""
    cfg = train.small_speedyfeed_config(**over)
    trainer = training.get_trainer("speedyfeed", cfg=cfg, mesh=mesh)
    like = trainer.init_state(seed)
    step, state = training.restore_state(d, like,
                                         shardings=trainer.state_shardings)
    return trainer, state, {
        "step": step, "state_step": state.step,
        "params_crc": tree_crc(state.params),
        "opt_crc": tree_crc({"m": state.opt["m"], "v": state.opt["v"]}),
        "count": int(state.opt["count"]), "emb": state.cache.emb,
        "written_step": state.cache.written_step}


def train_scenarios(mesh, inp):
    """Every training scenario of ``tests/test_torch_mesh.py`` in one
    group of ranks."""
    out = {"cases": [_steps(mesh, case) for case in inp["cases"]],
           "fit": _fit(mesh, inp["fit"])}
    trainer, state, got = _restore(mesh, inp["one_device_dir"], 4,
                                   inp["fit"]["over"])
    training.save_state(inp["mesh_dir"], 2, state,
                        shardings=trainer.state_shardings)
    out["from_one_device"] = got
    out["from_jax"] = _restore(mesh, inp["jax_dir"], 6,
                               inp["fit"]["over"])[2]
    return out


def int8_reduce(mesh, grads_by_rank):
    """``compressed_all_reduce`` of this rank's gradients from a zero
    residual: the reduced gradients and the new residual."""
    from repro_torch.optim import compressed_all_reduce
    g = {k: torch.as_tensor(v) for k, v in grads_by_rank[mesh.rank].items()}
    once, res = compressed_all_reduce(
        g, mesh, {k: torch.zeros_like(v) for k, v in g.items()})
    return {"once": once, "residual": res}


def port_steps(mesh, over, seed, batches, draws):
    """Steps of a mesh Trainer's state from ``seed`` with the draws
    injected, on the rank's device (the card's test)."""
    cfg = train.small_speedyfeed_config(**over)
    trainer = training.get_trainer("speedyfeed", cfg=cfg, mesh=mesh)
    state = trainer.init_state(seed)
    step_fn = make_sf_train_step(cfg, mesh)
    p, o, c = state.params, state.opt, state.cache
    losses = []
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    for i, (batch, (u, neg)) in enumerate(zip(batches, draws)):
        b = {k: torch.as_tensor(np.array(v), device=mesh.device)
             for k, v in batch.items()}
        p, o, c, m = step_fn(p, o, c, 100 + i, None, b, u=u,
                             neg_idx=torch.as_tensor(neg,
                                                     device=mesh.device))
        losses.append(float(m["loss"]))
    return {"losses": losses, "launches": ops.launch_counts(),
            "params": [t.detach() for _, t in leaves(p)] if mesh.rank == 0
            else None, "emb": c.emb, "written_step": c.written_step}
