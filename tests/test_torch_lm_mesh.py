"""The LM family on a (data, model) mesh: the port's tensor parallelism,
FSDP by ``lm_rules`` and expert-parallel MoE (``moe_ep``) against the JAX
package's mesh run, in gloo ranks on the CPU.

The inputs are drawn with numpy from a seed: the four reduced configs'
parameters (the shapes of JAX's ``lm.init``), a decode cache, tokens and
the MoE overflow case. The JAX package runs them on 4 forced host
devices in two subprocesses, one a mesh (``_jax_lm_mesh_ref.py``), while
one group of 4 port ranks runs both meshes (``_torch_lm_mesh_ranks.py``,
torch only) and this process runs the port's one-process steps.
Tolerances: 2e-4 forward, 1e-4 gradients and parameters against JAX
(the reference's own, ``ROADMAP.md``); 1e-5 against the port's one
process where routing is the same (data=1). Gradients, Adam's moments and
parameters are held relative to each leaf's largest magnitude. The train
steps start from Adam's count at the schedule's warm-up, where a step
moves a weight by ~1e-3, and each leaf's change over the 2 steps is held
too: the distance from the reference within TOL_CHANGE of the norm of
the reference's change. Adam divides each element's step by that
element's own gradient RMS, so an element whose gradient is near 0 takes
a step set by rounding: element by element the changes differ by up to
3.2e-3 of the largest, while over a leaf's norm they agree within 2.7e-4
(ChatGLM3-6B's k bias; the others within 5.5e-5). Two controls must fail
that check: the state left unchanged (1 by construction), and the steps
run without ``sync_grads`` on (2, 2) (the leaves whole over ``data``,
0.64 to 0.98).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import _jax_lm_mesh_ref as jref  # noqa: E402
import _torch_lm_mesh_ranks as ranks  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch import bridge, configs, nn, optim  # noqa: E402
from repro_torch.configs import lm_family  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for, run_on_mesh  # noqa: E402
from repro_torch.models import lm, lm_parallel  # noqa: E402
from repro_torch.optim.adam import leaves  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 4
B, S, S_MAX, START = 4, 32, 32, 20
TOL_FWD, TOL_GRAD, TOL_ONE = 2e-4, 1e-4, 1e-5
TOL_CHANGE = 1e-3       # of the norm of a leaf's change (module docstring)
MESH_TIMEOUT_S = 300
NAMES = ranks.NAMES
CASES = [(m, n) for m in ranks.MESHES for n in NAMES]


def _inputs(seed=0) -> dict:
    """Every input, drawn with numpy: weights N(0, 0.02), norm scales 1 +
    N(0, 0.1); a decode cache N(0, 1); tokens over the 512-word
    vocabulary; the overflow case's router biased to expert 0."""
    rng = np.random.default_rng(seed)
    inp = {}
    for name in NAMES:
        cfg = jref.mesh_config(lm_family.CONFIGS[name])
        shapes = jax.eval_shape(lambda: jax_lm.init(jax.random.PRNGKey(0),
                                                    cfg))
        for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
            key = "/".join(str(p.key) for p in path)
            a = rng.normal(0, 0.02, leaf.shape).astype(np.float32)
            inp[f"{name}/p/{key}"] = (1.0 + 5 * a) if key.endswith(
                "scale") else a
        for k in "kv":
            inp[f"{name}/cache/{k}"] = rng.normal(0, 1, (
                cfg.n_layers, B, S_MAX, cfg.n_kv, cfg.hd)).astype(np.float32)
    toks = rng.integers(0, 512, (B, S)).astype(np.int32)
    inp["tokens"] = toks
    inp["labels"] = np.concatenate(
        [toks[:, 1:], np.full((B, 1), -100, np.int32)], 1)
    inp["decode_tokens"] = rng.integers(0, 512, (4, B, 1)).astype(np.int32)
    inp["decode_start"] = np.int32(START)
    inp["opt_count"] = np.int32(ranks.OPT_COUNT)
    m = ranks.MOE_CFG
    router = rng.normal(0, 0.02, (m.d_model, m.n_experts)).astype(np.float32)
    router[:, 0] += 0.2       # most tokens choose expert 0 first
    inp["moe/p/router"] = router
    for k, shape in (("w1", (m.n_experts, m.d_model, m.d_ff)),
                     ("w3", (m.n_experts, m.d_model, m.d_ff)),
                     ("w2", (m.n_experts, m.d_ff, m.d_model))):
        inp[f"moe/p/{k}"] = rng.normal(0, 0.02, shape).astype(np.float32)
    # a positive mean: the bias of router column 0 adds 0.2 sum(x) > 0
    inp["moe/x"] = rng.normal(0.5, 1, (B, 8, m.d_model)).astype(np.float32)
    inp["moe/w"] = rng.normal(0, 1, (B, 8, m.d_model)).astype(np.float32)
    return inp


def _one_process(inp, name) -> dict:
    """The port's one-process prefill, decode, gradient and train steps."""
    cfg = ranks.mesh_config(name)
    params = ranks.bridged(inp, name)
    t = ranks._t
    out = {"prefill": lm_family.make_fn(cfg, "prefill")(params,
                                                        t(inp["tokens"]))}
    cache = {k: t(inp[f"{name}/cache/{k}"]) for k in "kv"}
    dec = lm_family.make_fn(cfg, "decode")
    logits = []
    for s, tok in enumerate(inp["decode_tokens"]):
        lg, cache = dec(params, t(tok), cache, START + s)
        logits.append(lg)
    out["decode"] = torch.stack(logits).numpy()
    batch = {"tokens": t(inp["tokens"]), "labels": t(inp["labels"])}
    flat_p = [p.requires_grad_() for _, p in leaves(params)]
    grads = torch.autograd.grad(lm.lm_loss(params, cfg, batch)[0], flat_p)
    out["grad"] = {p: g.numpy() for (p, _), g in zip(leaves(params), grads)}
    step, opt = lm_family.make_fn(cfg, "train"), optim.adam_init(params)
    opt["count"].fill_(ranks.OPT_COUNT)
    out["losses"] = []
    for _ in range(2):
        params, opt, m = step(params, opt, batch)
        out["losses"].append(float(m["loss"]))
    out["params"] = ranks.flat(params)
    for k in "mv":
        out[k] = ranks.flat(opt[k])
    return out


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm_mesh")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = {m: subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_jax_lm_mesh_ref.py"),
         str(d / "in.npz"), str(d / f"{m}.npz"), m], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for m in ranks.MESHES}
    try:
        out = run_on_mesh(ranks.lm_mesh_cases, N, ["cpu"] * N, model=2,
                          args=(inp,), timeout=MESH_TIMEOUT_S)
        one = {name: _one_process(inp, name) for name in NAMES}
        jx = {}
        for m, p in procs.items():
            log = p.communicate(timeout=MESH_TIMEOUT_S)[0].decode()
            assert p.returncode == 0, f"JAX reference ({m}) failed:\n{log}"
            jx.update(np.load(d / f"{m}.npz"))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return dict(inp=inp, out=out, one=one, jax=jx)


def _close(got, exp, tol, what=""):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    assert got.shape == exp.shape, (what, got.shape, exp.shape)
    np.testing.assert_allclose(got, exp, rtol=0, atol=tol, err_msg=what)


def _close_rel(got, exp, tol, what=""):
    """Within ``tol`` of ``exp``'s largest magnitude."""
    exp = np.asarray(exp, np.float64)
    _close(got, exp, tol * np.abs(exp).max(), what)


def _change_err(got, exp, before) -> float:
    """How far ``got`` lies from ``exp``, over the norm of ``exp``'s
    change from ``before`` (which must have changed)."""
    got, exp, before = (np.asarray(a, np.float64) for a in (got, exp, before))
    assert got.shape == exp.shape
    change = np.linalg.norm(exp - before)
    assert change > 0
    return float(np.linalg.norm(got - exp) / change)


def _before(inp, name) -> dict:
    """{port path: array} of the config's parameters before the steps."""
    return ranks.flat(ranks.bridged(inp, name))


def _block(arr, res, mname, axis=0):
    """The block over ``data`` along ``axis`` of a whole array that the
    rank whose results on mesh ``mname`` are ``res`` holds."""
    D, i = ranks.MESHES[mname][0], res["index"]["data"]
    n = arr.shape[axis] // D
    return np.take(arr, range(i * n, (i + 1) * n), axis=axis)


def _jax_tree(jx, prefix) -> dict:
    """{port path: array} of a JAX tree saved under ``prefix`` (stacked
    layers split as the bridge splits them)."""
    tree = bridge.split_layers(ranks.unflatten(jx, prefix))
    return {p: np.asarray(a) for p, a in leaves(tree)}


# ---------------------------------------------------------------- placement

@pytest.mark.parametrize("mname,name", CASES)
def test_place_params_round_trips_bit_for_bit(mesh_run, mname, name):
    """Every rank's blocks gathered back equal the bridged JAX tree bit
    for bit, and each block has the shape its spec gives."""
    cfg = ranks.mesh_config(name)
    D, M = ranks.MESHES[mname]
    whole = {p: tuple(t.shape) for p, t in leaves(ranks.bridged(
        mesh_run["inp"], name))}
    for r in mesh_run["out"]:
        res = r[mname][name]
        assert res["round_trip"]
        for path, shape in res["block_shapes"].items():
            n = 1
            for a, b in zip(shape, whole[path]):
                assert b % a == 0
                n *= b // a
            # q, k, v, o, FFN, experts, embed, head: D * M blocks (FSDP
            # and TP); biases of q, k, v: M; norms and the router: one
            leaf = path.split("/")[-2] if path.endswith(("/w", "/b")) \
                else path.split("/")[-1]
            assert n in (1, M, D * M), (path, shape)
            if path.endswith("/w") or leaf in ("table", "w1", "w2", "w3"):
                assert n == D * M, (path, shape, cfg.name)


# ------------------------------------------------------- against JAX's mesh

@pytest.mark.parametrize("mname,name", CASES)
def test_prefill_and_decode_match_jax_mesh(mesh_run, mname, name):
    """Prefill's last logits and 4 decode steps' logits of each rank's
    batch block, whole over the vocabulary, within 2e-4 of JAX's mesh
    run; each rank's cache block (its KV heads) holds JAX's new entries."""
    jx, tag = mesh_run["jax"], f"{mname}/{name}"
    D, M = ranks.MESHES[mname]
    for r in mesh_run["out"]:
        res = r[mname][name]
        i = r[mname]["index"]
        _close(res["prefill"], _block(jx[f"{tag}/prefill"], r[mname], mname),
               TOL_FWD, f"{tag} prefill")
        _close(res["decode"], _block(jx[f"{tag}/decode"], r[mname], mname,
                                     axis=1), TOL_FWD, f"{tag} decode")
        hk = jx[f"{tag}/cache_k"].shape[3] // M
        exp = _block(jx[f"{tag}/cache_k"], r[mname], mname, axis=1)[
            :, :, :, i["model"] * hk:(i["model"] + 1) * hk]
        _close(res["cache_k"], exp, TOL_FWD, f"{tag} cache")


@pytest.mark.parametrize("mname,name", CASES)
def test_forward_on_a_mesh_is_every_position(mesh_run, mname, name):
    """``lm.forward(mesh=)``: each rank's batch block's logits at every
    position, whole over the vocabulary; the last position's is
    prefill's, within 2e-4 of JAX's mesh run."""
    jx = mesh_run["jax"][f"{mname}/{name}/prefill"]
    for r in mesh_run["out"]:
        res = r[mname][name]
        assert res["forward"].shape == (B // ranks.MESHES[mname][0], S,
                                        jx.shape[-1])
        _close(res["forward"][:, -1], _block(jx, r[mname], mname),
               TOL_FWD, f"{mname} {name} forward")


@pytest.mark.parametrize("mname,name", CASES)
def test_grads_match_jax_mesh(mesh_run, mname, name):
    """The loss's gradient, summed over ``data`` as the train step sums it
    and gathered whole, within 1e-4 of JAX's on every leaf (of its
    largest), on every rank (the router's under EP included)."""
    exp = _jax_tree(mesh_run["jax"], f"{mname}/{name}/grad/")
    for r in mesh_run["out"]:
        got = r[mname][name]["grad"]
        assert set(got) == set(exp)
        for path in exp:
            _close_rel(got[path], exp[path], TOL_GRAD,
                       f"{mname} {name} {path}")


@pytest.mark.parametrize("mname,name", CASES)
def test_train_steps_match_jax_mesh(mesh_run, mname, name):
    """2 steps of the registry's train cell from Adam's count at the
    warm-up: losses, global grad norms and the MoE balance loss within
    1e-4 of JAX's ``_make_train(cfg, mesh)``, the same on every rank;
    every parameter and both moments, gathered, within 1e-4 of the leaf's
    largest, and each leaf's change within TOL_CHANGE (of its norm)."""
    jx, tag = mesh_run["jax"], f"{mname}/{name}"
    exp = {k: _jax_tree(jx, f"{tag}/{k}/") for k in ("params", "m", "v")}
    before = _before(mesh_run["inp"], name)
    first = mesh_run["out"][0][mname][name]
    for r in mesh_run["out"]:
        res = r[mname][name]
        for k in ("losses", "grad_norms", "moe_aux"):
            _close(res[k], jx[f"{tag}/{k}"], TOL_GRAD, f"{tag} {k}")
            assert res[k] == first[k], (tag, k)
        for k, tree in exp.items():
            assert set(res[k]) == set(tree), (tag, k)
            for path in tree:
                _close_rel(res[k][path], tree[path], TOL_GRAD,
                           f"{tag} {k} {path}")
        for path in exp["params"]:
            err = _change_err(res["params"][path], exp["params"][path],
                              before[path])
            assert err <= TOL_CHANGE, (tag, path, err)
    if lm_family.CONFIGS[name].is_moe:
        assert all(a > 0 for a in first["moe_aux"])


@pytest.mark.parametrize("name", ranks.NO_SYNC)
def test_train_check_fails_its_controls(mesh_run, name):
    """The change check of ``test_train_steps_match_jax_mesh`` fails, on
    every rank of (2, 2), the state left unchanged (every leaf), and the
    same 2 steps run without ``sync_grads`` (every leaf whole over
    ``data``: the norm scales, and DBRX's router; their replicas drift
    apart on the data ranks)."""
    tag = f"2x2/{name}"
    exp = _jax_tree(mesh_run["jax"], f"{tag}/params/")
    before = _before(mesh_run["inp"], name)
    for r in mesh_run["out"]:
        res = r["2x2"][name]
        assert res["whole_over_data"]
        for path in exp:
            assert _change_err(before[path], exp[path],
                               before[path]) > TOL_CHANGE, path
        for path in res["whole_over_data"]:
            err = _change_err(res["no_sync_params"][path], exp[path],
                              before[path])
            assert err > TOL_CHANGE, (path, err)


@pytest.mark.parametrize("name", NAMES)
def test_data1_mesh_matches_one_process(mesh_run, name):
    """On (data=1, model=2) routing is the one process's: prefill, decode,
    losses and parameters within 1e-5 of the port's one-process steps on
    the same inputs; gradients and Adam's moments within 1e-5 of each
    leaf's largest; each leaf's change within TOL_CHANGE (of its
    norm)."""
    one = mesh_run["one"][name]
    before = _before(mesh_run["inp"], name)
    for r in mesh_run["out"]:
        res = r["1x2"][name]
        _close(res["prefill"], one["prefill"], TOL_ONE, "prefill")
        _close(res["decode"], one["decode"], TOL_ONE, "decode")
        _close(res["losses"], one["losses"], TOL_ONE, "losses")
        for path, g in one["grad"].items():
            _close_rel(res["grad"][path], g, TOL_ONE, f"grad {path}")
            _close(res["params"][path], one["params"][path], TOL_ONE, path)
            for k in "mv":
                _close_rel(res[k][path], one[k][path], TOL_ONE, f"{k} {path}")
            err = _change_err(res["params"][path], one["params"][path],
                              before[path])
            assert err <= TOL_CHANGE, (path, err)


@pytest.mark.parametrize("mname", list(ranks.MESHES))
def test_head_row_path_matches_one_process(mesh_run, mname):
    """On a short batch (2 x 8) the data ranks' rows are fewer than
    d_model, so under FSDP the loss takes the head's row path (the rows
    and their logits cross the data axis, not the head): the loss and
    every gradient leaf within 1e-5 (of its largest) of the port's one
    process."""
    cfg = ranks.mesh_config("qwen3-14b")
    D = ranks.MESHES[mname][0]
    assert lm_parallel.head_by_rows(2 * 8 // D, cfg, make_mesh_for(
        2 * D, model=2), True) == (D > 1)
    params = ranks.bridged(mesh_run["inp"], "qwen3-14b")
    batch = {k: torch.as_tensor(mesh_run["inp"][k])[:2, :8]
             for k in ("tokens", "labels")}
    flat_p = [p.requires_grad_() for _, p in leaves(params)]
    loss = lm.lm_loss(params, cfg, batch)[0]
    grads = torch.autograd.grad(loss, flat_p)
    for r in mesh_run["out"]:
        res = r[mname]["short"]
        _close(res["loss"], float(loss.detach()), TOL_ONE, "loss")
        for (path, _), g in zip(leaves(params), grads):
            _close_rel(res["grad"][path], g.numpy(), TOL_ONE, path)


@pytest.mark.parametrize("mname", list(ranks.MESHES))
def test_moe_layers_go_through_moe_ep(mesh_run, mname):
    """Every MoE layer of a mesh call runs ``moe_ep_partial`` (the spy's
    count: a layer a prefill, a forward, a decode step, the gradient's
    and each train step's forward, the control's steps too); the dense
    configs never."""
    calls_per_pass = {n: ranks.mesh_config(n).n_layers
                      if ranks.mesh_config(n).is_moe else 0 for n in NAMES}
    for r in mesh_run["out"]:
        for name in NAMES:
            # prefill, forward, 4 decode steps, the gradient, 2 steps,
            # and on (2, 2) the 2 steps without sync_grads
            passes = 9 + 2 * (mname == "2x2" and name in ranks.NO_SYNC)
            assert r[mname][name]["moe_ep_calls"] == \
                passes * calls_per_pass[name], name


@pytest.mark.parametrize("mname", list(ranks.MESHES))
def test_moe_ep_overflow_matches_jax(mesh_run, mname):
    """The overflow case (capacity factor 0.5, router biased to expert 0):
    every data shard drops assignments; each rank's y block, aux, and the
    router's, experts' and x's gradients (of their largest) within 1e-4
    of JAX's ``moe_ep``
    on the same mesh; on (2, 2) y differs from one ``moe_gather`` over
    the whole batch (the shards' capacities drop other assignments)."""
    inp, jx = mesh_run["inp"], mesh_run["jax"]
    cfg = ranks.MOE_CFG
    x = torch.as_tensor(inp["moe/x"])
    D = ranks.MESHES[mname][0]
    for i in range(D):
        xs = x[i * B // D:(i + 1) * B // D].reshape(-1, cfg.d_model)
        _, eidx, _ = nn.moe._route({"router": torch.as_tensor(
            inp["moe/p/router"])}, xs, cfg)
        counts = torch.bincount(eidx.reshape(-1), minlength=cfg.n_experts)
        assert counts.max() > nn.capacity_for(xs.shape[0], cfg), counts
    for r in mesh_run["out"]:
        res = r[mname]["moe"]
        _close(res["y"], _block(jx[f"{mname}/moe/y"], r[mname], mname),
               TOL_GRAD, "y")
        _close(res["aux"], jx[f"{mname}/moe/aux"], TOL_GRAD, "aux")
        for k in ("router", "w1", "w2", "w3"):
            _close_rel(res["grad"][k], jx[f"{mname}/moe/grad/{k}"],
                       TOL_GRAD, k)
        _close_rel(res["grad_x"], _block(jx[f"{mname}/moe/grad_x"],
                                         r[mname], mname), TOL_GRAD, "grad_x")
    if mname == "2x2":
        p = {k: torch.as_tensor(inp[f"moe/p/{k}"])
             for k in ("router", "w1", "w2", "w3")}
        y_one, _ = nn.moe_gather(p, x, cfg)
        got = np.concatenate([r["2x2"]["moe"]["y"] for r in
                              mesh_run["out"] if r["2x2"]["index"]["model"]
                              == 0])
        assert np.abs(got - y_one.numpy()).max() > 1e-3


# ---------------------------------------------------------- without ranks

# each registry config's query heads a model rank at model=16 (rank 0
# first), and the ranks that share a KV head
HEADS_AT_16 = {"qwen3-14b": ([3, 2] * 8, 2), "chatglm3-6b": ([2] * 16, 8),
               "qwen2-72b": ([4] * 16, 2), "dbrx-132b": ([3] * 16, 2),
               "llama4-scout-17b-a16e": ([3, 2] * 8, 2)}


def test_tensor_parallelism_needs_whole_kv_heads():
    """The head plan: ChatGLM3-6B (32 heads over n_kv=2) places model=4
    and 16 with each KV head replicated over 2 and 8 ranks; every registry
    config at model=16 cuts its query heads by KV group, lower ranks
    first, on the (16, 16) and (2, 16, 16) meshes; a model axis the plan
    cannot place still raises with the reason (model=3 over n_kv=2)."""
    from repro_torch.launch.mesh import make_production_mesh
    glm = lm_family.CHATGLM3_6B
    for M, R in ((4, 2), (16, 8)):
        lm_parallel.check_tp(glm, make_mesh_for(M, model=M))
        plan = lm_parallel.head_plan(glm.n_heads, glm.n_kv, M)
        assert plan.R == R and plan.kv == tuple((m // R, m // R + 1)
                                                for m in range(M))
        assert [hi - lo for lo, hi in plan.q] == [32 // M] * M
    for cfg in lm_family.CONFIGS.values():
        q, R = HEADS_AT_16[cfg.name]
        plan = lm_parallel.head_plan(cfg.n_heads, cfg.n_kv, 16)
        assert [hi - lo for lo, hi in plan.q] == q and plan.R == R
        # the query heads of KV head g are its own: [g G, (g + 1) G)
        G = cfg.n_heads // cfg.n_kv
        for (lo, hi), (g, _) in zip(plan.q, plan.kv):
            assert g * G <= lo < hi <= (g + 1) * G
        assert plan.q[0][0] == 0 and plan.q[-1][1] == cfg.n_heads
        for multi in (False, True):
            mesh = make_production_mesh(multi_pod=multi)
            lm_parallel.check_tp(cfg, mesh)
            assert lm_family.mesh_skip(cfg, mesh) is None
            assert lm_parallel.local_attn_cfg(cfg.attn_cfg(), mesh) \
                .n_heads == q[0]
    with pytest.raises(ValueError, match="model=3 must be a multiple of "
                                         "n_kv=2"):
        lm_parallel.check_tp(glm, make_mesh_for(3, model=3))


@pytest.mark.parametrize("name", [a for a in configs.list_archs()
                                  if configs.get_arch(a).family == "lm"])
def test_registry_cells_give_the_mesh_step(name):
    """Every LM cell's ``make_fn(device="cpu", mesh=)`` gives the step on
    that mesh (the ranks run the reduced configs through the same
    ``lm_arch`` cells), and the cell's parameters place by its rules: the
    meta blocks of a (2, 2) mesh's rank hold a quarter of each weight."""
    arch = configs.get_arch(name)
    mesh = make_mesh_for(4, model=2)
    for cell in arch.cells.values():
        assert callable(cell.make_fn(device="cpu", mesh=mesh)), cell.key
    params = arch.cells["prefill_32k"].abstract_args()[0]
    blocks = configs.base.shard_abstract(
        params, lm_parallel.param_specs(params, arch.config, mesh), mesh)
    q, qb = params["layers"][0]["attn"]["q"]["w"], \
        blocks["layers"][0]["attn"]["q"]["w"]
    assert qb.device.type == "meta" and qb.numel() * 4 == q.numel()
    assert blocks["ln_f"]["scale"].shape == params["ln_f"]["scale"].shape


def _specs(tree, prefix="") -> dict:
    """{path: spec as a tuple} of a dict tree of specs (PartitionSpec or
    Spec leaves), an entry of one axis as its name (JAX's PartitionSpec
    writes ``("data",)`` so)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_specs(v, f"{prefix}{k}/"))
        return out
    if tree is None:
        return {prefix: None}
    return {prefix: tuple(e[0] if isinstance(e, tuple) and len(e) == 1
                          else e for e in tree)}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("n,model", [(2, 2), (4, 2)])
def test_lm_batch_specs_match_jax(kind, n, model):
    """The batch and decode-cache specs are the JAX package's
    ``lm_batch_specs``: tokens over ``data``, the cache's batch over
    ``data`` and its KV heads over ``model``."""
    from repro.distributed import sharding as jshx
    from repro_torch.distributed import sharding as shx

    class JMesh:                      # shapes only, as the rules read them
        axis_names = ("data", "model")
        shape = {"data": n // model, "model": model}

    got = shx.lm_batch_specs(make_mesh_for(n, model=model), kind)
    exp = jshx.lm_batch_specs(JMesh(), kind)
    assert _specs(got) == _specs(exp)


def test_mesh_axis_groups_are_row_major():
    """Rank r of a (data, model) mesh sits at (r // M, r % M), as JAX's
    ``make_mesh_for`` lays out devices; its model group is its data row,
    its data group its model column."""
    from repro_torch.launch import mesh as tmesh
    assert tmesh._axis_groups((2, 2)) == [
        ("model", [0, 1]), ("model", [2, 3]),
        ("data", [0, 2]), ("data", [1, 3])]
    assert tmesh._axis_groups((1, 2), base=2) == [
        ("model", [2, 3]), ("data", [2]), ("data", [3])]
    for r in range(4):
        m = tmesh.Mesh(("data", "model"), {"data": 2, "model": 2}, rank=r)
        assert (m.index("data"), m.index("model")) == divmod(r, 2)
        assert m.size("model") == 2 and m.size() == 4 and m.index() == r


@pytest.mark.parametrize("name", NAMES)
def test_init_placed_is_place_params_of_init(name):
    """Each rank's blocks drawn placed (a part placed as soon as it is
    drawn) equal ``place_params`` of the whole init, bit for bit, and the
    specs are the JAX package's ``lm_rules(fsdp=True)`` after its
    ``guard_divisible``."""
    from repro.distributed import sharding as jshx
    from repro_torch.launch.mesh import Mesh
    cfg = ranks.mesh_config(name)
    whole = lm.init(torch.Generator().manual_seed(5), cfg)
    jtree = bridge.stack_layers(whole)
    mesh = make_mesh_for(4, model=2)
    exp = jshx.guard_divisible(jshx.spec_tree(jtree, jshx.lm_rules(True)),
                               jtree, mesh)
    got = lm_parallel.param_specs(whole, cfg, mesh)
    # JAX's stacked layers carry a leading (replicated) layer axis
    assert _specs(got["layers"][0]) == {
        p: spec[1:] for p, spec in _specs(exp["layers"]).items()}
    assert _specs(dict(got, layers=None)) == _specs(dict(exp, layers=None))
    for r in range(4):
        m = Mesh(("data", "model"), {"data": 2, "model": 2}, rank=r)
        a = lm_family.init_placed(torch.Generator().manual_seed(5), cfg, m)
        b = lm_family.place_params(whole, cfg, m)
        for (pa, ta), (pb, tb) in zip(leaves(a), leaves(b)):
            assert pa == pb and torch.equal(ta, tb), (r, pa)
        # the moments follow their parameters (JAX's opt_spec_tree)
        opt = lm_family.place_opt(optim.adam_init(whole), cfg, m)
        for k in ("m", "v"):
            assert [t.shape for _, t in leaves(opt[k])] == \
                [t.shape for _, t in leaves(b)]
