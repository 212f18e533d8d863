"""The LM family on meshes whose model axis the heads do not divide
evenly: the port's head plan (KV heads replicated over the model ranks
that share them, query heads cut unevenly by KV group) and the pod axis,
against the JAX package's GSPMD run, in gloo ranks on the CPU.

The reduced Qwen3-14B (remat, loss chunk 8) and Scout (chunked-local,
``moe_ep``, a shared expert) at 6 query heads over 2 KV heads, and
ChatGLM3-6B (QKV bias, partial RoPE) at 4 over 2, run on a (data=1,
model=4) mesh, where each KV head is replicated over 2 ranks (which hold
2 and 1 of Qwen3-14B's and Scout's 3 query heads a KV head, 1 and 1 of
ChatGLM3-6B's 2), and on a (pod=2, data=1, model=2) one, where the batch
is cut over ``pod`` and the parameters are replicated over it. The JAX
package runs the same numpy inputs on 4 forced host devices
(``_jax_lm_mesh_ref.py`` with its ``HEADS_MESHES``, one subprocess a
mesh), where GSPMD cuts q, k, v and o's columns mid-head
(``guard_divisible`` keeps the model cut wherever the columns divide).
The port's ranks are ``_torch_lm_mesh_heads_ranks.py``.

Held, with ``tests/test_torch_lm_mesh.py``'s tolerances (2e-4 forward,
1e-4 gradients, moments and parameters of each leaf's largest, each
leaf's change within 1e-3 of the norm of JAX's): placement round trips
bit for bit, prefill, 4 decode steps from a seeded cache, the loss's
gradient before Adam, 2 train steps from Adam's count 200. Controls that
must miss, on (1, 4): the k/v gradients without the sum over the ranks
that share a KV head, and 2 steps whose clip counts each replica of a KV
head's block (the global norm then counts those blocks twice).
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
import _torch_lm_mesh_heads_ranks as ranks  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import lm_family  # noqa: E402
from repro_torch.launch.mesh import run_on_mesh  # noqa: E402
from repro_torch.models import lm_parallel  # noqa: E402
from repro_torch.optim.adam import leaves  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 4
B, S, S_MAX, START = 4, 32, 32, 20
# tests/test_torch_lm_mesh.py's tolerances (its module docstring says why)
TOL_FWD, TOL_GRAD, TOL_CHANGE = 2e-4, 1e-4, 1e-3
MESH_TIMEOUT_S = 300
NAMES = ranks.NAMES
CASES = [(m, n) for m in ranks.MESHES for n in NAMES]


def _inputs(seed=1) -> dict:
    """Every input, drawn with numpy as ``test_torch_lm_mesh``'s are:
    weights N(0, 0.02), norm scales 1 + N(0, 0.1), a decode cache N(0, 1),
    tokens over the 512-word vocabulary."""
    rng = np.random.default_rng(seed)
    inp = {}
    for name in NAMES:
        cfg = jref.heads_config(lm_family.CONFIGS[name])
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
    return inp


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm_mesh_heads")
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
        out = run_on_mesh(ranks.heads_cases, N, ["cpu"] * N, args=(inp,),
                          timeout=MESH_TIMEOUT_S)
        jx = {}
        for m, p in procs.items():
            log = p.communicate(timeout=MESH_TIMEOUT_S)[0].decode()
            assert p.returncode == 0, f"JAX reference ({m}) failed:\n{log}"
            jx.update(np.load(d / f"{m}.npz"))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return dict(inp=inp, out=out, jax=jx)


def _batch_block(arr, r, mname, axis=0):
    """The block over the data axes (``pod`` and ``data``) along ``axis``
    of a whole array that rank ``r`` holds on mesh ``mname``."""
    pod, data, _ = ranks.MESHES[mname]
    D, i = pod * data, r[mname]["data_block"]
    n = arr.shape[axis] // D
    return np.take(arr, range(i * n, (i + 1) * n), axis=axis)


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


def _jax_tree(jx, prefix) -> dict:
    """{port path: array} of a JAX tree saved under ``prefix``."""
    tree = bridge.split_layers(ranks.base.unflatten(jx, prefix))
    return {p: np.asarray(a) for p, a in leaves(tree)}


def _before(inp, name) -> dict:
    return ranks.base.flat(ranks.base.bridged(inp, name))


# ---------------------------------------------------------------- placement

@pytest.mark.parametrize("mname,name", CASES)
def test_place_params_round_trips_bit_for_bit(mesh_run, mname, name):
    """Every rank's blocks gathered back (unequal blocks by
    ``gather_blocks``) equal the bridged JAX tree bit for bit; q's columns
    and o's rows hold the rank's query heads by the plan, k's and v's
    columns its one KV head; the cache block is ``init_cache(mesh=)``'s
    shape."""
    cfg = ranks.heads_config(name)
    M = ranks.MESHES[mname][2]
    plan = lm_parallel.head_plan(cfg.n_heads, cfg.n_kv, M)
    for r in mesh_run["out"]:
        res = r[mname][name]
        assert res["round_trip"] and res["cache_shape_ok"]
        lo, hi = plan.q[r[mname]["index"]["model"]]
        assert res["local_heads"] == hi - lo
        shapes = res["block_shapes"]
        for i in range(cfg.n_layers):
            a = f"layers/{i}/attn"
            assert shapes[f"{a}/q/w"][-1] == (hi - lo) * cfg.hd
            assert shapes[f"{a}/o/w"][0] == (hi - lo) * cfg.hd
            for k in "kv":
                assert shapes[f"{a}/{k}/w"][-1] == \
                    cfg.n_kv * cfg.hd // min(M, cfg.n_kv)


# ------------------------------------------------------- against JAX's mesh

@pytest.mark.parametrize("mname,name", CASES)
def test_prefill_and_decode_match_jax_mesh(mesh_run, mname, name):
    """Prefill's last logits and 4 decode steps' logits of each rank's
    batch block within 2e-4 of JAX's mesh run; each rank's cache block
    (its KV head, replicated or not) holds JAX's new entries."""
    jx, tag = mesh_run["jax"], f"{mname}/{name}"
    cfg = ranks.heads_config(name)
    M = ranks.MESHES[mname][2]
    plan = lm_parallel.head_plan(cfg.n_heads, cfg.n_kv, M)
    for r in mesh_run["out"]:
        res = r[mname][name]
        _close(res["prefill"], _batch_block(jx[f"{tag}/prefill"], r, mname),
               TOL_FWD, f"{tag} prefill")
        _close(res["decode"], _batch_block(jx[f"{tag}/decode"], r, mname,
                                           axis=1), TOL_FWD, f"{tag} decode")
        lo, hi = plan.kv[r[mname]["index"]["model"]]
        exp = _batch_block(jx[f"{tag}/cache_k"], r, mname, axis=1)[
            :, :, :, lo:hi]
        _close(res["cache_k"], exp, TOL_FWD, f"{tag} cache")


@pytest.mark.parametrize("mname,name", CASES)
def test_grads_match_jax_mesh(mesh_run, mname, name):
    """The loss's gradient before Adam, summed as the train step sums it
    (the k/v blocks over the ranks that share them, the leaves whole over
    the data axes over ``pod``) and gathered whole, within 1e-4 of JAX's
    on every leaf (of its largest), on every rank."""
    exp = _jax_tree(mesh_run["jax"], f"{mname}/{name}/grad/")
    for r in mesh_run["out"]:
        got = r[mname][name]["grad"]
        assert set(got) == set(exp)
        for path in exp:
            _close_rel(got[path], exp[path], TOL_GRAD,
                            f"{mname} {name} {path}")


@pytest.mark.parametrize("mname,name", CASES)
def test_train_steps_match_jax_mesh(mesh_run, mname, name):
    """2 steps of the registry's train cell from Adam's count 200: losses,
    global grad norms and the MoE balance loss within 1e-4 of JAX's, the
    same on every rank; every parameter and both moments within 1e-4 of
    the leaf's largest, each leaf's change within TOL_CHANGE of its norm;
    the KV blocks of the ranks that share a head equal bit for bit."""
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
    # the replicas of a KV head took the same steps
    by_head = {}
    cfg = ranks.heads_config(name)
    plan = lm_parallel.head_plan(cfg.n_heads, cfg.n_kv,
                                 ranks.MESHES[mname][2])
    for r in mesh_run["out"]:
        i = r[mname]["index"]
        key = (plan.kv[i["model"]], i.get("pod", 0), i["data"])
        blocks = r[mname][name]["kv_blocks"]
        if key in by_head:
            for p, t in blocks.items():
                assert np.array_equal(t, by_head[key][p]), (tag, p)
        by_head[key] = blocks
    if lm_family.CONFIGS[name].is_moe:
        assert all(a > 0 for a in first["moe_aux"])


# ----------------------------------------------------------------- controls

def _kv_paths(tree) -> list:
    return [p for p in tree if "/attn/k/" in p or "/attn/v/" in p]


@pytest.mark.parametrize("name", NAMES)
def test_kv_grads_without_the_group_sum_miss(mesh_run, name):
    """On (1, 4) each rank's k/v gradient without the sum over the 2 ranks
    that share its KV head (``kv_in_region`` the identity) holds its own
    query heads' part only: every k/v weight leaf misses JAX's gradient
    by more than the limit, while every other leaf still holds it."""
    exp = _jax_tree(mesh_run["jax"], f"1x4/{name}/grad/")
    for r in mesh_run["out"]:
        res = r["1x4"][name]
        got = res["no_kv_sum_grad"]
        for path in _kv_paths(exp):
            if not path.endswith("/w"):
                continue
            e = np.abs(got[path] - exp[path]).max() / np.abs(
                exp[path]).max()
            assert e > TOL_GRAD, (path, e)
        for path in exp:
            if path not in _kv_paths(exp):
                _close_rel(got[path], exp[path], TOL_GRAD, path)


@pytest.mark.parametrize("name", NAMES)
def test_clip_counting_each_replica_misses(mesh_run, name):
    """On (1, 4) a clip that counts each replica of a KV head's block
    (``replica_mask`` without the owner rule) takes a larger global norm
    than JAX's, by more than the limit, and its steps' parameters miss
    the change limit on some leaf."""
    jx, tag = mesh_run["jax"], f"1x4/{name}"
    exp = _jax_tree(jx, f"{tag}/params/")
    before = _before(mesh_run["inp"], name)
    for r in mesh_run["out"]:
        res = r["1x4"][name]["clip_each_replica"]
        gap = np.array(res["grad_norms"]) - jx[f"{tag}/grad_norms"]
        assert gap.min() > TOL_GRAD, gap
        worst = max(_change_err(res["params"][p], exp[p], before[p])
                    for p in exp)
        assert worst > TOL_CHANGE, worst
