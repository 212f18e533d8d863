"""The dry-run on a mesh (``launch/dryrun.py --mesh``), the collectives'
meta route and counted wire bytes (``distributed/collectives.py``,
``launch/op_analysis.py``), the collective term (``launch/roofline.py``)
and SpeedyFeed's conventional mesh step, against the JAX package on the
CPU.

Held here:

* each collective on meta tensors calls no ``dist`` function (no process
  group exists), returns the real call's shape (forward and backward for
  the autograd ones) and records hlo_analysis's ring wire bytes, at
  groups of 2, 16 and 256;
* ``run_cell`` at a (data=2, model=2) mesh against the JAX package's
  ``from_compiled`` of the same cell compiled on 4 forced host devices
  (``_jax_dryrun_mesh_ref.py``), DimeNet ``molecule`` and DCN-v2
  ``serve_p99``: ``flops_per_chip`` within 1e-2. Collective bytes:
  DCN-v2's one all-reduce of the lookups over ``model`` is the same in
  both, bytes and count. For DimeNet GSPMD chose other collectives than
  the port: the all-gathers correspond (the edges' endpoints and each
  block's messages forward, the triplet sums' gradients backward; count
  equal, wire within 1e-2), but GSPMD reduces each partial [E, ·] sum by
  an all-reduce of the whole and a slice where the port reduce-scatters
  it, and all-reduces each block's node sum where the port sums once
  after the last block, so the port's reduce-scatter and all-reduce wire
  together is held below GSPMD's all-reduce wire;
* every registry cell at 16 x 16 and 2 x 16 x 16 ``ok``, or a ``skip``
  with its own reason, with a collective term above 0 for every ``ok``
  cell whose step communicates: every LM cell counts on both meshes
  (the head plan, rank 0 holding the most query heads; a decode cell's
  departure names the KV replication);
* every rank of a (1, 4) mesh counted: the matmul FLOPs summed are one
  process's plus exactly the k/v projections' that the KV replication
  repeats;
  the CLI's ``--mesh both`` in a subprocess under 4 GB resident; the
  no-mesh records as the parent commit counted them;
* the conventional step on 4 gloo ranks (pure data parallelism over
  every axis) against the JAX package's step with the instances over
  every axis: the loss within 1e-5, each gradient leaf within 1e-4 of
  its largest (the reference's f32 gradient limit), the 2 steps' losses
  and grad norms within 1e-5 and each parameter within 1e-4
  (``tests/test_torch_conventional.py``'s step tolerance).
"""
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_dryrun_mesh_ranks as ranks  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.distributed import collectives as coll  # noqa: E402
from repro_torch.launch import dryrun, op_analysis  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch.mesh import (make_mesh_for,  # noqa: E402
                                    make_production_mesh, run_on_mesh)
from repro_torch.models import lm_parallel  # noqa: E402
from repro_torch.optim.adam import (data_grad_axes, leaves,  # noqa: E402
                                    sync_grads)
from repro_torch.distributed.sharding import Spec  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL_FLOPS, TOL_WIRE = 1e-2, 1e-2
TOL_LOSS, TOL_GRAD, TOL_STEP = 1e-5, 1e-4, 1e-4
TIMEOUT_S = 300
# tests/test_torch_conventional.py's tiny widths (K=3, the bus path)
TINY = dict(vocab=300, n_layers=1, d_model=32, n_heads=4, d_ff=64,
            n_segments=3, seg_len=8, news_dim=16, n_news=128, gamma=5,
            beta=1.0, encode_budget=12, batch_users=4, hist_len=8,
            merged_cap=32, n_neg=3)
# the parent commit's one-card counts (flops, bytes, peak live bytes)
NO_MESH = {
    ("dimenet", "molecule"): (58524499968.0, 5713469472.0, 588602416.0),
    ("dimenet", "ogb_products"): (340368083020032.0, 35799552977328.0,
                                  3522947400277.0),
    ("dcn-v2", "serve_p99"): (2626789376.0, 77383208.0, 2113670696.0),
    ("speedyfeed", "train_prod"): (275457561329664.0, 3548018849024.0,
                                   35210810728.0),
    ("bert4rec", "serve_p99"): (227226419200.0, 20519385856.0,
                                6914212352.0),
}


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ----------------------------------------------------- collectives on meta

def _group(g):
    """(a counting mesh, the axis whose group has g ranks)."""
    if g == 2:
        return make_mesh_for(2), "data"
    return make_production_mesh(), ("model" if g == 16 else None)


def _counted(fn):
    with op_analysis.OpCounter() as c:
        out = fn()
    return out, c.result()


@pytest.mark.parametrize("g", [2, 16, 256])
@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "collective-permute"])
def test_a_collective_on_meta_returns_the_shape_and_counts_its_wire(kind, g):
    mesh, axis = _group(g)
    x = meta(512, 8)
    r = 512 * 8 * 4
    call = {"all-reduce": lambda: coll.all_reduce(x, mesh, axis=axis),
            "all-gather": lambda: coll.all_gather(x, mesh, axis=axis),
            "reduce-scatter": lambda: coll.reduce_scatter(x, mesh,
                                                          axis=axis),
            "collective-permute": lambda: coll.broadcast(
                x, make_mesh_for(g))}[kind]
    out, res = _counted(call)
    shape = {"all-gather": (512 * g, 8),
             "reduce-scatter": (512 // g, 8)}.get(kind, (512, 8))
    assert tuple(out.shape) == shape and out.device.type == "meta"
    result = out.numel() * 4
    wire = {"all-gather": result * (g - 1) / g,
            "all-reduce": 2 * result * (g - 1) / g,
            "reduce-scatter": result * (g - 1),
            "collective-permute": result}[kind]
    assert res["coll_wire"] == {kind: wire}
    assert res["coll_count"] == {kind: 1}
    assert res["coll_wire_total"] == wire
    assert res["breakdown"][f"collective:{kind}"]["bytes"] == 2 * result
    assert res["coll_operand_total"] == {
        "all-gather": r, "reduce-scatter": r,
        "all-reduce": r, "collective-permute": r}[kind]
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("g", [2, 16, 256])
def test_the_autograd_collectives_keep_their_shapes_on_meta(g):
    """copy_to, reduce_from, gather_weight, all_gather_grad and
    reduce_scatter_grad: forward and backward shapes, and the kinds each
    records (the backward of a gather is a reduce-scatter, and the other
    way round)."""
    mesh, axis = _group(g)
    n = g if axis is not None else mesh.world

    def run(fn, x):
        x = x.requires_grad_()
        with op_analysis.OpCounter() as c:
            y = fn(x)
            fwd = dict(c.coll_count)
            (gx,) = torch.autograd.grad(y.sum(), x)
        return y.shape, gx.shape, fwd, dict(c.coll_count)

    cases = {
        "copy_to": (lambda t: coll.copy_to(t, mesh, axis), (64, 32), {},
                    {"all-reduce": 1}),
        "reduce_from": (lambda t: coll.reduce_from(t, mesh, axis), (64, 32),
                        {"all-reduce": 1}, {"all-reduce": 1}),
        "gather_weight": (lambda t: coll.gather_weight(t, mesh, 1, axis),
                          (64, 32 * n), {"all-gather": 1},
                          {"all-gather": 1, "reduce-scatter": 1}),
        "reduce_scatter_grad": (
            lambda t: coll.reduce_scatter_grad(t.repeat(n, 1), mesh, axis),
            (64, 32), {"reduce-scatter": 1},
            {"reduce-scatter": 1, "all-gather": 1}),
    }
    if mesh.size(axis) == mesh.world:
        cases["all_gather_grad"] = (lambda t: coll.all_gather_grad(t, mesh),
                                    (64 * n, 32), {"all-gather": 1},
                                    {"all-gather": 1, "reduce-scatter": 1})
    for name, (fn, shape, fwd, both) in cases.items():
        ys, gs, f, b = run(fn, meta(64, 32))
        assert tuple(ys) == shape and tuple(gs) == (64, 32), name
        assert f == fwd and b == both, (name, f, b)


def test_mesh_axes_as_tuples_and_node_locality():
    """The data axes as a tuple: their size, this rank's index among them
    (pod-major, as ``shard_block`` numbers the blocks), one node or not."""
    m = make_production_mesh(multi_pod=True)
    assert m.size(("pod", "data")) == 32 and m.name == "2x16x16"
    r = type(m)(m.axis_names, m.shape, rank=16 * 16 + 3 * 16 + 5)
    assert (r.index("pod"), r.index("data"), r.index("model")) == (1, 3, 5)
    assert r.index(("pod", "data")) == 16 + 3
    assert not any(m.in_one_node(a) for a in (None, "pod", "data", "model"))
    small = make_mesh_for(4, model=2)
    assert small.in_one_node(None) and small.in_one_node("data")
    assert make_production_mesh().size(("pod", "data")) == 16


def test_sync_grads_sums_over_the_pod_axis_too():
    """On 2 x 16 x 16 a whole leaf's gradient is summed over (pod, data),
    32 ranks; a leaf cut over data over pod only; on meta, counted."""
    mesh = make_production_mesh(multi_pod=True)
    assert data_grad_axes(Spec(), mesh) == ("pod", "data")
    assert data_grad_axes(Spec("data", None), mesh) == ("pod",)
    p = [meta(128), meta(4, 128)]
    with op_analysis.OpCounter() as c:
        sync_grads([meta(128), meta(4, 128)], p, [Spec(), Spec("data", None)],
                   mesh)
    res = c.result()
    assert res["coll_count"] == {"all-reduce": 2}
    assert res["coll_wire"]["all-reduce"] == pytest.approx(
        2 * 512 * 31 / 32 + 2 * 2048 * 1 / 2)


def test_the_collective_term_takes_nvlink_in_a_node_and_ib_across():
    kw = dict(arch="a", shape="s", mesh="m", chips=256, flops_per_chip=0.0,
              bytes_per_chip=0.0, coll_bytes_per_chip=9e9, coll_detail={},
              peak_memory_per_chip=0.0, model_flops=0.0)
    r = rl.Roofline(**kw, coll_bytes_in_node=4.5e9)
    assert r.t_collective == pytest.approx(4.5e9 / 450e9 + 4.5e9 / 50e9)
    assert r.bottleneck == "collective"
    assert rl.Roofline(**dict(kw, coll_bytes_per_chip=0.0)).t_collective == 0


# ------------------------------------------------------------ vs JAX

def _conv_inputs():
    """(JAX parameters, port parameters, the batch): the tiny config's
    parameters from JAX's init, bridged, and a conventional batch of 8
    instances (2 a rank) drawn with numpy."""
    jcfg = jcore.make_config(attn_impl="xla", **TINY)
    jp = jax.tree.map(np.asarray, jcore.init_speedyfeed(
        jax.random.PRNGKey(1), jcfg))
    rng = np.random.default_rng(0)
    B, L, C, K, S = 8, 6, 2, TINY["n_segments"], TINY["seg_len"]
    def tok(*s):
        return rng.integers(1, TINY["vocab"], s).astype(np.int32)

    hist_mask = rng.random((B, L)) < 0.7
    hist_mask[:, 0] = True
    batch = {"hist_tokens": tok(B, L, K, S),
             "hist_freq": rng.integers(0, 4, (B, L, K, S)).astype(np.int32),
             "hist_mask": hist_mask,
             "cand_tokens": tok(B, C, K, S),
             "cand_freq": rng.integers(0, 4, (B, C, K, S)).astype(np.int32),
             "label": rng.integers(0, C, B).astype(np.int32),
             "cand_mask": np.ones((B, C), bool)}
    return jp, params_from_jax(jp, device="cpu"), batch


def _flat_np(tree, prefix=""):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out[prefix + "/".join(str(p.key) if hasattr(p, "key") else
                              str(p.idx) for p in path)] = np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_mesh")
    jp, tp, batch = _conv_inputs()
    inp = {"conv/cfg": json.dumps(TINY), **_flat_np(jp, "conv/p/"),
           **{f"conv/b/{k}": v for k, v in batch.items()}}
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"),
         os.environ.get("PYTHONPATH", "")]),
        XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_jax_dryrun_mesh_ref.py"),
         str(d / "in.npz"), str(d / "out.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        port = run_on_mesh(ranks.conventional_cases, 4, ["cpu"] * 4,
                           model=2, timeout=TIMEOUT_S,
                           args=(TINY, tp, {k: torch.as_tensor(v)
                                            for k, v in batch.items()}))
        log = proc.communicate(timeout=TIMEOUT_S)[0].decode()
        assert proc.returncode == 0, f"JAX reference failed:\n{log}"
    finally:
        if proc.poll() is None:
            proc.kill()
    return dict(jax=dict(np.load(d / "out.npz")), port=port,
                paths=[k for k, _ in leaves(tp)])


@pytest.mark.parametrize("arch,shape", [("dimenet", "molecule"),
                                        ("dcn-v2", "serve_p99")])
def test_mesh_count_matches_jax_from_compiled(jax_run, arch, shape):
    want = json.loads(str(jax_run["jax"][f"{arch}/{shape}"]))
    rec = dryrun.run_cell(configs.get_arch(arch).cells[shape],
                          mesh=make_mesh_for(4, model=2), verbose=False)
    assert rec["status"] == "ok" and rec["mesh"] == "2x2" \
        and rec["chips"] == 4 == want["chips"]
    assert abs(rec["flops_per_chip"] / want["flops_per_chip"] - 1) \
        <= TOL_FLOPS
    got, exp = rec["coll_detail"], want["coll_detail"]
    assert set(got) >= {"operand_convention_total"}
    if arch == "dcn-v2":
        assert got == exp
        assert rec["coll_bytes_per_chip"] == want["coll_bytes_per_chip"]
        return
    # module docstring: the gathers correspond; GSPMD all-reduces what the
    # port reduce-scatters, and each block's node sum
    assert got["n_all-gather"] == exp["n_all-gather"]
    assert abs(got["all-gather"] / exp["all-gather"] - 1) <= TOL_WIRE
    assert got["reduce-scatter"] + got["all-reduce"] < exp["all-reduce"]
    assert rec["t_collective"] > 0


def test_conventional_mesh_step_matches_jax(jax_run):
    jx, paths = jax_run["jax"], jax_run["paths"]
    port = jax_run["port"]
    for r in port:
        assert abs(float(r["loss"]) - float(jx["conv/loss"])) <= TOL_LOSS
        assert np.allclose(r["losses"], jx["conv/losses"], rtol=0,
                           atol=TOL_LOSS)
        assert np.allclose(r["grad_norms"], jx["conv/grad_norms"], rtol=0,
                           atol=TOL_LOSS * max(jx["conv/grad_norms"]))
    g0, p0 = port[0]["grads"], port[0]["params"]
    grads = {k: v.numpy() for k, v in leaves(params_from_jax(
        _unflat(jx, "conv/grad/"), device="cpu"))}
    after = {k: v.numpy() for k, v in leaves(params_from_jax(
        _unflat(jx, "conv/params/"), device="cpu"))}
    largest = max(float(np.abs(e).max()) for e in grads.values())
    for k, g, p in zip(paths, g0, p0):
        e = grads[k]
        # the key biases' gradient is 0 in exact arithmetic (a shift of
        # every key's logit leaves the softmax): held against the largest
        scale = largest if k.endswith("attn/k/b") else float(np.abs(e).max())
        assert float(np.abs(g - e).max()) <= TOL_GRAD * scale, k
        assert float(np.abs(p - after[k]).max()) <= TOL_STEP, k
    assert len(paths) >= 20
    for r in port[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(p0, r["params"]))


def _unflat(flat: dict, prefix: str):
    tree = {}
    for key, arr in flat.items():
        if key.startswith(prefix):
            node, parts = tree, key[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
    return tree


# ---------------------------------------------------- the registry, CLI

def test_every_cell_counts_or_skips_with_its_reason_on_both_meshes():
    recs = dryrun.run(configs.list_archs(), mesh_sel="both")
    assert {r["mesh"] for r in recs} == {"16x16", "2x16x16"}
    for r in recs:
        assert r["status"] in ("ok", "skip"), r
        if r["status"] == "skip":
            assert r["reason"]
            continue
        assert r["chips"] == (256 if r["mesh"] == "16x16" else 512)
        if (r["arch"], r["shape"]) != ("speedyfeed", "encode_bulk"):
            assert r["t_collective"] > 0, (r["arch"], r["shape"])
            assert r["coll_detail"]["operand_convention_total"] > 0
        else:
            assert r["t_collective"] == 0
    # every LM cell counts on both meshes (long_500k skips on the four
    # full-attention configs only, by its own reason): 16 a mesh
    lm = [r for r in recs if configs.get_arch(r["arch"]).family == "lm"]
    counted = [r for r in lm if r["status"] == "ok"]
    assert len(counted) == 32 and {r["mesh"] for r in counted} == {
        "16x16", "2x16x16"}
    assert all("sub-quadratic" in r["reason"] for r in lm
               if r["status"] == "skip")
    for r in counted:
        assert r["t_collective"] > 0 and r["peak_memory_per_chip"] > 0
        if r["kind"] == "decode":
            assert "replicated" in r["departure"], r
        else:
            assert "departure" not in r
    # rank 0, the counted rank, holds the most query heads of any rank
    for name in ("qwen3-14b", "llama4-scout-17b-a16e", "dbrx-132b"):
        cfg = configs.get_arch(name).config
        plan = lm_parallel.head_plan(cfg.n_heads, cfg.n_kv, 16)
        counts = [hi - lo for lo, hi in plan.q]
        for multi in (False, True):
            mesh = make_production_mesh(multi_pod=multi)
            assert lm_parallel.local_attn_cfg(cfg.attn_cfg(), mesh) \
                .n_heads == max(counts) == counts[0]
    sf = [r for r in recs if (r["arch"], r["shape"]) ==
          ("speedyfeed", "train_prod")]
    assert all("ZeRO-1" in r["departure"] for r in sf)


def test_every_rank_counted_repeats_only_the_replicated_kv_work():
    """The reduced Qwen3-14B at 6 query heads over 2 KV heads (remat, loss
    chunk 8), its train step at B=4, S=32 on a (data=1, model=4) mesh,
    counted on meta at every rank: each KV head is replicated over R = 2
    ranks, which hold 2 and 1 of its 3 query heads. The ranks' aten
    matmul FLOPs summed are one process's plus exactly (R - 1) times the
    k and v projections' (forward, its remat, and the two backward
    products: 4 a layer), the work replication repeats; the flash
    kernels' FLOPs summed are one process's (the query heads are cut,
    not repeated), rank 0's twice rank 1's."""
    import _torch_lm_mesh_heads_ranks as heads
    from repro_torch.configs import lm_family
    from repro_torch.configs.base import (abstract_opt, abstract_params,
                                          meta, shard_abstract)
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import lm
    cfg = heads.heads_config("qwen3-14b")
    B, S, M = 4, 32, 4

    def count(mesh):
        params = abstract_params(lambda g: lm.init(g, cfg))
        opt = abstract_opt(params)
        if mesh is not None:
            specs = lm_parallel.param_specs(params, cfg, mesh)
            opt = dict(opt, m=shard_abstract(opt["m"], specs, mesh),
                       v=shard_abstract(opt["v"], specs, mesh))
            params = shard_abstract(params, specs, mesh)
        batch = {k: meta((B, S), torch.int32) for k in ("tokens", "labels")}
        args = (params, opt, batch)
        with op_analysis.OpCounter(args) as counter:
            lm_family.make_fn(cfg, "train", mesh)(*args)
        br = counter.result()["breakdown"]
        return br["matmul"]["flops"], sum(
            v["flops"] for k, v in br.items() if k.startswith("kernel:flash"))

    one = count(None)
    every = [count(Mesh(("data", "model"), {"data": 1, "model": M}, rank=r))
             for r in range(M)]
    R = lm_parallel.head_plan(cfg.n_heads, cfg.n_kv, M).R
    kv = cfg.n_layers * 4 * 2 * (2 * B * S * cfg.d_model * cfg.n_kv * cfg.hd)
    assert R == 2
    assert sum(mm for mm, _ in every) == one[0] + (R - 1) * kv
    assert sum(fl for _, fl in every) == one[1]
    assert every[0][1] == 2 * every[1][1]


@pytest.mark.parametrize("arch,shape", list(NO_MESH))
def test_the_no_mesh_records_are_unchanged(arch, shape):
    rec = dryrun.run_cell(configs.get_arch(arch).cells[shape], verbose=False)
    assert (rec["flops_per_chip"], rec["bytes_per_chip"],
            rec["peak_memory_per_chip"]) == NO_MESH[(arch, shape)]
    assert rec["mesh"] == rl.MESH and rec["chips"] == 1
    assert rec["t_collective"] == 0.0 and rec["coll_detail"] == {}


def test_cli_mesh_both_counts_large_cells_in_little_memory(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               PYTHONDONTWRITEBYTECODE="1")
    out_path = tmp_path / "mesh.jsonl"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "dimenet,qwen3-14b", "--mesh", "both", "--out", str(out_path)],
        capture_output=True, text=True, env=env, timeout=TIMEOUT_S,
        check=True).stdout
    m = re.search(r"dry-run summary: (\d+) ok, (\d+) fail, (\d+) skip; "
                  r"[\d.]+ s; ru_maxrss ([\d.]+) GB", out)
    assert m and m.groups()[:3] == ("14", "0", "2"), out[-2000:]
    assert float(m.group(4)) < 4.0
    recs = [json.loads(line) for line in open(out_path)]
    ogb = [r for r in recs if r["shape"] == "ogb_products"]
    assert [r["mesh"] for r in ogb] == ["16x16", "2x16x16"]
    assert all(r["status"] == "ok" and r["t_collective"] > 0 for r in ogb)
    with pytest.raises(subprocess.CalledProcessError):
        subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "dimenet", "--mesh", "single",
                        "--measure"], capture_output=True, env=env,
                       timeout=TIMEOUT_S, check=True)
