"""DimeNet on a mesh: the port's edges and triplets over every axis
(``gnn_batch_specs``), its placed collectives and its gradient rule,
against the JAX package's mesh run, in gloo ranks on the CPU.

The inputs are drawn from seeds (``_torch_gnn_mesh_ranks.inputs``):
DimeNet's reduced config (2 blocks, d 32) at graph level (4 molecules)
and node level (a padded fanout subgraph). The JAX package runs them on
4 forced host devices in two subprocesses, one a mesh
(``_jax_gnn_mesh_ref.py``): (data=4, model=1) and (data=2, model=2),
GSPMD placing the collectives. One group of 4 port ranks runs both
meshes (``_torch_gnn_mesh_ranks.py``, torch only) and this process runs
the port's one-process steps.

Tolerances: the loss within 1e-5 of its magnitude (at least 1); each
gradient leaf, as Adam takes it (after the mesh step's sum), within 1e-4
of the leaf's largest (the reference's own f32 gradient limit,
``ROADMAP.md``); after 2 train steps (``GNN_OPT``: lr 1e-3, so a step
moves a weight by ~1e-3) the losses within 1e-5, each parameter within
1e-4 and each leaf's change within 1e-3 of the norm of JAX's change (the
unchanged parameters miss by 1). Against the port's one process, where
the function is the same, 1e-5. Each control must miss its check.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_gnn_mesh_ranks as ranks  # noqa: E402
from repro_torch.configs import gnn_family as gf  # noqa: E402
from repro_torch.configs.base import shard_abstract  # noqa: E402
from repro_torch.distributed import sharding as shx  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for, run_on_mesh  # noqa: E402
from repro_torch.models.gnn import dimenet  # noqa: E402
from repro_torch.optim.adam import adam_init, leaves  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 4
TOL_LOSS, TOL_GRAD, TOL_ONE, TOL_PARAM, TOL_CHANGE = 1e-5, 1e-4, 1e-5, \
    1e-4, 1e-3
MESH_TIMEOUT_S = 300
MESHES, LEVELS = list(ranks.MESHES), list(ranks.LEVELS)
CASES = [(m, lv) for m in MESHES for lv in LEVELS]


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("gnn_mesh")
    inp = ranks.inputs()
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"),
         os.environ.get("PYTHONPATH", "")]),
        XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = {m: subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_jax_gnn_mesh_ref.py"),
         str(d / "in.npz"), str(d / f"{m}.npz"), m], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for m in MESHES}
    try:
        out = run_on_mesh(ranks.gnn_mesh_cases, N, ["cpu"] * N,
                          args=(inp,), timeout=MESH_TIMEOUT_S)
        one = {lv: ranks.one_process(inp, lv) for lv in LEVELS}
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


def _paths(level):
    """The parameter paths in the port's leaf order."""
    return [k for k, _ in leaves(dimenet.init(
        torch.Generator().manual_seed(1), ranks.mesh_config(level)))]


def _rel(got, exp) -> float:
    """The largest error of ``got`` over ``exp``'s largest magnitude."""
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    assert got.shape == exp.shape, (got.shape, exp.shape)
    return float(np.abs(got - exp).max() / max(np.abs(exp).max(), 1e-30))


def _loss_err(got, exp) -> float:
    return abs(float(got) - float(exp)) / max(abs(float(exp)), 1.0)


def _grad_errs(got: list, exp: dict, level) -> dict:
    return {k: _rel(g, exp[k]) for k, g in zip(_paths(level), got)}


def _jax_tree(run, tag, what) -> dict:
    pre = f"{tag}/{what}/"
    return {k[len(pre):]: v for k, v in run["jax"].items()
            if k.startswith(pre)}


@pytest.mark.parametrize("mesh,level", CASES)
def test_loss_matches_jax_mesh(mesh_run, mesh, level):
    """Every rank's loss the same, within TOL_LOSS of JAX's on its mesh
    and of the port's one process."""
    tag = f"{mesh}/{level}"
    got = [float(r[f"{tag}/loss"]) for r in mesh_run["out"]]
    assert len(set(got)) == 1, got
    assert _loss_err(got[0], mesh_run["jax"][f"{tag}/loss"]) <= TOL_LOSS
    assert _loss_err(got[0], mesh_run["one"][level]["loss"]) <= TOL_ONE


@pytest.mark.parametrize("mesh,level", CASES)
def test_gradients_match_jax_mesh(mesh_run, mesh, level):
    """Each leaf's gradient as Adam takes it, the same on every rank,
    within TOL_GRAD of its largest against JAX's mesh run and TOL_ONE
    against the port's one process; ``out_mlp1``/``out_mlp2`` (whole on
    every rank before the sum) as well as the edge-side leaves (each
    rank's part, summed over every axis)."""
    tag = f"{mesh}/{level}"
    g0 = mesh_run["out"][0][f"{tag}/grads"]
    for r in mesh_run["out"][1:]:
        assert all(np.array_equal(a, b) for a, b in zip(g0, r[f"{tag}/grads"]))
    errs = _grad_errs(g0, _jax_tree(mesh_run, tag, "grad"), level)
    assert max(errs.values()) <= TOL_GRAD, errs
    one = dict(zip(_paths(level), mesh_run["one"][level]["grads"]))
    errs = _grad_errs(g0, {k: v.numpy() for k, v in one.items()}, level)
    assert max(errs.values()) <= TOL_ONE, errs
    assert any(k.startswith("out_mlp") for k in errs)


@pytest.mark.parametrize("mesh,level", CASES)
def test_train_steps_match_jax_mesh(mesh_run, mesh, level):
    """2 steps of ``gnn_family.make_fn(mesh=)``: the losses, each
    parameter and each leaf's change against JAX's 2 steps on its mesh;
    the parameters against the port's one process."""
    tag = f"{mesh}/{level}"
    r0 = mesh_run["out"][0]
    jl = mesh_run["jax"][f"{tag}/losses"]
    assert all(_loss_err(a, b) <= TOL_LOSS
               for a, b in zip(r0[f"{tag}/losses"], jl))
    before = dict(zip(_paths(level), [
        mesh_run["inp"][f"{level}/p/{k}"] for k in _paths(level)]))
    exp = _jax_tree(mesh_run, tag, "params")
    one = mesh_run["one"][level]["params"]
    for k, got, o in zip(_paths(level), r0[f"{tag}/params"], one):
        assert float(np.abs(got - exp[k]).max()) <= TOL_PARAM, k
        change = np.linalg.norm(exp[k] - before[k])
        assert change > 0, k
        assert np.linalg.norm(got - exp[k]) / change <= TOL_CHANGE, k
        assert float(np.abs(got - o.numpy()).max()) <= TOL_ONE, k
        # the unchanged parameters miss the change check
        assert np.linalg.norm(before[k] - exp[k]) / change > TOL_CHANGE
    for r in mesh_run["out"][1:]:
        assert all(np.array_equal(a, b) for a, b in
                   zip(r0[f"{tag}/params"], r[f"{tag}/params"]))


@pytest.mark.parametrize("mesh,level", CASES)
def test_controls_miss(mesh_run, mesh, level):
    """Each broken variant misses the check its right form passes: a sum
    that also adds ``out_mlp1``/``out_mlp2`` over the mesh (their
    gradients R times the whole), a sum over ``data`` only on (2, 2)
    (the edge-side leaves still partial over ``model``), and triplet sums
    each rank keeps partial (no reduce-scatter: another loss)."""
    tag = f"{mesh}/{level}"
    exp = _jax_tree(mesh_run, tag, "grad")
    r0 = mesh_run["out"][0]
    errs = _grad_errs(r0[f"{tag}/ctl_every"], exp, level)
    assert all(errs[k] > TOL_GRAD for k in errs if k.startswith("out_mlp"))
    assert all(errs[k] <= TOL_GRAD for k in errs
               if not k.startswith("out_mlp"))
    if f"{tag}/ctl_data" in r0:
        errs = _grad_errs(r0[f"{tag}/ctl_data"], exp, level)
        assert max(errs.values()) > TOL_GRAD
    else:
        assert mesh == "4x1"
    assert _loss_err(r0[f"{tag}/ctl_rs"],
                     mesh_run["jax"][f"{tag}/loss"]) > TOL_LOSS


@pytest.mark.parametrize("level", LEVELS)
def test_a_mesh_of_one_rank_is_one_process_bit_for_bit(level):
    """With a mesh of one rank every collective returns its input: the
    forward, the loss's gradients and a train step equal one process's
    bit for bit."""
    inp = {k: v for k, v in ranks.inputs().items()
           if k.startswith(f"{level}/")}
    cfg, ng = ranks.mesh_config(level), ranks.LEVELS[level]
    batch = ranks.batch_of(inp, level)
    one = make_mesh_for(1)
    with torch.no_grad():
        a = dimenet.forward(ranks.params_of(inp, level), cfg, batch,
                            n_graphs=ng)
        b = dimenet.forward(ranks.params_of(inp, level), cfg, batch,
                            n_graphs=ng, mesh=one)
    assert torch.equal(a, b)
    outs = []
    for mesh in (None, one):
        p = ranks.params_of(inp, level)
        p, o, m = gf.make_fn(cfg, "train", n_graphs=ng, mesh=mesh)(
            p, adam_init(p), batch)
        outs.append([t for _, t in leaves(p)] + [m["loss"], m["grad_norm"]])
    assert all(torch.equal(x, y) for x, y in zip(*outs))


def test_gnn_batch_specs_are_the_jax_packages():
    """Edges and triplets over every axis, node arrays whole, at the
    production meshes' axis names."""
    from jax.sharding import PartitionSpec as P
    from repro.distributed import sharding as jshx
    from repro_torch.launch.mesh import make_production_mesh
    b = gf._batch_abs(gf.GNN_SHAPES["molecule"])
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        got = shx.gnn_batch_specs(mesh, b)
        exp = jshx.gnn_batch_specs(mesh, {k: 0 for k in b})
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in exp.items()}
        assert {k: tuple(v) for k, v in exp.items()}["edge_src"] == \
            (tuple(mesh.axis_names),) and tuple(exp["pos"]) == tuple(P())


@pytest.mark.parametrize("shape", list(gf.GNN_SHAPES))
def test_abstract_args_give_a_ranks_blocks(shape):
    """``abstract_args(mesh=)`` at 16 x 16: the parameters and moments
    whole, each edge and triplet array a 256th, the node arrays whole;
    ``whole_batch`` keeps the batch whole; a mesh of 5 ranks (which
    divides no cell's T) raises."""
    from repro_torch.launch.mesh import make_production_mesh
    cell = gf.archs()[0].cells[shape]
    mesh = make_production_mesh()
    whole = cell.abstract_args()
    blocks = cell.abstract_args(mesh=mesh)
    for w, b in ((whole[0], blocks[0]), (whole[1]["m"], blocks[1]["m"])):
        assert [t.shape for _, t in leaves(w)] == \
            [t.shape for _, t in leaves(b)]
    for k, t in whole[2].items():
        n = 256 if k.startswith(("edge_", "trip_")) else 1
        assert blocks[2][k].shape[0] * n == t.shape[0], k
        assert blocks[2][k].device.type == "meta"
    full = cell.abstract_args(mesh=mesh, whole_batch=True)[2]
    assert {k: t.shape for k, t in full.items()} == \
        {k: t.shape for k, t in whole[2].items()}
    with pytest.raises(ValueError, match="must divide"):
        cell.abstract_args(mesh=make_mesh_for(5))
    exp = shard_abstract(whole[2], shx.gnn_batch_specs(mesh, whole[2]), mesh)
    assert {k: t.shape for k, t in exp.items()} == \
        {k: t.shape for k, t in blocks[2].items()}
