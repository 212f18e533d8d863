"""The recsys family on a (data, model) mesh: the port's row-sharded
tables (``recsys_rules``) through the EmbeddingBag kernel's wrapper,
BERT4Rec's two-stage ``serve_sharded`` and the train, serve and retrieval
steps, against the JAX package's mesh run, in gloo ranks on the CPU.

The inputs are drawn with numpy from a seed (``_torch_recsys_mesh_ranks.
inputs``): the four reduced configs' parameters (the layout of ``init``,
JAX's), a batch of 8, the retrieval candidates. The JAX package runs them
on 4 forced host devices in two subprocesses, one a mesh
(``_jax_recsys_mesh_ref.py``), while one group of 4 port ranks runs both
meshes (``_torch_recsys_mesh_ranks.py``, torch only) and this process
runs the port's one-process steps.

Tolerances: logits and scores within 1e-5 of the largest; gradients,
Adam's moments and parameters within 1e-4 of each leaf's largest (the
reference's own f32 gradient limit, ``ROADMAP.md``); each leaf's change
over the 2 steps within 1e-3 of the norm of the reference's change
(``RS_OPT``'s lr is a constant 1e-3, so a step moves a touched weight by
~1e-3, above the other limits: the unchanged state misses by 1). Against
the port's one process, where the function is the same, 1e-5.

BERT4Rec's key biases (``attn/k/b``) have a gradient of 0 in exact
arithmetic (the softmax over keys is unchanged by one shift of every
key's logit), so their gradient is rounding noise and Adam's step, which
divides by its own RMS, moves them by ~lr with a sign set by rounding:
their gradients and moments are held against the largest leaf of the
tree, and their parameters and changes are not held.

Top-k ids: ``torch.topk`` and ``lax.top_k`` may order equal scores
differently, so ids are compared position by position only where the
scores are apart, and as sets within a run of scores tied within
rounding (``_same_ids``).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_recsys_mesh_ranks as ranks  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import recsys_family as rf  # noqa: E402
from repro_torch.configs.base import shard_abstract  # noqa: E402
from repro_torch.launch.mesh import (Mesh, make_mesh_for,  # noqa: E402
                                    run_on_mesh)
from repro_torch.models.recsys import ctr  # noqa: E402
from repro_torch.models.recsys import parallel as rp  # noqa: E402
from repro_torch.optim.adam import leaves  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 4
TOL_FWD, TOL_GRAD, TOL_ONE, TOL_CHANGE = 1e-5, 1e-4, 1e-5, 1e-3
MESH_TIMEOUT_S = 300
NAMES, CTR_NAMES = ranks.NAMES, ranks.CTR_NAMES
MESHES = list(ranks.MESHES)
CASES = [(m, n) for m in MESHES for n in NAMES]
NOISE = "attn/k/b"          # gradient 0 in exact arithmetic (docstring)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("recsys_mesh")
    inp = ranks.inputs()
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"),
         os.environ.get("PYTHONPATH", "")]),
        XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = {m: subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_jax_recsys_mesh_ref.py"),
         str(d / "in.npz"), str(d / f"{m}.npz"), m], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for m in MESHES}
    try:
        out = run_on_mesh(ranks.recsys_mesh_cases, N, ["cpu"] * N, model=2,
                          args=(inp,), timeout=MESH_TIMEOUT_S)
        one = {name: ranks.one_process(inp, name) for name in NAMES}
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


def _close_rel(got, exp, tol, what="", scale=None):
    """Within ``tol`` of ``exp``'s largest magnitude (or of ``scale``)."""
    exp = np.asarray(exp, np.float64)
    _close(got, exp, tol * (np.abs(exp).max() if scale is None else scale),
           what)


def _change_err(got, exp, before) -> float:
    """How far ``got`` lies from ``exp``, over the norm of ``exp``'s
    change from ``before`` (which must have changed)."""
    got, exp, before = (np.asarray(a, np.float64) for a in (got, exp, before))
    assert got.shape == exp.shape
    change = np.linalg.norm(exp - before)
    assert change > 0
    return float(np.linalg.norm(got - exp) / change)


def _same_ids(vals, ids, e_vals, e_ids, tol, what=""):
    """Scores within ``tol`` of the largest; ids equal where the scores
    are apart, and as sets over each run of scores tied within ``tol``
    (either side may order a tie its own way)."""
    vals, e_vals = np.asarray(vals, np.float64), np.asarray(e_vals, np.float64)
    ids, e_ids = np.asarray(ids), np.asarray(e_ids)
    assert ids.shape == e_ids.shape, what
    limit = tol * np.abs(e_vals).max()
    _close(vals, e_vals, limit, what)
    for r in range(e_ids.shape[0]):
        start = 0
        for c in range(1, e_ids.shape[1] + 1):
            if c == e_ids.shape[1] or e_vals[r, c - 1] - e_vals[r, c] > limit:
                assert set(ids[r, start:c]) == set(e_ids[r, start:c]), \
                    (what, r, start, c)
                start = c


def _block(arr, res, mname, axis=0):
    """The block over ``data`` along ``axis`` of a whole array that the
    rank whose results on mesh ``mname`` are ``res`` holds."""
    D, i = ranks.MESHES[mname][0], res["index"]["data"]
    n = arr.shape[axis] // D
    return np.take(arr, range(i * n, (i + 1) * n), axis=axis)


def _jax_tree(jx, prefix) -> dict:
    """{port path: array} of a JAX tree saved under ``prefix``."""
    return {k[len(prefix):]: v for k, v in jx.items() if k.startswith(prefix)}


def _hold_tree(got, exp, tol, what):
    """Every leaf within ``tol`` of its largest; the key biases of the
    largest leaf's (module docstring)."""
    assert set(got) == set(exp), what
    top = max(np.abs(a).max() for a in exp.values())
    for path in exp:
        _close_rel(got[path], exp[path], tol, f"{what} {path}",
                   scale=top if NOISE in path else None)


def _before(inp, name) -> dict:
    return ranks.flat(ranks.bridged(inp, name))


# ---------------------------------------------------------------- placement

@pytest.mark.parametrize("mname,name", CASES)
def test_place_params_round_trips_bit_for_bit(mesh_run, mname, name):
    """Every rank's blocks gathered back equal the bridged JAX tree bit
    for bit; the tables are cut by rows over ``model`` (a block of V/M
    rows), every other leaf whole."""
    M = ranks.MESHES[mname][1]
    whole = {p: tuple(t.shape) for p, t in leaves(ranks.bridged(
        mesh_run["inp"], name))}
    tables = {"tables/fused", "wide/fused", "item_emb/table"}
    for r in mesh_run["out"]:
        res = r[mname][name]
        assert res["round_trip"]
        assert set(res["block_shapes"]) == set(whole)
        for path, shape in res["block_shapes"].items():
            rows = whole[path][0] // M if path in tables else whole[path][0]
            assert shape == (rows,) + whole[path][1:], (path, shape)


# ------------------------------------------------------- against JAX's mesh

@pytest.mark.parametrize("mname,name", CASES)
def test_serve_matches_jax_mesh(mesh_run, mname, name):
    """Each rank's batch block of the serve cell: the CTR logits within
    1e-5 of the largest of JAX's mesh run; BERT4Rec's ``serve_sharded``
    top-100 (one chunk, and ROW_CHUNK users a chunk) ids equal to JAX's
    ``serve_sharded`` and scores within 1e-5 of the largest. The CTR
    lookups go through ``ops.embedding_bag`` (its plain version on the
    CPU): one bag a forward, Wide&Deep's two; BERT4Rec none."""
    jx, tag = mesh_run["jax"], f"{mname}/{name}"
    bags = {"wide-deep": 2, "dlrm-rm2": 1, "dcn-v2": 1, "bert4rec": 0}
    for r in mesh_run["out"]:
        res = r[mname][name]
        assert res["serve_bags"] == bags[name]
        if name != "bert4rec":
            exp = _block(jx[f"{tag}/logits"], r[mname], mname)
            _close_rel(res["logits"], exp, TOL_FWD, tag)
            continue
        for kind in ("serve", "chunked"):
            _same_ids(res[f"{kind}_vals"], res[f"{kind}_ids"],
                      _block(jx[f"{tag}/{kind}_vals"], r[mname], mname),
                      _block(jx[f"{tag}/{kind}_ids"], r[mname], mname),
                      TOL_FWD, f"{tag} {kind}")


@pytest.mark.parametrize("mname,name", CASES)
def test_grads_match_jax_mesh(mesh_run, mname, name):
    """The loss's gradient, summed over ``data`` as the train step sums it
    and gathered whole, within 1e-4 of JAX's on every leaf (of its
    largest), on every rank."""
    exp = _jax_tree(mesh_run["jax"], f"{mname}/{name}/grad/")
    for r in mesh_run["out"]:
        _hold_tree(r[mname][name]["grad"], exp, TOL_GRAD,
                   f"{mname} {name} grad")


@pytest.mark.parametrize("mname,name", CASES)
def test_train_steps_match_jax_mesh(mesh_run, mname, name):
    """2 steps of the registry's train cell (``RS_OPT``): losses and
    global grad norms within 1e-4 of JAX's mesh run, the same on every
    rank; every parameter and both moments, gathered, within 1e-4 of the
    leaf's largest, and each leaf's change within TOL_CHANGE of its
    norm."""
    jx, tag = mesh_run["jax"], f"{mname}/{name}"
    exp = {k: _jax_tree(jx, f"{tag}/{k}/") for k in ("params", "m", "v")}
    before = _before(mesh_run["inp"], name)
    first = mesh_run["out"][0][mname][name]
    for r in mesh_run["out"]:
        res = r[mname][name]
        for k in ("losses", "grad_norms"):
            _close(res[k], jx[f"{tag}/{k}"], TOL_GRAD, f"{tag} {k}")
            assert res[k] == first[k], (tag, k)
        for k in ("m", "v"):
            _hold_tree(res[k], exp[k], TOL_GRAD, f"{tag} {k}")
        for path in exp["params"]:
            if NOISE in path:
                continue
            _close_rel(res["params"][path], exp["params"][path], TOL_GRAD,
                       f"{tag} params {path}")
            err = _change_err(res["params"][path], exp["params"][path],
                              before[path])
            assert err <= TOL_CHANGE, (tag, path, err)


@pytest.mark.parametrize("mname,name", CASES)
def test_retrieval_two_stage_matches_jax_mesh(mesh_run, mname, name):
    """``retrieval_cand``'s cell on one query against N_CAND candidates cut
    over the data axes: each data rank's own top-100, the winners
    gathered over ``data`` and the top-100 taken again; ids equal to
    JAX's mesh run and to one process, scores within 1e-5 of the
    largest, on every rank."""
    jx, tag = mesh_run["jax"], f"{mname}/{name}"
    one = mesh_run["one"][name]
    for r in mesh_run["out"]:
        res = r[mname][name]
        _same_ids(res["retr_vals"], res["retr_ids"], jx[f"{tag}/retr_vals"],
                  jx[f"{tag}/retr_ids"], TOL_FWD, f"{tag} retrieval")
        _same_ids(res["retr_vals"], res["retr_ids"], one["retr_vals"],
                  one["retr_ids"], TOL_ONE, f"{tag} retrieval, one process")


# ---------------------------------------------------- against one process

@pytest.mark.parametrize("mname,name", CASES)
def test_mesh_matches_one_process(mesh_run, mname, name):
    """The same functions in one process (the port's, on the bridged
    state): serve (BERT4Rec's ``serve_sharded`` against one process's
    ``serve``, ids equal), the gradient, the 2 steps' losses, parameters
    and moments within 1e-5 (of each leaf's largest)."""
    one = mesh_run["one"][name]
    for r in mesh_run["out"]:
        res = r[mname][name]
        if name == "bert4rec":
            for kind in ("serve", "chunked"):
                _same_ids(res[f"{kind}_vals"], res[f"{kind}_ids"],
                          _block(one["serve_vals"], r[mname], mname),
                          _block(one["serve_ids"], r[mname], mname),
                          TOL_ONE, f"{mname} {kind} vs serve")
        else:
            _close_rel(res["logits"], _block(one["logits"], r[mname],
                                             mname), TOL_ONE, "logits")
        _close(res["losses"], one["losses"], TOL_ONE, "losses")
        _hold_tree(res["grad"], one["grad"], TOL_ONE, f"{mname} grad")
        for k in ("m", "v"):
            _hold_tree(res[k], one[k], TOL_ONE, f"{mname} {k}")
        for path, p in one["params"].items():
            if NOISE not in path:
                _close_rel(res["params"][path], p, TOL_ONE, path)


@pytest.mark.parametrize("mname", MESHES)
def test_out_of_range_and_negative_indices_on_the_mesh(mesh_run, mname):
    """An index past the whole table makes its bag NaN on the mesh as on
    one process (the kernel's and the plain version's rule: a rank
    neither masks it nor reads a row for it); -1 reads the table's last
    row, which the last model rank holds: the logits within 1e-5 of one
    process's, NaN where it has NaN."""
    for name in CTR_NAMES:
        one = mesh_run["one"][name]["edge_logits"]
        assert np.isnan(one[0]) and np.isfinite(one[1:]).all()
        for r in mesh_run["out"]:
            got = r[mname][name]["edge_logits"]
            exp = _block(one, r[mname], mname)
            np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
            fin = np.isfinite(exp)
            _close_rel(got[fin], exp[fin], TOL_ONE, f"{mname} {name}")


@pytest.mark.parametrize("mname", MESHES)
def test_accumulated_steps_on_the_mesh_match_one_process(mesh_run, mname):
    """BERT4Rec's step over ACCUM microbatches (``B4R_ONE_CARD_ACCUM``'s
    path, ``accum_steps`` on ``RS_OPT``) on the mesh: the loss and every
    parameter within 1e-5 of the port's one-process accumulated step."""
    one = mesh_run["one"]["bert4rec"]
    for r in mesh_run["out"]:
        res = r[mname]["bert4rec"]
        _close(res["accum_loss"], one["accum_loss"], TOL_ONE, "loss")
        for path, p in one["accum_params"].items():
            if NOISE not in path:
                _close_rel(res["accum_params"][path], p, TOL_ONE, path)


# ------------------------------------------------------------- controls

@pytest.mark.parametrize("name", ranks.NO_SYNC)
def test_train_check_fails_without_sync_grads(mesh_run, name):
    """The change check of ``test_train_steps_match_jax_mesh`` fails, on
    every rank of (2, 2), the state left unchanged (every leaf), and the
    same 2 steps run without ``sync_grads`` (every leaf of the family is
    whole over ``data``: each data rank then steps on its own block's
    part of the gradient): the tables and every other leaf but at most
    one miss it (0.28 to 1.46 of the change's norm). Adam's first step is
    lr times the gradient's sign, so a leaf whose gradient has one sign
    in both data blocks takes the same step: DLRM-RM2's output bias
    (1.4e-4)."""
    tag = f"2x2/{name}"
    exp = _jax_tree(mesh_run["jax"], f"{tag}/params/")
    before = _before(mesh_run["inp"], name)
    held = [p for p in exp if NOISE not in p]
    for r in mesh_run["out"]:
        res = r["2x2"][name]
        assert set(res["whole_over_data"]) == set(exp)
        passed = []
        for path in held:
            assert _change_err(before[path], exp[path],
                               before[path]) > TOL_CHANGE, path
            if _change_err(res["no_sync_params"][path], exp[path],
                           before[path]) <= TOL_CHANGE:
                passed.append(path)
        assert len(passed) <= 1, passed
        assert not any(p.endswith(("fused", "table")) for p in passed)


@pytest.mark.parametrize("mname", MESHES)
def test_b4r_grads_fail_without_copy_to(mesh_run, mname):
    """Without ``copy_to`` before BERT4Rec's partial scores each model
    rank's encoder gets only its own rows' part of the gradient: the
    encoder's and the position table's gradients miss the 1e-4 limit."""
    exp = _jax_tree(mesh_run["jax"], f"{mname}/bert4rec/grad/")
    for r in mesh_run["out"]:
        got = r[mname]["bert4rec"]["no_copy_to_grad"]
        bad = [p for p in exp if NOISE not in p and np.abs(
            got[p] - exp[p]).max() > TOL_GRAD * np.abs(exp[p]).max()]
        assert "pos_emb/table" in bad and any(p.startswith("blocks/")
                                              for p in bad), bad


@pytest.mark.parametrize("mname,name", [(m, n) for m in MESHES
                                        for n in CTR_NAMES])
def test_foreign_slots_must_weigh_zero(mesh_run, mname, name):
    """With the slots another model rank holds keeping their weights, each
    rank's bag adds rows it does not own (read at ``index % (V/M)``): the
    logits miss JAX's by far more than the 1e-5 limit."""
    jx = mesh_run["jax"][f"{mname}/{name}/logits"]
    for r in mesh_run["out"]:
        got = r[mname][name]["weighted_foreign_logits"]
        exp = _block(jx, r[mname], mname)
        assert np.abs(got - exp).max() > 100 * TOL_FWD * np.abs(exp).max()


# ---------------------------------------------------------- without ranks

def _specs(tree, prefix="") -> dict:
    """{path: spec as a tuple} of a tree of specs (PartitionSpec or Spec
    leaves, lists as their indices), an entry of one axis as its name."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    else:
        return {prefix: tuple(e[0] if isinstance(e, tuple) and len(e) == 1
                              else e for e in tree)}
    out = {}
    for k, v in items:
        out.update(_specs(v, f"{prefix}{k}/"))
    return out


class _JMesh:
    """A mesh of shapes only, as the JAX rules read it."""

    def __init__(self, n, model):
        self.axis_names = ("data", "model")
        self.shape = {"data": n // model, "model": model}


@pytest.mark.parametrize("n,model", [(2, 2), (4, 2), (4, 1)])
def test_recsys_batch_specs_match_jax(n, model):
    """``recsys_batch_specs``: every key over the data axes, the JAX
    package's table."""
    from repro.distributed import sharding as jshx
    from repro_torch.distributed import sharding as shx
    keys = ("sparse_idx", "sparse_w", "dense", "label")
    got = shx.recsys_batch_specs(make_mesh_for(n, model=model), keys)
    assert _specs(got) == _specs(jshx.recsys_batch_specs(_JMesh(n, model),
                                                         keys))


@pytest.mark.parametrize("name", NAMES)
def test_param_specs_match_jax(name):
    """Every leaf's spec is the JAX package's ``recsys_rules`` after its
    ``guard_divisible``, on the port's tree; ``init_placed`` is
    ``place_params`` of the whole init, bit for bit, and the moments
    follow their parameters."""
    from repro.distributed import sharding as jshx
    cfg = ranks.mesh_config(name)
    whole = rf._init(cfg)(torch.Generator().manual_seed(5), cfg)
    mesh = make_mesh_for(4, model=2)
    exp = jshx.guard_divisible(jshx.spec_tree(whole, jshx.recsys_rules()),
                               whole, _JMesh(4, 2))
    assert _specs(rp.param_specs(whole, mesh)) == _specs(exp)
    for r in range(4):
        m = Mesh(("data", "model"), {"data": 2, "model": 2}, rank=r)
        a = rf.init_placed(torch.Generator().manual_seed(5), cfg, m)
        b = rf.place_params(whole, m)
        for (pa, ta), (pb, tb) in zip(leaves(a), leaves(b)):
            assert pa == pb and torch.equal(ta, tb), (r, pa)
        opt = rf.place_opt(optim.adam_init(whole), m)
        for k in ("m", "v"):
            assert [t.shape for _, t in leaves(opt[k])] == \
                [t.shape for _, t in leaves(b)]


def test_a_table_the_model_axis_does_not_divide_raises():
    """A rank holds whole rows: model=3 does not divide the 4,096-row
    tables, and placement raises with the reason."""
    cfg = ranks.mesh_config("dlrm-rm2")
    whole = ctr.init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="tables/fused.*whole rows"):
        rp.param_specs(whole, make_mesh_for(3, model=3))


@pytest.mark.parametrize("name", NAMES)
def test_registry_cells_give_the_mesh_step(name):
    """Every recsys cell's ``make_fn(device="cpu", mesh=)`` gives a step,
    and ``abstract_args(mesh=)`` a (2, 2) rank's meta blocks: the tables
    half their rows, the towers whole, the batch (and retrieval's
    candidates) half theirs, the retrieval query whole."""
    from repro_torch import configs
    arch = configs.get_arch(name)
    mesh = make_mesh_for(4, model=2)
    for cell in arch.cells.values():
        assert callable(cell.make_fn(device="cpu", mesh=mesh)), cell.key
        whole, blocks = cell.abstract_args(), cell.abstract_args(mesh=mesh)
        specs = rp.param_specs(whole[0], mesh)
        exp = shard_abstract(whole[0], specs, mesh)
        assert [t.shape for _, t in leaves(blocks[0])] == \
            [t.shape for _, t in leaves(exp)]
        assert all(t.device.type == "meta" for _, t in leaves(blocks))
        table = "item_emb/table" if name == "bert4rec" else "tables/fused"
        got = dict(leaves(blocks[0]))[table]
        assert got.shape[0] * 2 == dict(leaves(whole[0]))[table].shape[0]
        if cell.kind == "train":
            assert [t.shape for _, t in leaves(blocks[1]["m"])] == \
                [t.shape for _, t in leaves(exp)]
        if cell.kind == "retrieval":
            assert [t.shape for _, t in leaves(blocks[1])] == \
                [t.shape for _, t in leaves(whole[1])]
            assert blocks[2].shape[0] * 2 == whole[2].shape[0]
        else:
            batch = blocks[-1]
            for k, t in batch.items():
                assert t.shape[0] * 2 == whole[-1][k].shape[0], k
