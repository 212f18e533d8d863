"""The port's partition rules, elastic mesh planning and int8 reduction
against the JAX package's (``tests/test_distributed.py``'s contracts).

The rule machinery runs on fake meshes (``axis_names`` and ``shape`` are
all the spec helpers read); every rule table is applied to each family's
parameter tree, JAX's ``eval_shape`` tree and the port's init (its
``layers`` lists stacked as the JAX layout, ``bridge.stack_layers``),
and the two spec trees must agree leaf for leaf. ``compressed_all_reduce``
runs in 4 gloo ranks on the CPU against numpy.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

torch = pytest.importorskip("torch")

import _torch_mesh_ranks as ranks  # noqa: E402
from repro import core as jcore, optim as joptim  # noqa: E402
from repro import training as jtraining  # noqa: E402
from repro.configs import gnn_family as jgnn  # noqa: E402
from repro.configs import lm_family as jlm_family  # noqa: E402
from repro.configs import recsys_family as jrecsys  # noqa: E402
from repro.distributed import plan_elastic_mesh as jplan  # noqa: E402
from repro.distributed import sharding as jshx  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.gnn import dimenet as jdimenet  # noqa: E402
from repro.models.recsys import bert4rec as jb4r  # noqa: E402
from repro.models.recsys import common as jcommon  # noqa: E402
from repro.models.recsys import ctr as jctr  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch import core, distributed, training  # noqa: E402
from repro_torch.bridge import stack_layers  # noqa: E402
from repro_torch.configs import lm_family, recsys_family  # noqa: E402
from repro_torch.distributed import sharding as shx  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.mesh import run_on_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.gnn import dimenet  # noqa: E402
from repro_torch.models.recsys import bert4rec, ctr  # noqa: E402
from repro_torch.optim import adam  # noqa: E402


def _fake(**axes):
    return SimpleNamespace(axis_names=tuple(axes), shape=dict(axes))


def _sds(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def _meta(*shape):
    return torch.empty(shape, device="meta")


def _n(spec):
    """A spec as a tuple, a one-name tuple entry as the name (JAX's
    ``PartitionSpec`` stores ``("data",)`` as ``"data"``)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


MESHES = [_fake(data=4, model=2), _fake(pod=2, data=4, model=2),
          _fake(model=2), _fake(data=4), _fake(data=3)]


# ---------------------------------------------------------------- helpers

@pytest.mark.parametrize("rules", [
    [(r"q/w$", (None, "model")), (r"w$", ("model", None))],
    [(r"w$", ("model", None)), (r"q/w$", (None, "model"))],
    [(r"nomatch", ("model",))]], ids=["q-first", "w-first", "default"])
def test_spec_tree_first_match_and_default_match_jax(rules):
    tree_j = {"attn": {"q": {"w": _sds(4, 8)}, "b": _sds(8)}}
    tree_t = {"attn": {"q": {"w": _meta(4, 8)}, "b": _meta(8)}}
    exp = jshx.spec_tree(tree_j, [(r, P(*s)) for r, s in rules])
    got = shx.spec_tree(tree_t, [(r, shx.Spec(*s)) for r, s in rules])
    assert _n(got["attn"]["q"]["w"]) == _n(exp["attn"]["q"]["w"])
    assert _n(got["attn"]["b"]) == _n(exp["attn"]["b"])


@pytest.mark.parametrize("spec,shape", [
    (("model", None), (3, 4, 8)), (("model", None), (4, 8)),
    (("model", None), (8,)), (("model",), ()), ((), (2, 3)),
    (("data", "model"), (5, 6, 7, 8))])
def test_fit_is_right_anchored_as_jax(spec, shape):
    assert _n(shx._fit(shx.Spec(*spec), _meta(*shape))) == \
        _n(jshx._fit(P(*spec), _sds(*shape)))


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_data_spec_and_guard_divisible_match_jax(mesh):
    assert _n(shx.data_spec(mesh)) == _n(jshx.data_spec(mesh))
    assert _n(shx.data_spec(mesh, None)) == _n(jshx.data_spec(mesh, None))
    cases = {"a": (("data", None), (8, 3)), "b": (("data",), (6,)),
             "c": ((("data", "model"),), (16,)), "d": (("data",), (4, 5)),
             "e": (("model", "data"), (6, 8)), "f": ((), (3,))}
    names = set(mesh.axis_names)
    cases = {k: v for k, v in cases.items()    # axes this mesh has
             if all(a is None or set((a,) if isinstance(a, str) else a)
                    <= names for a in v[0])}
    exp = jshx.guard_divisible({k: P(*s) for k, (s, _) in cases.items()},
                               {k: _sds(*sh) for k, (_, sh) in cases.items()},
                               mesh)
    got = shx.guard_divisible(
        {k: shx.Spec(*s) for k, (s, _) in cases.items()},
        {k: _meta(*sh) for k, (_, sh) in cases.items()}, mesh)
    assert {k: _n(v) for k, v in got.items()} == \
        {k: _n(v) for k, v in exp.items()}


@pytest.mark.parametrize("mesh", MESHES[:2] + MESHES[3:], ids=str)
def test_batch_specs_match_jax(mesh):
    shapes = {"news_tokens": (256, 3, 16), "news_ids": (301,),
              "hist_inv": (16, 30), "hist_mask": (16, 30),
              "odd": (6, 2), "scalar": ()}
    bj = {k: _sds(*s) for k, s in shapes.items()}
    bt = {k: _meta(*s) for k, s in shapes.items()}
    for jf, tf in ((jshx.batch_specs, shx.batch_specs),
                   (jshx.speedyfeed_batch_specs,
                    shx.speedyfeed_batch_specs)):
        exp, got = jf(mesh, bj), tf(mesh, bt)
        assert {k: _n(v) for k, v in got.items()} == \
            {k: _n(v) for k, v in exp.items()}, jf.__name__


def test_speedyfeed_batch_specs_replicate_the_news_side():
    specs = shx.speedyfeed_batch_specs(_fake(data=4), {
        "news_tokens": _meta(256, 3, 16), "news_ids": _meta(301),
        "hist_inv": _meta(16, 30), "hist_mask": _meta(16, 30)})
    assert specs["news_tokens"] == (None, None, None)
    assert specs["hist_inv"] == (("data",), None)


def test_shard_block_cuts_this_ranks_rows():
    x = torch.arange(24).reshape(8, 3)
    for rank in range(4):
        mesh = SimpleNamespace(axis_names=("data", "model"),
                               shape={"data": 4, "model": 1}, rank=rank)
        got = shx.shard_block(x, shx.Spec(("data", "model"), None), mesh)
        assert torch.equal(got, x[2 * rank:2 * rank + 2])
        assert shx.shard_block(x, shx.Spec(), mesh) is x
        assert shx.global_shape((2, 3), shx.Spec("data"), mesh) == (8, 3)
    shx.set_activation_specs({"residual": shx.Spec("data")})
    y = torch.ones(2)
    assert shx.constrain(y, "residual") is y
    shx.set_activation_specs({})


# ------------------------------------------------------------ rule tables

def _jax_reduced_ctr(name):
    cfg = getattr(jrecsys, name)
    return dataclasses.replace(
        cfg, sparse=jcommon.SparseSpec(
            n_fields=cfg.sparse.n_fields,
            vocab_sizes=tuple([97] * cfg.sparse.n_fields),
            embed_dim=8, nnz=cfg.sparse.nnz),
        mlp_dims=(32, 16) if cfg.mlp_dims else (),
        bot_mlp=(16, 8) if cfg.bot_mlp else (),
        top_mlp=(16, 8, 1) if cfg.top_mlp else ())


def _dimenet_cfgs():
    jcfg = dataclasses.replace(jgnn.DIMENET, n_blocks=2, d_hidden=32,
                               n_bilinear=4, n_spherical=3, n_radial=3)
    return jcfg, dimenet.DimeNetConfig(**dataclasses.asdict(jcfg))


def _family_trees(name):
    """(JAX eval_shape tree, the port's init) of a family member."""
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    if name in ("qwen3-14b", "dbrx-132b"):
        jc = jlm_family.reduced_lm(getattr(jlm_family, name.upper()
                                           .replace("-", "_")))
        tc = lm_family.reduced_lm(getattr(lm_family, name.upper()
                                          .replace("-", "_")))
        return (jax.eval_shape(lambda: jlm.init(key, jc)), lm.init(gen, tc))
    if name in ("DLRM_RM2", "WIDE_DEEP", "DCN_V2"):
        jc = _jax_reduced_ctr(name)
        tc = recsys_family.reduced_ctr(getattr(recsys_family, name))
        return (jax.eval_shape(lambda: jctr.init(key, jc)), ctr.init(gen, tc))
    if name == "bert4rec":
        jc = dataclasses.replace(jrecsys.BERT4REC, n_items=500, embed_dim=16,
                                 seq_len=24, d_ff=32, n_mask=4, n_neg=8)
        tc = recsys_family.reduced_b4r(recsys_family.BERT4REC)
        return (jax.eval_shape(lambda: jb4r.init(key, jc)),
                bert4rec.init(gen, tc))
    if name == "dimenet":
        jc, tc = _dimenet_cfgs()
        return (jax.eval_shape(lambda: jdimenet.init(key, jc)),
                dimenet.init(gen, tc))
    jc = jtrain.small_speedyfeed_config()
    tc = train.small_speedyfeed_config()
    return (jax.eval_shape(lambda: jcore.init_speedyfeed(key, jc)),
            core.init_speedyfeed(gen, tc))


def _flat_jax(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): _n(s) for path, s in flat}


def _flat_port(specs, prefix=""):
    if isinstance(specs, dict):
        return {k2: v for k, sub in specs.items()
                for k2, v in _flat_port(sub, f"{prefix}{k}/").items()}
    if isinstance(specs, list):
        return {k2: v for i, sub in enumerate(specs)
                for k2, v in _flat_port(sub, f"{prefix}{i}/").items()}
    return {prefix[:-1]: _n(specs)}


TABLES = {"lm": lambda m: m.lm_rules(), "lm_fsdp": lambda m: m.lm_rules(True),
          "recsys": lambda m: m.recsys_rules(),
          "gnn": lambda m: m.gnn_rules(),
          "speedyfeed": lambda m: m.speedyfeed_rules(),
          "speedyfeed_tp": lambda m: m.speedyfeed_rules(tp=True)}
MEMBERS = ["qwen3-14b", "dbrx-132b", "DLRM_RM2", "WIDE_DEEP", "DCN_V2",
           "bert4rec", "dimenet", "speedyfeed"]


@pytest.mark.parametrize("member", MEMBERS)
def test_every_rule_table_matches_jax_on_every_family(member):
    """Every table on every member's tree: the same spec at every leaf
    (and the same leaves), the stacked layers right-anchored."""
    jtree, ttree = _family_trees(member)
    ttree = stack_layers(ttree)
    for name, table in TABLES.items():
        exp = _flat_jax(jshx.spec_tree(jtree, jax_rules(table)))
        got = _flat_port(shx.spec_tree(ttree, table(shx)))
        assert got == exp, (member, name)
    if member == "dbrx-132b":
        spec = _flat_port(shx.spec_tree(ttree, shx.lm_rules(True)))
        assert spec["layers/moe/w1"][:2] == (None, "model")


def jax_rules(table):
    return table(jshx)


def test_state_specs_match_jax():
    """The SpeedyFeed TrainState on a 4-way data mesh: params and moments
    replicated, the cache rows over data (replicated where 4 does not
    divide them), step and generator replicated."""
    mesh = _fake(data=4, model=1)
    for n_news in (2004, 2001):
        jc = jtrain.small_speedyfeed_config(n_news=n_news)
        tc = train.small_speedyfeed_config(n_news=n_news)
        def jstate():
            p, c = jcore.speedyfeed_state(jc, jax.random.PRNGKey(0))
            return jtraining.make_state(p, joptim.adam_init(p), c)

        jspecs = jtraining.state_specs(jax.eval_shape(jstate), mesh)
        gen = torch.Generator().manual_seed(0)
        params, cache = core.speedyfeed_state(tc, gen)
        tspecs = training.state_specs(training.make_state(
            params, adam.adam_init(params), cache, rng=gen), mesh)
        for field in ("emb", "written_step"):
            assert _n(getattr(tspecs.cache, field)) == \
                _n(getattr(jspecs.cache, field)), (n_news, field)
        assert _n(tspecs.step) == _n(jspecs.step) == ()
        specs = [s for tree in (tspecs.params, tspecs.opt)
                 for s in _flat_port(tree).values()]
        specs += [tuple(s) for s in jax.tree.leaves(
            jspecs.params, is_leaf=lambda x: isinstance(x, P))]
        assert all(a is None for s in specs for a in s)


def test_plan_elastic_mesh_matches_jax():
    for n in (0, 1, 8, 15, 16, 33, 496, 512):
        for model, min_data in ((16, 1), (8, 2), (1, 1)):
            assert distributed.plan_elastic_mesh(
                n, model=model, min_data=min_data) == \
                jplan(n, model=model, min_data=min_data)
    assert distributed.plan_elastic_mesh(512, model=16) == (32, 16)
    assert distributed.plan_elastic_mesh(15, model=16) is None


# ------------------------------------------------------------- int8

@pytest.mark.parametrize("seed", range(6))
def test_int8_quantization_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(257,)) * 10.0 ** rng.integers(-3, 3)).astype(
        np.float32)
    if seed == 0:
        x[:] = 0.0                                 # the 1e-12 floor
    qj, sj = jadam.quantize_int8(jnp.asarray(x))
    qt, st = adam.quantize_int8(torch.from_numpy(x))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert float(st) == float(sj)
    np.testing.assert_array_equal(
        adam.dequantize_int8(qt, st).numpy(),
        np.asarray(jadam.dequantize_int8(qj, sj)))
    err = np.abs(adam.dequantize_int8(qt, st).numpy() - x)
    assert err.max() <= float(st) / 2 + 1e-6


def test_error_feedback_converges():
    """With error feedback the accumulated compressed sum tracks the true
    sum (``tests/test_distributed.py``'s property on the port)."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(128,)).astype(np.float32) * 0.01)
    residual = torch.zeros_like(g)
    acc_c, acc_t = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(200):
        q, s = adam.quantize_int8(g + residual)
        deq = adam.dequantize_int8(q, s)
        residual = (g + residual) - deq
        acc_c += deq
        acc_t += g
    assert float((acc_c - acc_t).abs().max() / acc_t.abs().max()) < 0.01


def _numpy_compressed(grads_by_rank):
    """JAX's ``compressed_psum`` formula in numpy, from zero residuals."""
    n = len(grads_by_rank)
    out = {}
    for k in grads_by_rank[0]:
        qs, scales = [], []
        for g in grads_by_rank:
            x = g[k].astype(np.float32)
            s = np.float32(max(np.abs(x).max(), np.float32(1e-12))) \
                / np.float32(127.0)
            qs.append(np.clip(np.round(x / s), -127, 127).astype(np.int32))
            scales.append(s)
        ss = np.float32(max(scales))
        out[k] = (np.sum(qs, axis=0).astype(np.float32) * ss
                  / np.float32(n)), ss
    return out


def test_compressed_all_reduce_in_four_ranks_matches_numpy():
    """One int32 sum and one max of the scales across 4 gloo ranks: the
    result within one quantisation step of numpy's evaluation of JAX's
    formula, the same on every rank; each rank's residual is what its own
    int8 codes lost."""
    rng = np.random.default_rng(3)
    grads = [{"w": (rng.normal(size=(33, 7)) * (r + 1)).astype(np.float32),
              "b": (rng.normal(size=(5,)) * 1e-3).astype(np.float32)}
             for r in range(4)]
    out = run_on_mesh(ranks.int8_reduce, 4, ["cpu"] * 4, args=(grads,),
                      timeout=120)
    exp = _numpy_compressed(grads)
    for r, got in enumerate(out):
        for k, (want, ss) in exp.items():
            assert got["once"][k].shape == want.shape
            assert np.abs(got["once"][k] - want).max() <= ss, k
            np.testing.assert_array_equal(got["once"][k], out[0]["once"][k])
            x = grads[r][k]
            s = np.float32(np.abs(x).max()) / np.float32(127.0)
            lost = x - np.clip(np.round(x / s), -127, 127) * s
            assert np.abs(got["residual"][k] - lost).max() <= s, k
