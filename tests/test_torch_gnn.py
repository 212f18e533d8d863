"""The port's GNN family (``data/graph.py``, ``models/gnn/dimenet.py``,
``configs/gnn_family.py``) against the JAX package on the CPU.

The graph builders draw the JAX package's numpy ``Generator`` calls in
its order, so one seed gives bit-identical arrays (``build_triplets``,
vectorised in the port, included). The bases are held within 1e-6 of
each one's largest magnitude; DimeNet's forward and loss, from a JAX
init carried over with ``bridge``, within 2e-4 of the largest output;
each gradient leaf within 1e-4 of its largest magnitude; two Adam steps
of ``gnn_family.make_fn`` within 1e-4 of JAX's
``optim.make_train_step(..., GNN_OPT)``. All at the JAX smoke's reduced
size (2 blocks, d 32, 4 bilinear, 3 spherical, 3 radial), at graph level
(molecules) and at node level (a padded fanout subgraph: pad edges are
self-loops at node 0, pad triplets (0, 0)).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import gnn_family as jax_family  # noqa: E402
from repro.data import graph as jax_graph  # noqa: E402
from repro.models.gnn import dimenet as jax_dimenet  # noqa: E402
from repro_torch import bridge, optim  # noqa: E402
from repro_torch.configs import gnn_family  # noqa: E402
from repro_torch.data import graph  # noqa: E402
from repro_torch.models.gnn import dimenet  # noqa: E402
from repro_torch.optim.adam import leaves  # noqa: E402

TOL_BASIS = 1e-6        # bases, relative to each one's largest magnitude
TOL_FWD = 2e-4          # forward and loss, relative to the largest output
TOL_GRAD = 1e-4         # each gradient leaf, relative to its largest
TOL_STEP = 1e-4         # losses, parameters and moments after Adam steps
N_STEPS = 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _same(got, exp):
    """Bit-identical arrays of the same dtype."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    exp = np.asarray(exp)
    return got.dtype == exp.dtype and np.array_equal(got, exp)


def _rel(got, exp) -> float:
    exp = np.asarray(exp, np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    return float(np.abs(got - exp).max() / max(np.abs(exp).max(), 1e-30))


# ---------------------------------------------------------------- builders

@pytest.mark.parametrize("t_cap", [64, 4096], ids=["capped", "uncapped"])
def test_build_triplets_matches_jax_bit_for_bit(t_cap):
    """The CSR build against the JAX loop: the same triplets in the same
    order, so the capped case's ``rng.choice`` subsample is the same."""
    src, dst = jax_graph.random_graph(np.random.default_rng(3), 40, 150)
    exp = jax_graph.build_triplets(src, dst, t_cap=t_cap,
                                   rng=np.random.default_rng(5))
    got = graph.build_triplets(src, dst, t_cap=t_cap,
                               rng=np.random.default_rng(5))
    n_real = int(exp[2].sum())
    assert (n_real == t_cap) == (t_cap == 64)
    assert all(_same(g, e) for g, e in zip(got, exp))


def test_random_molecule_batch_matches_jax_bit_for_bit():
    kw = dict(n_graphs=4, nodes_per_graph=8, t_cap=256)
    exp = jax_graph.random_molecule_batch(np.random.default_rng(0), **kw)
    got = graph.random_molecule_batch(np.random.default_rng(0),
                                      device="cpu", **kw)
    assert set(got) == set(exp)
    assert all(_same(got[k], exp[k]) for k in exp), \
        [k for k in exp if not _same(got[k], exp[k])]


def _base_graph(mod):
    rng = np.random.default_rng(7)
    src, dst = mod.random_graph(rng, 300, 2400)
    return mod.CSRGraph(300, src, dst), rng


def test_csr_and_fanout_sample_match_jax_bit_for_bit():
    gj, _ = _base_graph(jax_graph)
    gt, _ = _base_graph(graph)
    assert _same(gt.indptr, gj.indptr) and _same(gt.src_sorted,
                                                 gj.src_sorted)
    seeds = np.arange(0, 300, 19)
    exp = jax_graph.fanout_sample(gj, seeds, (5, 3),
                                  np.random.default_rng(2))
    got = graph.fanout_sample(gt, seeds, (5, 3), np.random.default_rng(2))
    assert all(_same(g, e) for g, e in zip(got, exp))


def _subgraph(mod, device=None):
    """A padded fanout batch of 16 seeds: caps that cut nodes and edges,
    and a triplet cap that subsamples."""
    g, rng = _base_graph(mod)
    feats = rng.normal(size=(300, 16)).astype(np.float32)
    labels = rng.integers(0, 5, 300)
    seeds = rng.choice(300, 16, replace=False)
    kw = dict(n_cap=96, e_cap=160, t_cap=128, rng=rng)
    if device is not None:
        kw["device"] = device
    return mod.padded_subgraph_batch(g, feats, labels, seeds, (5, 3), **kw)


def test_padded_subgraph_batch_matches_jax_bit_for_bit():
    exp = _subgraph(jax_graph)
    got = _subgraph(graph, "cpu")
    assert set(got) == set(exp)
    assert all(_same(got[k], exp[k]) for k in exp), \
        [k for k in exp if not _same(got[k], exp[k])]
    # the caps bite: nodes and edges cut by n_cap (pad edges remain under
    # e_cap) and a subsampled triplet list
    assert not bool(got["edge_mask"].all()) and bool(got["trip_mask"].all())


# ------------------------------------------------------------------- bases

def _geometry_inputs():
    """Distances from 1e-6 (the pad self-loop's) past the cutoff, and
    cosines in [-1, 1]."""
    rng = np.random.default_rng(11)
    d = np.concatenate([[1e-6, 5.0, 7.5], rng.uniform(0.05, 6.0, 61)])
    cos = np.clip(np.concatenate([[-1.0, 1.0, 0.0],
                                  rng.uniform(-1, 1, 61)]), -1, 1)
    return d.astype(np.float32), cos.astype(np.float32)


@pytest.mark.parametrize("basis", ["envelope", "rbf", "legendre", "sbf",
                                   "geometry"])
def test_bases_match_jax(basis):
    cfg = jax_family.DIMENET
    tcfg = gnn_family.DIMENET
    d, cos = _geometry_inputs()
    td, tc = torch.tensor(d), torch.tensor(cos)
    if basis == "envelope":
        got = dimenet.envelope(td, tcfg.cutoff, tcfg.envelope_p)
        exp = jax_dimenet.envelope(jnp.asarray(d), cfg.cutoff,
                                   cfg.envelope_p)
    elif basis == "rbf":
        got, exp = dimenet.rbf_basis(td, tcfg), jax_dimenet.rbf_basis(
            jnp.asarray(d), cfg)
    elif basis == "legendre":
        got = dimenet._legendre(tc, tcfg.n_spherical)
        exp = jax_dimenet._legendre(jnp.asarray(cos), cfg.n_spherical)
    elif basis == "sbf":
        got = dimenet.sbf_basis(td, tc, tcfg)
        exp = jax_dimenet.sbf_basis(jnp.asarray(d), jnp.asarray(cos), cfg)
    else:
        jb = _subgraph(jax_graph)
        tb = _subgraph(graph, "cpu")
        got = torch.cat(dimenet.geometry(tb, tcfg))
        exp = jnp.concatenate(jax_dimenet.geometry(jb, cfg))
    assert tuple(got.shape) == exp.shape
    assert bool(torch.isfinite(got).all())
    assert _rel(got, exp) <= TOL_BASIS


def test_bilinear_is_the_einsum():
    g = torch.Generator().manual_seed(0)
    a, w, m = (torch.randn(s, generator=g, dtype=torch.float64)
               for s in ((50, 12), (12, 16, 4), (50, 16)))
    exp = torch.einsum("ts,sdb,td->tb", a, w, m)
    assert torch.allclose(dimenet.bilinear(a, w, m), exp, rtol=0,
                          atol=1e-12)


# ------------------------------------------------------------------- model

def _small(level):
    cfg = dataclasses.replace(jax_family.DIMENET, n_blocks=2, d_hidden=32,
                              n_bilinear=4, n_spherical=3, n_radial=3)
    if level == "node":
        cfg = dataclasses.replace(cfg, d_feat=16, out_dim=5,
                                  node_level=True)
    return cfg, dimenet.DimeNetConfig(**dataclasses.asdict(cfg))


def _case(level):
    """(JAX cfg, port cfg, JAX params, port params, JAX batch, port batch,
    n_graphs): a JAX init at the reduced size, bridged."""
    jcfg, cfg = _small(level)
    jp = jax.jit(jax_dimenet.init, static_argnums=1)(jax.random.PRNGKey(1),
                                                     jcfg)
    tp = bridge.params_from_jax(_np(jp), "cpu")
    if level == "graph":
        kw = dict(n_graphs=4, nodes_per_graph=8, t_cap=256)
        jb = jax_graph.random_molecule_batch(np.random.default_rng(0), **kw)
        tb = graph.random_molecule_batch(np.random.default_rng(0),
                                         device="cpu", **kw)
        return jcfg, cfg, jp, tp, jb, tb, 4
    return jcfg, cfg, jp, tp, _subgraph(jax_graph), _subgraph(graph,
                                                              "cpu"), 1


@pytest.mark.parametrize("level", ["graph", "node"])
def test_forward_and_loss_match_jax(level):
    jcfg, cfg, jp, tp, jb, tb, ng = _case(level)
    assert set(tp) == set(jp) and len(tp["blocks"]) == jcfg.n_blocks
    assert tuple(tp["blocks"][0]["bilinear"].shape) == (
        jcfg.n_spherical * jcfg.n_radial, jcfg.d_hidden, jcfg.n_bilinear)
    with torch.no_grad():
        y = dimenet.forward(tp, cfg, tb, n_graphs=ng)
        loss, m = dimenet.loss(tp, cfg, tb, n_graphs=ng)
    jy, (jl, jm) = jax.jit(lambda p, b: (
        jax_dimenet.forward(p, jcfg, b, n_graphs=ng),
        jax_dimenet.loss(p, jcfg, b, n_graphs=ng)))(jp, jb)
    assert tuple(y.shape) == jy.shape
    assert bool(torch.isfinite(y).all())
    scale = float(np.abs(np.asarray(jy)).max())
    assert float((y - torch.tensor(np.asarray(jy))).abs().max()) \
        <= TOL_FWD * scale
    assert abs(float(loss) - float(jl)) <= TOL_FWD * max(abs(float(jl)), 1)
    assert set(m) == set(jm)
    for k in m:
        assert abs(float(m[k]) - float(jm[k])) <= TOL_FWD


@pytest.mark.parametrize("level", ["graph", "node"])
def test_gradients_match_jax(level):
    """Every leaf's gradient; at node level the pad edges (self-loops at
    distance 1e-6) and pad triplets send nothing back and nothing NaN."""
    jcfg, cfg, jp, tp, jb, tb, ng = _case(level)
    jg = jax.jit(jax.grad(lambda p, b: jax_dimenet.loss(
        p, jcfg, b, n_graphs=ng)[0]))(jp, jb)
    flat = [p.requires_grad_() for _, p in leaves(tp)]
    loss, _ = dimenet.loss(tp, cfg, tb, n_graphs=ng)
    grads = torch.autograd.grad(loss, flat)
    exp = leaves(bridge.params_from_jax(_np(jg), "cpu"))
    for (path, e), got in zip(exp, grads):
        assert bool(torch.isfinite(got).all()), path
        assert _rel(got, e.numpy()) <= TOL_GRAD, path
    if level == "node":
        assert not bool(tb["edge_mask"].all())


@pytest.mark.parametrize("level", ["graph", "node"])
def test_make_fn_adam_steps_match_jax(level):
    jcfg, cfg, jp, tp, jb, tb, ng = _case(level)
    jstep = jax.jit(joptim.make_train_step(
        lambda p, b: jax_dimenet.loss(p, jcfg, b, n_graphs=ng),
        jax_family.GNN_OPT))
    tstep = gnn_family.make_fn(cfg, "train", n_graphs=ng)
    jo, to = joptim.adam_init(jp), optim.adam_init(tp)
    for i in range(N_STEPS):
        jp, jo, jm = jstep(jp, jo, jb)
        tp, to, tm = tstep(tp, to, tb)
        for key in ("loss", "grad_norm"):
            assert abs(float(tm[key]) - float(jm[key])) <= TOL_STEP * max(
                abs(float(jm[key])), 1), (i, key)
    assert int(to["count"]) == int(jo["count"]) == N_STEPS
    for what, got, exp in (("params", tp, jp), ("m", to["m"], jo["m"]),
                           ("v", to["v"], jo["v"])):
        exp = bridge.params_from_jax(_np(exp), "cpu")
        for (path, a), (_, b) in zip(leaves(got), leaves(exp)):
            assert float((a.detach() - b).abs().max()) <= TOL_STEP, \
                (what, path)


# ----------------------------------------------------------------- configs

def test_shapes_and_configs_are_the_jax_packages():
    assert gnn_family.GNN_SHAPES == jax_family.GNN_SHAPES
    assert dataclasses.asdict(gnn_family.DIMENET) == dataclasses.asdict(
        jax_family.DIMENET)
    assert dataclasses.asdict(gnn_family.GNN_OPT) == dataclasses.asdict(
        jax_family.GNN_OPT)
    for shp in gnn_family.GNN_SHAPES.values():
        assert dataclasses.asdict(gnn_family._cfg_for(shp)) == \
            dataclasses.asdict(jax_family._cfg_for(shp))
        assert gnn_family._gnn_flops(gnn_family._cfg_for(shp), shp) == \
            jax_family._gnn_flops(jax_family._cfg_for(shp), shp)


@pytest.mark.parametrize("shape", ["molecule", "full_graph_sm"])
def test_train_batch_fills_the_cells_caps(shape):
    shp = gnn_family.GNN_SHAPES[shape]
    b = gnn_family.train_batch(shape, np.random.default_rng(0), device="cpu")
    assert b["pos"].shape == (shp["n"], 3)
    for k in ("edge_src", "edge_dst", "edge_mask"):
        assert b[k].shape == (shp["e"],)
    for k in ("trip_kj", "trip_ji", "trip_mask"):
        assert b[k].shape == (shp["t"],)
    # every triplet slot filled (both graphs have more than the cap)
    assert bool(b["trip_mask"].all())
    real = int(b["edge_mask"].sum())
    assert real == shp.get("e_real", shp["e"])
    assert int(b["edge_src"][real:].abs().sum()) == 0   # pad self-loops
    if shape == "full_graph_sm":
        assert b["feat"].shape == (shp["n"], shp["d_feat"])
        assert int(b["label_mask"].sum()) == 20 * shp["n_classes"]
        assert int(b["labels"].max()) < shp["n_classes"]
    else:
        assert b["targets"].shape == (shp["n_graphs"],)
        assert int(b["graph_id"].max()) == shp["n_graphs"] - 1


def test_ogb_products_is_refused_by_name():
    with pytest.raises(ValueError, match="31.7 GB"):
        gnn_family.train_batch("ogb_products", np.random.default_rng(0),
                               device="cpu")
