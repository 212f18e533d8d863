"""The port's recsys training path against the JAX package.

The EmbeddingBag's autograd Function (``ops.embedding_bag``: on the CPU
the plain forward and the plain backward) is held to ``jax.vjp`` of the
JAX package's XLA lookup (``models/recsys/common.py:lookup``): the
table's gradient, with negative and out-of-range indices; weights that
require grad are refused. Whole Adam steps of
``recsys_family.make_fn(cfg, "train", device="cpu")`` from a bridged JAX
``(params, opt)`` pair are held to the JAX package's
``optim.make_train_step`` over ``ctr.loss`` and ``bert4rec.loss`` with
``RS_OPT`` (BERT4Rec also with ``accum_steps=2`` on both sides, through
``optim.make_train_step``), at the JAX smoke sizes. Weights are drawn by the JAX package
and carried over with ``bridge``; batches come from both packages'
``recsys_synth`` with one numpy seed.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import recsys_family as jax_family  # noqa: E402
from repro.data import recsys_synth as jax_synth  # noqa: E402
from repro.models.recsys import bert4rec as jax_b4r  # noqa: E402
from repro.models.recsys import common as jax_common  # noqa: E402
from repro.models.recsys import ctr as jax_ctr  # noqa: E402
from repro_torch import bridge, optim  # noqa: E402
from repro_torch.configs import recsys_family  # noqa: E402
from repro_torch.data import recsys_synth  # noqa: E402
from repro_torch.kernels import embedding_bag as ebag  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.recsys import bert4rec, common, ctr  # noqa: E402
from repro_torch.optim.adam import leaves  # noqa: E402

TOL_VJP = 1e-6          # the EmbeddingBag's gradients against jax.vjp, f32
TOL_TRAIN = 1e-4        # losses and parameters after Adam steps, f32
CTR_NAMES = ["WIDE_DEEP", "DLRM_RM2", "DCN_V2"]
B_CTR, B_B4R, N_STEPS = 32, 8, 5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _err(got, exp) -> float:
    return float(np.abs(got.detach().float().numpy()
                        - np.asarray(exp, np.float32)).max())


def _hold_nan(got, exp, tol):
    """Equal NaN masks, and the finite values within ``tol``."""
    got, exp = got.detach().numpy(), np.asarray(exp)
    assert np.array_equal(np.isnan(got), np.isnan(exp))
    fin = ~np.isnan(exp)
    assert float(np.abs(got[fin] - exp[fin]).max()) <= tol


# ------------------------------------------------- EmbeddingBag backward

def _bad_indices(spec, fused: bool, rng):
    """Local per-field indices [9, F, nnz] with, beside in-range ones, a
    negative index (counting from the end of the table it reads) and an
    index outside [-V, V) of that table."""
    idx = np.stack([rng.integers(0, v, (9, spec.nnz))
                    for v in spec.vocab_sizes], axis=1).astype(np.int32)
    if fused:
        rows = common.padded_rows(spec.total_rows)
        idx[0, 0, 0] = -1                    # the fused table's last row
        idx[1, 0, 1] = -3
        idx[2, -1, 0] = rows                 # past the fused table
        idx[3, 0, 2] = -rows - 1             # before its first row
    else:
        idx[0, 1, 0] = -1                    # field 1's last row
        idx[1, 2, 1] = -spec.vocab_sizes[2]  # field 2's first row
        idx[2, 3, 0] = spec.vocab_sizes[3]   # past field 3's table
        idx[3, 0, 2] = -spec.vocab_sizes[0] - 2
    return idx


@pytest.mark.parametrize("bad", [False, True])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("weighted", [True, False])
def test_embedding_bag_grads_match_jax_vjp(fused, weighted, bad):
    """The table's gradient, the weights held as batch data (the JAX cells
    differentiate the parameters only)."""
    spec_j = jax_common.SparseSpec(n_fields=4, vocab_sizes=(7, 30, 5, 12),
                                   embed_dim=6, nnz=3)
    spec = common.SparseSpec(**dataclasses.asdict(spec_j))
    tables = _np(jax_common.init_tables(jax.random.PRNGKey(4), spec_j,
                                        fused=fused))
    rng = np.random.default_rng(4)
    if bad:
        idx = _bad_indices(spec, fused, rng)
    else:
        idx = np.stack([rng.integers(0, v, (9, spec.nnz))
                        for v in spec.vocab_sizes], axis=1).astype(np.int32)
        idx[:, :, 1] = idx[:, :, 0]          # a row named twice in a bag
    w = rng.uniform(size=idx.shape).astype(np.float32) if weighted else None
    dout = rng.normal(size=(9, 4, 6)).astype(np.float32)

    out_j, vjp = jax.vjp(lambda t: jax_common.lookup(
        t, spec_j, jnp.asarray(idx), None if w is None else jnp.asarray(w)),
        tables)
    (g_tables,) = vjp(jnp.asarray(dout))

    t_tables = bridge.params_from_jax(tables, "cpu")
    flat = [t.requires_grad_() for _, t in leaves(t_tables)]
    out = common.lookup(t_tables, spec, torch.tensor(idx),
                        None if w is None else torch.tensor(w))
    assert out.grad_fn is not None
    _hold_nan(out, out_j, TOL_VJP)
    grads = torch.autograd.grad(out, flat, torch.tensor(dout))
    exp = [g for _, g in leaves(bridge.params_from_jax(_np(g_tables),
                                                       "cpu"))]
    assert len(exp) == len(flat)
    for got, e in zip(grads, exp):
        assert got.shape == e.shape and got.dtype == torch.float32
        assert bool(torch.isfinite(got).all())
        assert float((got - e).abs().max()) <= TOL_VJP


@pytest.mark.parametrize("table_grad", [True, False])
def test_embedding_bag_refuses_weights_that_require_grad(table_grad):
    """One contract on every device: the weights get no gradient, so
    weights that require grad under autograd raise (here on the CPU; the
    card's case is in test_torch_gpu.py); without a graph they are read."""
    table = torch.randn(10, 4, requires_grad=table_grad)
    idx = torch.randint(0, 10, (5, 2, 3), dtype=torch.int32)
    w = torch.rand(5, 2, 3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="weights"):
        ops.embedding_bag(table, idx, w)
    with torch.no_grad():
        out = ops.embedding_bag(table, idx, w)
    assert torch.equal(out, ebag.embedding_bag_plain(table.detach(), idx,
                                                     w.detach()))


def test_embedding_bag_bwd_plain_rounds_once_and_sums_in_f64():
    """The plain backward sums in f32 (f64 for f64 dout) and rounds once:
    bf16 dout gives the f32 sum of its values rounded to bf16, and the
    f64 sum agrees with the f32 one within f32 rounding."""
    rng = np.random.default_rng(1)
    V, d = 11, 4
    idx = torch.tensor(rng.integers(-V, V, (64, 3, 2)), dtype=torch.int32)
    w = torch.tensor(rng.uniform(size=(64, 3, 2)), dtype=torch.float32)
    dout = torch.tensor(rng.normal(size=(64, 3, d)), dtype=torch.float32)
    g32 = ebag.embedding_bag_bwd_plain(dout, idx, w, V)
    g64 = ebag.embedding_bag_bwd_plain(dout.double(), idx, w, V)
    assert g32.dtype == torch.float32 and g64.dtype == torch.float64
    assert float((g32.double() - g64).abs().max()) <= 1e-5
    db = dout.bfloat16()
    gb = ebag.embedding_bag_bwd_plain(db, idx, w, V)
    assert gb.dtype == torch.bfloat16
    assert torch.equal(gb, ebag.embedding_bag_bwd_plain(db.float(), idx, w,
                                                        V).bfloat16())
    # a row no slot names stays 0; every slot out of range adds nothing
    far = torch.full_like(idx, V)
    assert torch.equal(ebag.embedding_bag_bwd_plain(dout, far, w, V),
                       torch.zeros(V, d))


def test_embedding_bag_on_the_cpu_is_the_autograd_function(monkeypatch):
    """``ops.embedding_bag`` goes through ``_EmbeddingBag`` on the CPU too,
    its backward through the plain backward, once a table."""
    calls = []
    real = ebag.embedding_bag_bwd_plain

    def counted(dout, idx, weights, num_rows):
        calls.append(num_rows)
        return real(dout, idx, weights, num_rows)

    monkeypatch.setattr(ebag, "embedding_bag_bwd_plain", counted)
    table = torch.randn(10, 4, requires_grad=True)
    idx = torch.randint(0, 10, (5, 2, 1), dtype=torch.int32)
    out = ops.embedding_bag(table, idx)
    assert type(out.grad_fn).__name__ == "_EmbeddingBagBackward"
    out.sum().backward()
    assert calls == [10]
    exp = torch.zeros(10, 4).index_add_(0, idx.reshape(-1).long(),
                                        torch.ones(10, 4))
    assert torch.equal(table.grad, exp)
    with torch.no_grad():
        assert ops.embedding_bag(table, idx).grad_fn is None


# ------------------------------------------------------------ train steps

def _jax_reduced_ctr(name):
    """The JAX ``_ctr_smoke`` config of ``name``."""
    cfg = getattr(jax_family, name)
    return dataclasses.replace(
        cfg, sparse=jax_common.SparseSpec(
            n_fields=cfg.sparse.n_fields,
            vocab_sizes=tuple([97] * cfg.sparse.n_fields),
            embed_dim=8, nnz=cfg.sparse.nnz),
        mlp_dims=(32, 16) if cfg.mlp_dims else (),
        bot_mlp=(16, 8) if cfg.bot_mlp else (),
        top_mlp=(16, 8, 1) if cfg.top_mlp else ())


def _case(name):
    """(JAX config, port config, JAX init, batch makers for both) at the
    JAX smoke size of ``name``."""
    if name == "BERT4REC":
        jcfg = dataclasses.replace(jax_family.BERT4REC, n_items=500,
                                   embed_dim=16, seq_len=24, d_ff=32,
                                   n_mask=4, n_neg=8)
        cfg = recsys_family.reduced_b4r(recsys_family.BERT4REC)
        kw = dict(batch=B_B4R, seq_len=cfg.seq_len, n_items=cfg.n_items,
                  n_mask=cfg.n_mask, n_neg=cfg.n_neg,
                  mask_token=cfg.mask_token)
        return (jcfg, cfg, jax_b4r, jax_b4r.init,
                lambda rng: jax_synth.bert4rec_batch(rng, **kw),
                lambda rng: recsys_synth.bert4rec_batch(rng, device="cpu",
                                                        **kw))
    jcfg = _jax_reduced_ctr(name)
    cfg = recsys_family.reduced_ctr(getattr(recsys_family, name))
    kw = dict(batch=B_CTR, n_dense=cfg.n_dense,
              vocab_sizes=cfg.sparse.vocab_sizes, nnz=cfg.sparse.nnz)
    return (jcfg, cfg, jax_ctr, jax_ctr.init,
            lambda rng: jax_synth.ctr_batch(rng, **kw),
            lambda rng: recsys_synth.ctr_batch(rng, device="cpu", **kw))


def _run_steps(name, accum_steps=1):
    """One JAX step from a fresh state, the (params, opt) pair bridged,
    then ``N_STEPS`` steps of both packages on the same batches: losses
    each step, and the parameters and moments at the end, within
    TOL_TRAIN."""
    jcfg, cfg, jmod, jinit, jbatch, tbatch = _case(name)
    jopt_cfg = dataclasses.replace(jax_family.RS_OPT,
                                   accum_steps=accum_steps)
    topt_cfg = dataclasses.replace(recsys_family.RS_OPT,
                                   accum_steps=accum_steps)
    jstep = jax.jit(joptim.make_train_step(
        lambda p, b: jmod.loss(p, jcfg, b), jopt_cfg))
    params = jinit(jax.random.PRNGKey(3), jcfg)
    jopt = joptim.adam_init(params)
    params, jopt, _ = jstep(params, jopt, jbatch(np.random.default_rng(99)))
    p_t = bridge.params_from_jax(_np(params), "cpu")
    o_t = bridge.opt_from_jax(_np(jopt), "cpu")
    assert int(o_t["count"]) == 1
    if accum_steps == 1:
        tstep = recsys_family.make_fn(cfg, "train", device="cpu")
    else:
        tmod = bert4rec if name == "BERT4REC" else ctr
        tstep = optim.make_train_step(lambda p, b: tmod.loss(p, cfg, b),
                                      topt_cfg)
    rng_j, rng_t = np.random.default_rng(5), np.random.default_rng(5)
    for i in range(N_STEPS):
        params, jopt, jm = jstep(params, jopt, jbatch(rng_j))
        p_t, o_t, tm = tstep(p_t, o_t, tbatch(rng_t))
        for key in ("loss", "grad_norm"):
            assert _err(torch.as_tensor(tm[key]), jm[key]) <= TOL_TRAIN, \
                (i, key)
    assert int(o_t["count"]) == int(jopt["count"]) == 1 + N_STEPS
    moved = 0
    trees = {"params": (p_t, params), "m": (o_t["m"], jopt["m"]),
             "v": (o_t["v"], jopt["v"])}
    for what, (got, exp) in trees.items():
        exp = bridge.params_from_jax(_np(exp), "cpu")
        for (path, a), (_, b) in zip(leaves(got), leaves(exp)):
            assert a.shape == b.shape, (what, path)
            assert _err(a, b.numpy()) <= TOL_TRAIN, (what, path)
            moved += what == "m" and bool((a != 0).any())
    assert moved == len(list(leaves(p_t)))    # every leaf had a gradient


@pytest.mark.parametrize("name", CTR_NAMES + ["BERT4REC"])
def test_train_steps_from_a_bridged_state_match_jax(name):
    _run_steps(name)


def test_bert4rec_accumulated_train_steps_match_jax():
    _run_steps("BERT4REC", accum_steps=2)


def test_bert4rec_microbatched_step_equals_the_one_shot_step():
    """With every ``mask_valid`` true (``recsys_synth``'s batches), the
    step the card takes at ``train_batch`` (the batch as microbatches,
    ``accum_steps`` > 1) is the one-shot ``make_fn`` step up to rounding:
    each microbatch's loss is a mean over the same count of masks."""
    _, cfg, _, _, _, tbatch = _case("BERT4REC")
    one = recsys_family.make_fn(cfg, "train", device="cpu")
    micro = optim.make_train_step(
        lambda p, b: bert4rec.loss(p, cfg, b),
        dataclasses.replace(recsys_family.RS_OPT, accum_steps=4))
    states = []
    for step in (one, micro):
        params = bert4rec.init(torch.Generator().manual_seed(0), cfg)
        opt, rng, ms = optim.adam_init(params), np.random.default_rng(2), []
        for _ in range(2):
            batch = tbatch(rng)
            assert bool(batch["mask_valid"].all())
            params, opt, m = step(params, opt, batch)
            ms.append(m)
        states.append((params, ms))
    (p1, m1), (p4, m4) = states
    for a, b in zip(m1, m4):
        assert abs(float(a["loss"]) - float(b["loss"])) <= 1e-6
        assert abs(float(a["grad_norm"]) - float(b["grad_norm"])) <= \
            1e-5 * float(a["grad_norm"])
    for (path, a), (_, b) in zip(leaves(p1), leaves(p4)):
        assert float((a - b).detach().abs().max()) <= TOL_TRAIN, path


def test_ctr_train_step_takes_the_lookup_kernels_path(monkeypatch):
    """A CTR train step's lookups go through ``ops.embedding_bag`` (the
    autograd Function): Wide&Deep's two tables get their gradients from
    its backward, and nothing from the plain gather's autograd."""
    jcfg, cfg, _, jinit, _, tbatch = _case("WIDE_DEEP")
    params = bridge.params_from_jax(
        _np(jinit(jax.random.PRNGKey(0), jcfg)), "cpu")
    calls = []
    real = ebag.embedding_bag_bwd_plain

    def counted(dout, idx, weights, num_rows):
        calls.append((tuple(dout.shape), num_rows))
        return real(dout, idx, weights, num_rows)

    monkeypatch.setattr(ebag, "embedding_bag_bwd_plain", counted)
    monkeypatch.setattr(common, "embedding_bag_plain", None)   # not reached
    step = recsys_family.make_fn(cfg, "train", device="cpu")
    before = [t.clone() for _, t in leaves(params)]
    params, opt, m = step(params, optim.adam_init(params),
                          tbatch(np.random.default_rng(0)))
    F = cfg.sparse.n_fields
    rows = common.padded_rows(cfg.sparse.total_rows)
    assert sorted(calls) == [((B_CTR, F, 1), rows),
                             ((B_CTR, F, cfg.sparse.embed_dim), rows)]
    assert bool(torch.isfinite(m["loss"])) and int(opt["count"]) == 1
    assert all(not torch.equal(a, b) for a, (_, b) in
               zip(before, leaves(params)))


def test_make_fn_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    for cfg in (recsys_family.DLRM_RM2, recsys_family.BERT4REC):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            recsys_family.make_fn(cfg, "train")
    assert recsys_family.B4R_ONE_CARD_ACCUM * 4096 == \
        recsys_family.RS_SHAPES["train_batch"]["batch"]


def test_make_fn_takes_no_optimizer():
    """``train`` is fixed to the JAX cell's ``RS_OPT``: no argument picks
    another optimizer."""
    cfg = recsys_family.reduced_ctr(recsys_family.DLRM_RM2)
    with pytest.raises(TypeError, match="opt"):
        recsys_family.make_fn(cfg, "train", device="cpu",
                              opt=recsys_family.RS_OPT)


def test_opt_from_jax_keeps_list_nodes_and_the_count():
    jcfg = _jax_reduced_ctr("DCN_V2")
    params = jax_ctr.init(jax.random.PRNGKey(0), jcfg)
    opt = joptim.adam_init(params)
    opt = {"m": jax.tree.map(lambda a: a + 0.5, opt["m"]),
           "v": jax.tree.map(lambda a: a + 2.0, opt["v"]),
           "count": jnp.int32(12)}
    got = bridge.opt_from_jax(_np(opt), "cpu")
    assert not hasattr(bridge, "lm_opt_from_jax")
    assert isinstance(got["m"]["cross"], list)
    assert len(got["m"]["cross"]) == jcfg.n_cross_layers
    assert got["count"].dtype == torch.int32 and int(got["count"]) == 12
    exp = bridge.params_from_jax(_np(params), "cpu")
    for tree, value in ((got["m"], 0.5), (got["v"], 2.0)):
        assert [p for p, _ in leaves(tree)] == [p for p, _ in leaves(exp)]
        for path, t in leaves(tree):
            assert t.dtype == torch.float32 and bool((t == value).all()), \
                path


def test_train_step_frees_its_gradients_on_return(monkeypatch):
    """The dense table gradient is freed when the step returns, not when
    Python's cycle collector next runs: held over, it would add one
    gradient (8.37 GB for DLRM-RM2) to the next step's peak."""
    import gc
    import weakref

    jcfg, cfg, _, jinit, _, tbatch = _case("DLRM_RM2")
    params = bridge.params_from_jax(
        _np(jinit(jax.random.PRNGKey(0), jcfg)), "cpu")
    refs = []
    real = ebag.embedding_bag_bwd_plain

    def spy(dout, idx, weights, num_rows):
        g = real(dout, idx, weights, num_rows)
        refs.append(weakref.ref(g))
        return g

    monkeypatch.setattr(ebag, "embedding_bag_bwd_plain", spy)
    step = recsys_family.make_fn(cfg, "train", device="cpu")
    opt = optim.adam_init(params)
    gc.disable()
    try:
        params, opt, _ = step(params, opt, tbatch(np.random.default_rng(0)))
        assert len(refs) == 1 and refs[0]() is None
    finally:
        gc.enable()


def test_unflatten_keeps_no_reference_to_its_values():
    """``adam.unflatten`` leaves nothing that holds ``values`` once its
    tree is dropped, with the cycle collector off: a recursive closure
    over the values' iterator would be a reference cycle."""
    import gc
    import weakref

    from repro_torch.optim.adam import unflatten

    like = {"a": [0, 0], "b": {"c": 0}}
    values = [torch.zeros(3), torch.ones(2), torch.full((1,), 2.0)]
    refs = [weakref.ref(v) for v in values]
    gc.disable()
    try:
        tree = unflatten(like, tuple(values))
        assert tree["a"][1] is values[1] and tree["b"]["c"] is values[2]
        del tree, values
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


@pytest.mark.parametrize("name", CTR_NAMES + ["BERT4REC"])
def test_loss_gradients_match_jax_grad(name):
    """``ctr.loss`` (its lookups through ``ops.embedding_bag``) and
    ``bert4rec.loss``: every gradient leaf against ``jax.grad`` of the
    JAX loss on the same parameters and batch: within TOL_VJP absolute,
    or TOL_VJP of the leaf's largest magnitude where that exceeds 1."""
    jcfg, cfg, jmod, jinit, jbatch, tbatch = _case(name)
    params = jinit(jax.random.PRNGKey(7), jcfg)
    g_j = jax.grad(lambda p: jmod.loss(p, jcfg, jbatch(
        np.random.default_rng(11)))[0])(params)
    p_t = bridge.params_from_jax(_np(params), "cpu")
    flat = [t.requires_grad_() for _, t in leaves(p_t)]
    mod = bert4rec if name == "BERT4REC" else ctr
    loss, _ = mod.loss(p_t, cfg, tbatch(np.random.default_rng(11)))
    grads = torch.autograd.grad(loss, flat)
    exp = leaves(bridge.params_from_jax(_np(g_j), "cpu"))
    for g, (path, e) in zip(grads, exp):
        top = float(e.abs().max())
        assert float((g - e).abs().max()) <= TOL_VJP * max(top, 1.0), path
