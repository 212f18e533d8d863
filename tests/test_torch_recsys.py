"""The port's recsys serving path against the JAX package.

Weights are drawn by the JAX package and carried over with
``bridge.params_from_jax`` (DCN-v2's ``cross`` and BERT4Rec's ``blocks``
are list nodes); batches come from both packages' ``recsys_synth`` with
one numpy seed. The configs are the JAX package's smoke sizes
(``_ctr_smoke``, ``_b4r_smoke``). The JAX CTR forward runs with
``impl="xla"`` and with ``impl="pallas"`` (its EmbeddingBag kernel in
interpret mode); the port's lookups take the kernel's plain version on
the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import recsys_family as jax_family  # noqa: E402
from repro.data import recsys_synth as jax_synth  # noqa: E402
from repro.models.recsys import bert4rec as jax_b4r  # noqa: E402
from repro.models.recsys import common as jax_common  # noqa: E402
from repro.models.recsys import ctr as jax_ctr  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import recsys_family  # noqa: E402
from repro_torch.data import recsys_synth  # noqa: E402
from repro_torch.models.recsys import bert4rec, common, ctr  # noqa: E402

TOL = 1e-5              # f32; logits, representations and top-k scores
CTR_NAMES = ["WIDE_DEEP", "DLRM_RM2", "DCN_V2"]
B_CTR, B_B4R, K = 32, 8, 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _err(got, exp) -> float:
    return float(np.abs(got.detach().float().numpy()
                        - np.asarray(exp, np.float32)).max())


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


def _ctr_case(name, seed=0):
    jcfg = _jax_reduced_ctr(name)
    cfg = recsys_family.reduced_ctr(getattr(recsys_family, name))
    params = jax_ctr.init(jax.random.PRNGKey(seed), jcfg)
    kw = dict(batch=B_CTR, n_dense=cfg.n_dense,
              vocab_sizes=cfg.sparse.vocab_sizes, nnz=cfg.sparse.nnz)
    jb = jax_synth.ctr_batch(np.random.default_rng(seed), **kw)
    tb = recsys_synth.ctr_batch(np.random.default_rng(seed), device="cpu",
                                **kw)
    return (jcfg, params, jb), (cfg, bridge.params_from_jax(_np(params),
                                                            "cpu"), tb)


def _b4r_case(seed=0):
    jcfg = dataclasses.replace(jax_family.BERT4REC, n_items=500,
                               embed_dim=16, seq_len=24, d_ff=32, n_mask=4,
                               n_neg=8)
    cfg = recsys_family.reduced_b4r(recsys_family.BERT4REC)
    params = jax_b4r.init(jax.random.PRNGKey(seed), jcfg)
    kw = dict(batch=B_B4R, seq_len=cfg.seq_len, n_items=cfg.n_items,
              n_mask=cfg.n_mask, n_neg=cfg.n_neg, mask_token=cfg.mask_token)
    jb = jax_synth.bert4rec_batch(np.random.default_rng(seed), **kw)
    tb = recsys_synth.bert4rec_batch(np.random.default_rng(seed),
                                     device="cpu", **kw)
    return (jcfg, params, jb), (cfg, bridge.params_from_jax(_np(params),
                                                            "cpu"), tb)


def test_configs_carry_the_jax_widths():
    for name in CTR_NAMES + ["BERT4REC"]:
        assert dataclasses.asdict(getattr(recsys_family, name)) == \
            dataclasses.asdict(getattr(jax_family, name))
    for name in CTR_NAMES:
        cfg = getattr(recsys_family, name)
        assert dataclasses.asdict(recsys_family.reduced_ctr(cfg)) == \
            dataclasses.asdict(_jax_reduced_ctr(name))
        assert recsys_family.ctr_repr_dim(cfg) == \
            jax_family._ctr_repr_dim(getattr(jax_family, name))
    assert dataclasses.asdict(_b4r_case()[1][0]) == \
        dataclasses.asdict(_b4r_case()[0][0])
    assert recsys_family.RS_SHAPES == jax_family.RS_SHAPES
    assert dataclasses.asdict(recsys_family.RS_OPT) == \
        dataclasses.asdict(jax_family.RS_OPT)
    for n in (1, 13, 26, 40):
        assert common.criteo_like_vocab(n) == jax_common.criteo_like_vocab(n)
    assert common.criteo_like_vocab(26, scale=0.01) == \
        jax_common.criteo_like_vocab(26, scale=0.01)
    for total in (1, 4096, 4097, 32_709_138):
        assert common.padded_rows(total) == jax_common.padded_rows(total)
    assert common.padded_rows(32_709_138) == 32_710_656
    assert bert4rec.padded_items(3_000_000) == \
        jax_b4r._padded_items(3_000_000)


@pytest.mark.parametrize("name", CTR_NAMES)
def test_recsys_synth_ctr_batch_is_bit_identical(name):
    (_, _, jb), (_, _, tb) = _ctr_case(name, seed=3)
    assert set(tb) == set(jb)
    for k, v in jb.items():
        assert tb[k].dtype == getattr(torch, str(v.dtype))
        assert np.array_equal(tb[k].numpy(), np.asarray(v)), k


def test_recsys_synth_bert4rec_batch_is_bit_identical():
    for markov in (True, False):
        kw = dict(batch=4, seq_len=24, n_items=500, n_mask=4, n_neg=8,
                  mask_token=500, markov=markov)
        jb = jax_synth.bert4rec_batch(np.random.default_rng(5), **kw)
        tb = recsys_synth.bert4rec_batch(np.random.default_rng(5),
                                         device="cpu", **kw)
        assert set(tb) == set(jb)
        for k, v in jb.items():
            assert np.array_equal(tb[k].numpy(), np.asarray(v)), k
    unlearn = dict(batch=6, n_dense=2, vocab_sizes=(5, 9), learnable=False)
    jb = jax_synth.ctr_batch(np.random.default_rng(1), **unlearn)
    tb = recsys_synth.ctr_batch(np.random.default_rng(1), device="cpu",
                                **unlearn)
    assert np.array_equal(tb["label"].numpy(), np.asarray(jb["label"]))


@pytest.mark.parametrize("name", ["DCN_V2", "BERT4REC"])
def test_bridge_carries_list_nodes_exactly(name):
    if name == "BERT4REC":
        (jcfg, params, _), (cfg, got, _) = _b4r_case(seed=2)
        key, n = "blocks", cfg.n_blocks
    else:
        (jcfg, params, _), (cfg, got, _) = _ctr_case(name, seed=2)
        key, n = "cross", cfg.n_cross_layers
    assert isinstance(got[key], list) and len(got[key]) == n
    flat_j = jax.tree_util.tree_leaves_with_path(_np(params))
    flat_t = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), got))
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (_, a), (_, b) in zip(flat_t, flat_j):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("weighted", [True, False])
def test_lookup_matches_jax(fused, weighted):
    spec_j = jax_common.SparseSpec(n_fields=4, vocab_sizes=(7, 30, 5, 12),
                                   embed_dim=6, nnz=3)
    spec = common.SparseSpec(**dataclasses.asdict(spec_j))
    tables = _np(jax_common.init_tables(jax.random.PRNGKey(4), spec_j,
                                        fused=fused))
    rng = np.random.default_rng(4)
    idx = np.stack([rng.integers(0, v, (9, spec.nnz))
                    for v in spec.vocab_sizes], axis=1).astype(np.int32)
    w = rng.uniform(size=idx.shape).astype(np.float32) if weighted else None
    exp = jax_common.lookup(tables, spec_j, jnp.asarray(idx),
                            None if w is None else jnp.asarray(w))
    t_tables = bridge.params_from_jax(tables, "cpu")
    tw = None if w is None else torch.tensor(w)
    for impl in ("kernel", "plain"):
        got = common.lookup(t_tables, spec, torch.tensor(idx), tw, impl=impl)
        assert got.shape == (9, 4, 6)
        assert _err(got, exp) <= TOL
    if fused:
        assert np.array_equal(common.field_offsets(spec).numpy(),
                              np.asarray(jax_common.field_offsets(spec_j)))
    with pytest.raises(ValueError):
        common.lookup(t_tables, spec, torch.tensor(idx), impl="xla")


def test_init_tables_shapes_match_jax():
    spec_j = jax_common.SparseSpec(n_fields=3, vocab_sizes=(7, 4097, 5),
                                   embed_dim=4)
    spec = common.SparseSpec(**dataclasses.asdict(spec_j))
    gen = torch.Generator().manual_seed(0)
    for fused in (True, False):
        shapes_j = jax.tree.map(lambda a: a.shape, jax_common.init_tables(
            jax.random.PRNGKey(0), spec_j, fused=fused))
        shapes_t = jax.tree.map(lambda t: tuple(t.shape), common.init_tables(
            gen, spec, fused=fused))
        assert shapes_t == shapes_j


@pytest.mark.parametrize("name", CTR_NAMES)
@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_ctr_forward_matches_jax(name, jax_impl):
    (jcfg, params, jb), (cfg, tparams, tb) = _ctr_case(name)
    exp = jax_ctr.forward(params, jcfg, jb, impl=jax_impl)
    for impl in ("kernel", "plain"):
        got = ctr.forward(tparams, cfg, tb, impl=impl)
        assert got.shape == (B_CTR,)
        assert _err(got, exp) <= TOL
    loss_j, m_j = jax_ctr.loss(params, jcfg, jb, impl=jax_impl)
    loss_t, m_t = ctr.loss(tparams, cfg, tb)
    assert abs(float(loss_t) - float(loss_j)) <= TOL
    assert float(m_t["acc"]) == float(m_j["acc"])


@pytest.mark.parametrize("name", CTR_NAMES)
def test_ctr_user_repr_and_retrieval_match_jax(name):
    (jcfg, params, jb), (cfg, tparams, tb) = _ctr_case(name)
    exp = jax_ctr.user_repr(params, jcfg, jb)
    got = ctr.user_repr(tparams, cfg, tb)
    assert got.shape == (B_CTR, recsys_family.ctr_repr_dim(cfg))
    assert _err(got, exp) <= TOL
    cand = np.random.default_rng(7).normal(
        size=(128, recsys_family.ctr_repr_dim(cfg))).astype(np.float32)
    s_j, i_j = jax_ctr.retrieval(params, jcfg, jb, jnp.asarray(cand), k=K)
    s_t, i_t = ctr.retrieval(tparams, cfg, tb, torch.tensor(cand), k=K)
    assert _err(s_t, s_j) <= TOL
    assert np.array_equal(i_t.numpy(), np.asarray(i_j))
    # the entry point: the same numbers through make_fn
    s_f, i_f = recsys_family.make_fn(cfg, "retrieval", device="cpu")(
        tparams, tb, torch.tensor(cand))
    assert torch.equal(i_f[:, :K], i_t)


def test_ctr_wide_part_goes_through_the_lookup_impl(monkeypatch):
    """Wide&Deep's wide lookup takes the forward's impl (two bags per
    forward through ``ops.embedding_bag``), so a card run gathers nothing
    through the plain version."""
    (_, _, _), (cfg, tparams, tb) = _ctr_case("WIDE_DEEP")
    calls = []
    real = common.ops.embedding_bag

    def counted(table, idx, weights=None):
        calls.append(tuple(table.shape))
        return real(table, idx, weights)

    monkeypatch.setattr(common.ops, "embedding_bag", counted)
    ctr.forward(tparams, cfg, tb)
    assert [s[1] for s in calls] == [cfg.sparse.embed_dim, 1]
    calls.clear()
    ctr.forward(tparams, cfg, tb, impl="plain")
    assert calls == []


def test_bert4rec_serve_and_retrieval_match_jax():
    (jcfg, params, jb), (cfg, tparams, tb) = _b4r_case()
    h_j = jax_b4r.encode(params, jcfg, jb["tokens"])
    assert _err(bert4rec.encode(tparams, cfg, tb["tokens"]), h_j) <= TOL
    s_j, i_j = jax_b4r.serve(params, jcfg, jb, k=10)
    s_t, i_t = bert4rec.serve(tparams, cfg, tb, k=10)
    assert _err(s_t, s_j) <= TOL
    assert np.array_equal(i_t.numpy(), np.asarray(i_j))
    s_f, i_f = recsys_family.make_fn(cfg, "serve", device="cpu")(tparams, tb)
    assert torch.equal(i_f[:, :10], i_t)
    cand = np.random.default_rng(8).integers(1, cfg.n_items, 300) \
        .astype(np.int32)
    one_j, one_t = {"tokens": jb["tokens"][:1]}, {"tokens": tb["tokens"][:1]}
    s_j, i_j = jax_b4r.retrieval(params, jcfg, one_j, jnp.asarray(cand), k=10)
    s_t, i_t = bert4rec.retrieval(tparams, cfg, one_t, torch.tensor(cand),
                                  k=10)
    assert _err(s_t, s_j) <= TOL
    assert np.array_equal(i_t.numpy(), np.asarray(i_j))
    l_j, m_j = jax_b4r.loss(params, jcfg, jb)
    l_t, m_t = bert4rec.loss(tparams, cfg, tb)
    assert abs(float(l_t) - float(l_j)) <= TOL
    assert float(m_t["cloze_acc"]) == float(m_j["cloze_acc"])


def test_init_draws_the_jax_tree_layout():
    gen = torch.Generator().manual_seed(0)
    for name in CTR_NAMES:
        cfg = recsys_family.reduced_ctr(getattr(recsys_family, name))
        jcfg = _jax_reduced_ctr(name)
        shapes_t = jax.tree.map(lambda t: tuple(t.shape), ctr.init(gen, cfg))
        shapes_j = jax.tree.map(lambda a: a.shape, jax_ctr.init(
            jax.random.PRNGKey(0), jcfg))
        assert shapes_t == shapes_j, name
    cfg = recsys_family.reduced_b4r(recsys_family.BERT4REC)
    shapes_t = jax.tree.map(lambda t: tuple(t.shape), bert4rec.init(gen, cfg))
    shapes_j = jax.tree.map(lambda a: a.shape, jax_b4r.init(
        jax.random.PRNGKey(0), _b4r_case()[0][0]))
    assert shapes_t == shapes_j


def test_make_fn_kinds():
    for cfg in (recsys_family.DLRM_RM2, recsys_family.BERT4REC):
        # train builds a step (held to JAX in test_torch_recsys_train.py)
        assert callable(recsys_family.make_fn(cfg, "train", device="cpu"))
        with pytest.raises(ValueError):
            recsys_family.make_fn(cfg, "prefill", device="cpu")
    (_, _, _), (cfg, tparams, tb) = _ctr_case("DLRM_RM2")
    logits = recsys_family.make_fn(cfg, "serve", device="cpu")(tparams, tb)
    assert logits.shape == (B_CTR,) and not logits.requires_grad
    assert torch.equal(logits, ctr.forward(tparams, cfg, tb))
