"""CTR models: Wide&Deep [1606.07792], DLRM [1906.00091], DCN-v2
[2008.13535].

The three share the embedding stack and differ in the interaction op
(concat / dot / cross). Batch layout (tensors on one device):

  dense      [B, n_dense]  float
  sparse_idx [B, F, nnz]   int32 (per-field local ids)
  sparse_w   [B, F, nnz]   float (0 = padded slot)
  label      [B]           float {0, 1}

Every lookup goes through ``common.lookup``: with ``impl="kernel"`` (the
default) the CUDA EmbeddingBag kernel on the card, with ``impl="plain"``
its plain version (a reference run only). ``retrieval`` scores one query
batch against a precomputed candidate matrix (matmul and top-k).

Every entry point takes ``mesh=``: on a (data, model) mesh of ranks
(``launch/mesh.py``) the parameters are this rank's blocks
(``parallel.place_params``: the fused and wide tables cut by rows over
``model``, the towers whole), the batch comes in whole and each rank
runs its data block (``models/recsys/parallel.py`` says how).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.nn import dense as dense_layer
from repro_torch.nn import init_dense, init_mlp, mlp, normal_init

from . import parallel as rp
from .common import SparseSpec, bce_loss, init_tables, lookup


@dataclasses.dataclass(frozen=True)
class CTRConfig:
    name: str
    sparse: SparseSpec
    n_dense: int
    interaction: str                  # concat | dot | cross
    mlp_dims: tuple                   # deep tower
    bot_mlp: tuple = ()               # dlrm bottom mlp over dense feats
    top_mlp: tuple = ()               # dlrm top mlp
    n_cross_layers: int = 0           # dcn-v2
    wide: bool = False                # wide&deep linear part
    dtype: str = "float32"

    @property
    def wide_spec(self) -> SparseSpec:
        """The wide part's table: one scalar weight per row."""
        return dataclasses.replace(self.sparse, embed_dim=1)


def init(gen: torch.Generator, cfg: CTRConfig, param_dtype=torch.float32):
    """Parameters drawn from ``gen`` on its device, in the JAX package's
    tree layout (DCN-v2's ``cross`` is a list of layers)."""
    d_emb = cfg.sparse.embed_dim
    F = cfg.sparse.n_fields
    p = {"tables": init_tables(gen, cfg.sparse, param_dtype)}
    if cfg.interaction == "dot":          # DLRM
        p["bot"] = init_mlp(gen, (cfg.n_dense,) + cfg.bot_mlp,
                            dtype=param_dtype)
        n_vec = F + 1
        n_pairs = n_vec * (n_vec - 1) // 2
        p["top"] = init_mlp(gen, (n_pairs + cfg.bot_mlp[-1],) + cfg.top_mlp,
                            dtype=param_dtype)
    elif cfg.interaction == "cross":      # DCN-v2
        x0 = cfg.n_dense + F * d_emb
        p["cross"] = [
            {"w": normal_init(gen, (x0, x0), 0.01, param_dtype),
             "b": torch.zeros(x0, dtype=param_dtype, device=gen.device)}
            for _ in range(cfg.n_cross_layers)]
        p["deep"] = init_mlp(gen, (x0,) + cfg.mlp_dims, dtype=param_dtype)
        p["final"] = init_dense(gen, x0 + cfg.mlp_dims[-1], 1,
                                dtype=param_dtype)
    else:                                 # wide&deep (concat)
        x0 = cfg.n_dense + F * d_emb
        p["deep"] = init_mlp(gen, (x0,) + cfg.mlp_dims + (1,),
                             dtype=param_dtype)
        if cfg.wide:
            p["wide"] = init_tables(gen, cfg.wide_spec, param_dtype)
            if cfg.n_dense:
                p["wide_dense"] = init_dense(gen, cfg.n_dense, 1,
                                             dtype=param_dtype)
    return p


def forward(params, cfg: CTRConfig, batch, *, impl: str = "kernel",
            mesh=None):
    """-> logits [B] (with ``mesh``: this rank's data block's).

    ``impl`` reaches every lookup, the Wide&Deep wide part's too (the JAX
    package's wide lookup always takes XLA; the arithmetic is the same),
    so a forward on the card runs no plain gather.
    """
    if mesh is not None:
        batch = rp.batch_block(batch, mesh)[0]
    return _forward(params, cfg, batch, impl, mesh)


def _forward(params, cfg: CTRConfig, batch, impl: str, mesh):
    emb = lookup(params["tables"], cfg.sparse, batch["sparse_idx"],
                 batch.get("sparse_w"), impl=impl, mesh=mesh)  # [B, F, d]
    B, F, d = emb.shape
    dense_x = batch["dense"].to(emb.dtype) if cfg.n_dense else None

    if cfg.interaction == "dot":
        bot = mlp(params["bot"], dense_x, final_act=torch.relu)   # [B, d]
        vecs = torch.cat([bot[:, None, :], emb], dim=1)     # [B, F+1, d]
        gram = torch.bmm(vecs, vecs.transpose(1, 2))
        # the upper triangle, row-major as jnp.triu_indices orders it
        iu, ju = torch.triu_indices(F + 1, F + 1, 1, device=emb.device)
        x = torch.cat([bot, gram[:, iu, ju]], dim=-1)       # [B, d+pairs]
        return mlp(params["top"], x)[:, 0]

    flat = emb.reshape(B, F * d)
    x0 = torch.cat([dense_x, flat], -1) if dense_x is not None else flat

    if cfg.interaction == "cross":
        x = x0
        for layer in params["cross"]:
            xw = x @ layer["w"].to(x.dtype) + layer["b"].to(x.dtype)
            x = x0 * xw + x                                 # x0 * (Wx+b) + x
        deep = mlp(params["deep"], x0, final_act=torch.relu)
        both = torch.cat([x, deep], dim=-1)
        return dense_layer(params["final"], both)[:, 0]

    # wide&deep
    logit = mlp(params["deep"], x0)[:, 0]
    if cfg.wide:
        w_emb = lookup(params["wide"], cfg.wide_spec, batch["sparse_idx"],
                       batch.get("sparse_w"), impl=impl,
                       mesh=mesh)                           # [B, F, 1]
        logit = logit + w_emb.sum(dim=(1, 2))
        if cfg.n_dense:
            logit = logit + dense_layer(params["wide_dense"], dense_x)[:, 0]
    return logit


def loss(params, cfg: CTRConfig, batch, *, impl: str = "kernel",
         mesh=None):
    """The mean binary cross-entropy (with ``mesh``: the global batch's,
    each rank differentiating its own block's part)."""
    if mesh is None:
        return bce_loss(forward(params, cfg, batch, impl=impl),
                        batch["label"])
    block, split = rp.batch_block(batch, mesh)
    return bce_loss(_forward(params, cfg, block, impl, mesh), block["label"],
                    mesh=mesh, split=split)


def user_repr(params, cfg: CTRConfig, batch, *, impl: str = "kernel",
              mesh=None):
    """Penultimate representation for retrieval scoring (with ``mesh``:
    this rank's data block's)."""
    if mesh is not None:
        batch = rp.batch_block(batch, mesh)[0]
    return _user_repr(params, cfg, batch, impl, mesh)


def _user_repr(params, cfg: CTRConfig, batch, impl: str, mesh):
    emb = lookup(params["tables"], cfg.sparse, batch["sparse_idx"],
                 batch.get("sparse_w"), impl=impl, mesh=mesh)
    B, F, d = emb.shape
    if cfg.interaction == "dot":
        bot = mlp(params["bot"], batch["dense"].to(emb.dtype),
                  final_act=torch.relu)
        return torch.cat([bot, emb.mean(dim=1)], dim=-1)
    flat = emb.reshape(B, F * d)
    if cfg.n_dense:
        flat = torch.cat([batch["dense"].to(emb.dtype), flat], dim=-1)
    return flat


def retrieval(params, cfg: CTRConfig, batch, cand, *, k: int = 100,
              impl: str = "kernel", mesh=None):
    """Score one query batch against cand [N, d_repr] (candidates are
    precomputed offline); -> (top-k scores [B, k], their rows [B, k]).

    With ``mesh`` (``cand`` whole): every rank computes the whole query
    batch and scores its block of the candidates over ``data``, then the
    top-k is taken in two stages (``parallel.cut_topk``); returns this
    rank's batch block of the result."""
    if mesh is None:
        u = user_repr(params, cfg, batch, impl=impl)       # [B, D]
        return torch.topk(u @ cand.to(u.dtype).T, k, dim=-1)
    u = _user_repr(params, cfg, batch, impl, mesh)
    vals, rows = rp.cut_topk(lambda c: u @ c.to(u.dtype).T, cand, k, mesh)
    return rp.data_block(vals, mesh)[0], rp.data_block(rows, mesh)[0]
