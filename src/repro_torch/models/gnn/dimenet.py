"""DimeNet [2003.03123] — directional message passing with radial (RBF) and
spherical (SBF) bases and the original bilinear triplet interaction (the
JAX package's ``models/gnn/dimenet.py``).

Messages live on edges, and each edge ji aggregates over the triplets
(kj -> ji) that share its source j. Message passing is a gather
(``index_select``) and a scatter-add (``index_add_`` into zeros of the
segment count); on the card both are PyTorch's own CUDA ops, and no
hand-written kernel lies on this path (the JAX model runs ``jnp.take``
and ``jax.ops.segment_sum`` through XLA, outside any Pallas kernel).
``index_add_`` on CUDA adds with atomics, so the card's sums are not
bit-stable from run to run.

Graph batch layout (host-built, statically padded; ``data/graph.py``):
  feat/z      [N]/[N, F]   node types (molecule) or features (citation)
  pos         [N, 3]       positions (synthetic for non-molecular graphs)
  edge_src/dst[E]          j -> i edges (0-padded; a pad edge is a
                           self-loop at node 0, its distance 1e-6)
  edge_mask   [E]
  trip_kj/ji  [T]          indices into the edge list (capped)
  trip_mask   [T]          (a pad triplet is (0, 0), zeroed by the mask)
  graph_id    [N]          for batched small graphs (molecule shape)

Basis note: the spherical Bessel zeros of the original are approximated with
z_{l,n} ~ (n + l/2) * pi and the angular part uses Legendre P_l(cos a),
as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.nn import dense, embed, init_dense, init_embedding, \
    normal_init


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    envelope_p: int = 5
    n_node_types: int = 95        # molecule mode (z embeddings)
    d_feat: int = 0               # citation mode (feature linear) if > 0
    out_dim: int = 1              # 1 = regression energy; >1 = node classes
    node_level: bool = False      # node-level output (citation) vs graph sum
    dtype: str = "float32"


# ---------------------------------------------------------------------------
# bases
# ---------------------------------------------------------------------------

def envelope(d, cutoff, p):
    """Smooth polynomial cutoff u(d) (paper Eq. 8)."""
    x = d / cutoff
    a = -(p + 1) * (p + 2) / 2
    b = p * (p + 2)
    c = -p * (p + 1) / 2
    u = 1 / torch.clamp_min(x, 1e-9) + a * x ** (p - 1) + b * x ** p \
        + c * x ** (p + 1)
    return torch.where(x < 1.0, u, torch.zeros_like(u))


def rbf_basis(d, cfg: DimeNetConfig):
    """[E] -> [E, n_radial]: env(x) * sin(n pi x); env's 1/x term IS the
    basis' 1/d factor (as in the reference implementation)."""
    n = torch.arange(1, cfg.n_radial + 1, dtype=torch.float32,
                     device=d.device)
    x = d[:, None] / cfg.cutoff
    out = math.sqrt(2.0 / cfg.cutoff) * torch.sin(n * math.pi * x)
    return out * envelope(d, cfg.cutoff, cfg.envelope_p)[:, None]


def _legendre(cos_a, l_max: int):
    """P_0..P_{l_max-1}(cos a) via recurrence -> [T, l_max]."""
    outs = [torch.ones_like(cos_a)]
    if l_max > 1:
        outs.append(cos_a)
    for l in range(2, l_max):
        outs.append(((2 * l - 1) * cos_a * outs[-1]
                     - (l - 1) * outs[-2]) / l)
    return torch.stack(outs, dim=-1)


def sbf_basis(d, cos_angle, cfg: DimeNetConfig):
    """[T],[T] -> [T, n_spherical * n_radial] radial x angular basis."""
    L, R = cfg.n_spherical, cfg.n_radial
    l = torch.arange(L, dtype=torch.float32, device=d.device)[:, None]
    n = torch.arange(1, R + 1, dtype=torch.float32, device=d.device)[None, :]
    zeros = (n + l / 2.0) * math.pi                     # approx j_l zeros
    x = d[:, None, None] / cfg.cutoff                   # [T,1,1]
    radial = torch.sin(zeros[None] * x)
    radial = radial * envelope(d, cfg.cutoff, cfg.envelope_p)[:, None, None]
    angular = _legendre(cos_angle, L)                   # [T, L]
    return (radial * angular[:, :, None]).reshape(d.shape[0], L * R)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def _init_res_mlp(gen, d, n, param_dtype):
    return [init_dense(gen, d, d, dtype=param_dtype) for _ in range(n)]


def init(gen: torch.Generator, cfg: DimeNetConfig,
         param_dtype=torch.float32):
    """Random parameters on ``gen``'s device, in the JAX package's tree:
    ``blocks`` a list of per-block dicts, ``res1``/``res2`` lists of two
    dense layers, ``bilinear`` [nsbf, d, nb]; ``feat_proj`` (citation) or
    ``z_emb`` (molecule)."""
    d, nb = cfg.d_hidden, cfg.n_bilinear
    nsbf = cfg.n_spherical * cfg.n_radial
    p = {
        "rbf_proj": init_dense(gen, cfg.n_radial, d, use_bias=False,
                               dtype=param_dtype),
        "emb_mlp": init_dense(gen, 3 * d, d, dtype=param_dtype),
        "out_rbf": init_dense(gen, cfg.n_radial, d, use_bias=False,
                              dtype=param_dtype),
        "out_mlp1": init_dense(gen, d, d, dtype=param_dtype),
        "out_mlp2": init_dense(gen, d, cfg.out_dim, dtype=param_dtype),
        "blocks": [],
    }
    if cfg.d_feat:
        p["feat_proj"] = init_dense(gen, cfg.d_feat, d, dtype=param_dtype)
    else:
        p["z_emb"] = init_embedding(gen, cfg.n_node_types, d,
                                    dtype=param_dtype)
    for _ in range(cfg.n_blocks):
        p["blocks"].append({
            "w_src": init_dense(gen, d, d, dtype=param_dtype),
            "w_msg": init_dense(gen, d, d, dtype=param_dtype),
            "sbf_proj": init_dense(gen, nsbf, nsbf, use_bias=False,
                                   dtype=param_dtype),
            "bilinear": normal_init(gen, (nsbf, d, nb), 0.1, param_dtype),
            "bilin_out": init_dense(gen, nb, d, dtype=param_dtype),
            "res1": _init_res_mlp(gen, d, 2, param_dtype),
            "res2": _init_res_mlp(gen, d, 2, param_dtype),
        })
    return p


def _act(x):
    return F.silu(x)


def _res(layers, x):
    for l in layers:
        x = x + _act(dense(l, x))
    return x


def _segment_sum(x, seg, num_segments: int):
    """``jax.ops.segment_sum``: rows of x added into zeros of
    ``num_segments`` rows at ``seg``."""
    out = torch.zeros((num_segments,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, seg, x)


def bilinear(a, w, m_kj):
    """``einsum("ts,sdb,td->tb", a, w, m_kj)`` with one [T, nsbf, nb]
    temporary: m_kj @ w (w as [d, nsbf * nb]), then each triplet's
    [1, nsbf] row of a against its [nsbf, nb] slice."""
    S, D, B = w.shape
    tmp = (m_kj @ w.permute(1, 0, 2).reshape(D, S * B)).view(-1, S, B)
    return torch.bmm(a.unsqueeze(1), tmp).squeeze(1)


def geometry(batch, cfg: DimeNetConfig):
    """Distances per edge and cos(angle) per triplet from positions."""
    pos = batch["pos"]
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    vec = pos.index_select(0, dst) - pos.index_select(0, src)  # x_i - x_j
    d = torch.sqrt(torch.clamp_min((vec ** 2).sum(-1), 1e-12))
    # triplet (kj, ji): angle at j between (j->k ... k->j edge) and (j->i)
    v_ji = vec.index_select(0, batch["trip_ji"].long())
    v_kj = -vec.index_select(0, batch["trip_kj"].long())   # j -> k
    num = (v_ji * v_kj).sum(-1)
    den = torch.clamp_min(torch.linalg.vector_norm(v_ji, dim=-1)
                          * torch.linalg.vector_norm(v_kj, dim=-1), 1e-9)
    return d, torch.clamp(num / den, -1.0, 1.0)


def forward(params, cfg: DimeNetConfig, batch, *, n_graphs: int = 1):
    """-> [G, out_dim] (graph-level) or [N, out_dim] (node-level)."""
    dt = getattr(torch, cfg.dtype)
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    kj, ji = batch["trip_kj"].long(), batch["trip_ji"].long()
    E = src.shape[0]
    N = batch["pos"].shape[0]
    emask = batch["edge_mask"].to(dt)[:, None]
    tmask = batch["trip_mask"].to(dt)[:, None]

    d, cos_a = geometry(batch, cfg)
    rbf = rbf_basis(d, cfg).to(dt)                       # [E, R]
    sbf = sbf_basis(d.index_select(0, kj), cos_a, cfg).to(dt)  # [T, LR]

    if cfg.d_feat:
        h = _act(dense(params["feat_proj"], batch["feat"].to(dt)))
    else:
        h = embed(params["z_emb"], batch["z"].long(), dtype=dt)
    rbf_h = dense(params["rbf_proj"], rbf)
    m = _act(dense(params["emb_mlp"],
                   torch.cat([h.index_select(0, src), h.index_select(0, dst),
                              rbf_h], -1))) * emask

    out = torch.zeros((N, cfg.d_hidden), dtype=dt, device=m.device)
    for blk in params["blocks"]:
        # directional triplet interaction (bilinear, original DimeNet)
        m_kj = _act(dense(blk["w_msg"], m)).index_select(0, kj)  # [T, d]
        a = dense(blk["sbf_proj"], sbf)                          # [T, LR]
        t = bilinear(a, blk["bilinear"].to(dt), m_kj) * tmask    # [T, nb]
        agg = _segment_sum(t, ji, E)
        upd = dense(blk["bilin_out"], agg)                       # [E, d]
        m2 = _act(dense(blk["w_src"], m)) + upd
        m2 = _res(blk["res1"], m2)
        m = _res(blk["res2"], m + m2) * emask
        # per-block output: edges -> nodes
        g = dense(params["out_rbf"], rbf) * m
        out = out + _segment_sum(g, dst, N)

    out = _act(dense(params["out_mlp1"], out))
    out = dense(params["out_mlp2"], out)
    if cfg.node_level:
        return out
    return _segment_sum(out, batch["graph_id"].long(), n_graphs)


def loss(params, cfg: DimeNetConfig, batch, *, n_graphs: int = 1):
    """(loss, metrics): masked node cross-entropy and accuracy
    (node-level), or the graphs' mean squared error."""
    y = forward(params, cfg, batch, n_graphs=n_graphs)
    if cfg.node_level:
        labels = batch["labels"].long()
        lmask = batch["label_mask"]
        logp = F.log_softmax(y.float(), -1)
        nll = -logp.gather(-1, labels[:, None])[:, 0]
        n = lmask.sum().clamp_min(1)
        l = (nll * lmask).sum() / n
        acc = ((y.argmax(-1) == labels) & lmask).sum() / n
        return l, {"acc": acc}
    err = (y[:, 0].float() - batch["targets"]) ** 2
    return err.mean(), {"mse": err.mean()}
