"""Product quantization: codebook training, encode/decode, ADC scoring.

A d-dim embedding is split into M subvectors of d/M dims; each subspace
gets a K-entry codebook trained with k-means, so a vector compresses to M
uint8 codes. Query scoring is asymmetric (ADC): one [M, K] table of
sub-inner-products per query, and every candidate's score is a LUT
gather+sum over its codes — ``kernels.ops.pq_lut_scores``.

Training draws from explicit ``torch.Generator``s on the data's device;
``fork`` derives an independent child generator where the JAX package
splits or folds a key. The two frameworks draw different streams, so
quantizers trained here are held to the JAX package by recall, not id
for id. ``opq_train`` adds the OPQ rotation: an orthogonal ``R``
learned by alternating PQ training with a Procrustes solve, carried in
``PQCodebook.rot`` so every encode/decode/LUT path applies it (``rot=None``
means identity).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class PQConfig:
    n_subvec: int = 8      # M: subvectors per embedding (d % M == 0)
    n_codes: int = 32      # K: codebook entries per subspace (<= 256 so
    #                        codes pack into uint8)
    train_iters: int = 15  # Lloyd iterations per subspace (mini-batch path
    #                        runs 2x this many cheap batch steps)
    train_sample: int = 16384   # codebooks train on at most this many rows
    train_batch: int = 2048     # mini-batch size past which Lloyd's is
    #                             replaced by kmeans_minibatch
    opq_iters: int = 0     # OPQ alternations (0 = no rotation, plain PQ)

    def __post_init__(self):
        if not 0 < self.n_codes <= 256:
            raise ValueError(
                f"n_codes must be in (0, 256] for uint8 codes, "
                f"got {self.n_codes}")


class PQCodebook(NamedTuple):
    centers: torch.Tensor  # [M, K, d/M]
    rot: Any = None        # [d, d] orthogonal OPQ rotation; None = identity


def fork(gen: torch.Generator) -> torch.Generator:
    """A child generator seeded by one draw from ``gen``."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                             device=gen.device))
    return torch.Generator(device=gen.device).manual_seed(seed)


# ---------------------------------------------------------------------------
# k-means: full Lloyd's and mini-batch, both with dead-centroid reseeding
# ---------------------------------------------------------------------------

def _dist2(x, cent):
    return ((x * x).sum(1)[:, None] - 2.0 * x @ cent.T
            + (cent * cent).sum(1)[None, :])


def _assign(x, cent):
    return _dist2(x, cent).argmin(dim=1)


def _segment_sum(values, seg, k: int):
    out = torch.zeros((k,) + values.shape[1:], dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, seg, values)


def _lloyd_iter(x, cent):
    """One Lloyd update with dead-centroid reseeding: empty clusters are
    re-planted on the farthest points of the largest cluster."""
    n, k = x.shape[0], cent.shape[0]
    d2 = _dist2(x, cent)                              # [n, k]
    a = d2.argmin(dim=1)
    counts = _segment_sum(torch.ones(n, dtype=x.dtype, device=x.device), a, k)
    sums = _segment_sum(x, a, k)
    new = torch.where(counts[:, None] > 0,
                      sums / counts.clamp_min(1.0)[:, None], cent)
    dead = counts == 0
    d2a = d2.gather(1, a[:, None])[:, 0]
    big = counts.argmax()
    score = torch.where(a == big, d2a, float("-inf"))  # farthest-of-largest
    far = torch.topk(score, min(k, n)).indices
    rank = (torch.cumsum(dead.long(), 0) - 1).clamp(0, min(k, n) - 1)
    return torch.where(dead[:, None], x[far[rank]], new)


def kmeans(gen: torch.Generator, x, k: int, iters: int = 15):
    """Lloyd's k-means (L2) on x [N, d] -> (centroids [k, d], assignment)."""
    n = x.shape[0]
    if n >= k:
        idx = torch.randperm(n, generator=gen, device=gen.device)[:k]
    else:
        idx = torch.randint(0, n, (k,), generator=gen, device=gen.device)
    cent = x[idx]
    for _ in range(iters):
        cent = _lloyd_iter(x, cent)
    return cent, _assign(x, cent)


def _kmeanspp_init(gen: torch.Generator, x, k: int):
    """k-means++-style seeding: new centroids are data points sampled with
    probability proportional to their squared distance from the chosen
    set, in ~16 chunked rounds (a whole chunk drawn from one D^2
    distribution, then distances refreshed)."""
    n = x.shape[0]
    c0 = x[torch.randint(0, n, (1,), generator=gen, device=gen.device)]
    if k == 1:
        return c0
    x2 = (x * x).sum(1)
    d2 = (x2 - 2.0 * x @ c0[0] + (c0 * c0).sum()).clamp_min(0.0)
    chunk = -(-k // 16)
    rounds = -(-(k - 1) // chunk)
    rest = []
    for _ in range(rounds):
        i = torch.multinomial(d2 + 1e-12, chunk, replacement=True,
                              generator=gen)
        c = x[i]                                            # [chunk, d]
        d2c = (x2[:, None] - 2.0 * x @ c.T
               + (c * c).sum(1)[None]).clamp_min(0.0)
        d2 = torch.minimum(d2, d2c.min(dim=1).values)
        rest.append(c)
    return torch.cat([c0, *rest], dim=0)[:k]


def kmeans_minibatch(gen: torch.Generator, x, k: int, *, iters: int = 30,
                     batch: int = 1024, polish: int = 2):
    """Mini-batch k-means (Sculley-style) on x [N, d] -> (centroids [k, d],
    assignment [N]): k-means++ seeded, ``iters`` fixed-size batch steps
    moving each hit centroid to the cumulative mean of every point ever
    assigned to it, then ``polish`` full Lloyd passes."""
    n = x.shape[0]
    batch = min(batch, n)
    cent = _kmeanspp_init(fork(gen), x, k)
    counts = torch.zeros(k, dtype=x.dtype, device=x.device)
    ones = torch.ones(batch, dtype=x.dtype, device=x.device)
    for _ in range(iters):
        xb = x[torch.randint(0, n, (batch,), generator=gen,
                             device=gen.device)]
        a = _assign(xb, cent)
        new_counts = counts + _segment_sum(ones, a, k)
        cent = torch.where(
            new_counts[:, None] > 0,
            (cent * counts[:, None] + _segment_sum(xb, a, k))
            / new_counts.clamp_min(1.0)[:, None],
            cent)
        counts = new_counts
    for _ in range(polish):
        cent = _lloyd_iter(x, cent)
    return cent, _assign(x, cent)


def fit_kmeans(gen: torch.Generator, x, k: int, *, iters: int = 15,
               batch: int = 1024):
    """Full Lloyd's when x is small, else mini-batch with 2x the iteration
    budget (each step sees batch points, not N) plus polish."""
    if x.shape[0] <= max(2 * batch, 4 * k):
        return kmeans(gen, x, k, iters)
    return kmeans_minibatch(gen, x, k, iters=2 * iters, batch=batch)


def sample_rows(gen: torch.Generator, x, cap: int | None):
    """Uniform row sample of at most ``cap`` rows, without replacement;
    x unchanged when it already fits."""
    n = x.shape[0]
    if cap is None or n <= cap:
        return x
    return x[torch.randperm(n, generator=gen, device=gen.device)[:cap]]


# ---------------------------------------------------------------------------
# PQ train / encode / decode / LUT
# ---------------------------------------------------------------------------

def _split(x, m):
    n, d = x.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by {m} subvectors")
    return x.reshape(n, m, d // m)


def _rotate(x, rot):
    return x if rot is None else x @ rot


def pq_train(gen: torch.Generator, x, cfg: PQConfig) -> PQCodebook:
    """x: [N, d] training vectors -> per-subspace codebooks, trained on at
    most ``cfg.train_sample`` sampled rows."""
    x = sample_rows(fork(gen), x, cfg.train_sample)
    xs = _split(x, cfg.n_subvec).transpose(0, 1)             # [M, S, ds]
    cents = [fit_kmeans(fork(gen), xs[m].contiguous(), cfg.n_codes,
                        iters=cfg.train_iters, batch=cfg.train_batch)[0]
             for m in range(cfg.n_subvec)]
    return PQCodebook(torch.stack(cents))


def opq_train(gen: torch.Generator, x, cfg: PQConfig) -> PQCodebook:
    """OPQ: learn an orthogonal rotation R minimizing quantization error by
    alternating (train PQ on x@R) with the Procrustes solve R = U V^T from
    svd(x^T rec), then train the final codebooks in the rotated space.
    The codebook carries ``rot``; scores are invariant because <q@R, r@R>
    == <q, r> for orthogonal R."""
    x = sample_rows(fork(gen), x, cfg.train_sample)
    rot = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
    for _ in range(cfg.opq_iters):
        xr = x @ rot
        cb = pq_train(fork(gen), xr, cfg)
        rec = pq_decode(cb, pq_encode(cb, xr))        # rot=None: rotated space
        u, _, vt = torch.linalg.svd(x.T @ rec, full_matrices=False)
        rot = u @ vt
    cb = pq_train(fork(gen), x @ rot, cfg)
    return PQCodebook(cb.centers, rot)


def pq_encode(cb: PQCodebook, x):
    """x: [N, d] -> codes [N, M] uint8: the nearest codeword per subspace,
    from ONE [N, d] @ [d, M*K] product against a block-diagonal layout of
    the codebooks (argmin needs only ||c||^2 - 2<x_s, c>)."""
    x = _rotate(x, cb.rot)
    m, k, ds = cb.centers.shape
    w = torch.zeros((m, ds, m, k), dtype=cb.centers.dtype,
                    device=cb.centers.device)
    ar = torch.arange(m, device=cb.centers.device)
    w[ar, :, ar, :] = cb.centers.transpose(1, 2)             # block-diagonal
    dots = x @ w.reshape(m * ds, m * k)                       # [N, M*K]
    d2 = (cb.centers * cb.centers).sum(-1).reshape(1, m * k) - 2.0 * dots
    return d2.reshape(-1, m, k).argmin(dim=-1).to(torch.uint8)


def pq_decode(cb: PQCodebook, codes):
    """codes: [N, M] -> reconstructed vectors [N, d]."""
    m = cb.centers.shape[0]
    ar = torch.arange(m, device=cb.centers.device)
    rec = cb.centers[ar[None, :], codes.long()]               # [N, M, ds]
    rec = rec.reshape(codes.shape[0], -1)
    return rec if cb.rot is None else rec @ cb.rot.T


def pq_lut(cb: PQCodebook, q):
    """q: [B, d] queries -> inner-product LUT [B, M, K] (in code space)."""
    qs = _split(_rotate(q, cb.rot), cb.centers.shape[0])     # [B, M, ds]
    return torch.einsum("bmd,mkd->bmk", qs, cb.centers)


def pq_search(cb: PQCodebook, codes, q, k: int):
    """Flat ADC scan of every code row for every query -> (scores [B, k],
    rows [B, k]); the shared-codes (Bc == 1) path of the LUT kernel."""
    lut = pq_lut(cb, q)
    scores = ops.pq_lut_scores(lut.contiguous(), codes[None].contiguous())
    top = torch.topk(scores, min(k, codes.shape[0]), dim=1)
    return top.values, top.indices
