"""Autoregressive click-prediction loss (Eq. 5) with sampled negatives.

L_auto = -sum_{t<L} log softmax(<theta_{t+1}, mu_t> vs negatives).
Negatives are drawn from the merged news set of the same batch (in-batch
sampling). ``click_loss`` is the conventional workflow's impression loss.
"""
from __future__ import annotations

import torch


def sample_negatives(gen: torch.Generator, m_cap: int, shape, n_neg: int):
    """Uniform negative positions into the merged set (slot 0, the pad,
    excluded): int64 [*shape, n_neg] on ``gen``'s device."""
    return torch.randint(1, m_cap, tuple(shape) + (n_neg,), generator=gen,
                         device=gen.device)


def ar_loss(mu, theta, hist_mask, emb_m, news_ids_m, neg_idx,
            hist_inv=None, n_valid=None):
    """mu: [B, L, d] user embeddings; theta: [B, L, d] dispatched news
    embeddings; hist_mask: [B, L]; emb_m: [M, d] merged-set embeddings;
    news_ids_m: [M]; neg_idx: [B, L-1, N] positions into the merged set.

    Position t uses mu[:, t] to score theta[:, t+1] against negatives.
    Returns (mean loss, metrics dict). ``n_valid`` (a data mesh: the valid
    predictions of every rank's users) replaces this call's own count as
    the loss's and the accuracy's denominator.
    """
    mu_t = mu[:, :-1]                         # [B, L-1, d]
    pos_emb = theta[:, 1:]
    valid = hist_mask[:, 1:] & hist_mask[:, :-1]

    pos_score = torch.einsum("bld,bld->bl", mu_t, pos_emb).float()
    neg_emb = emb_m[neg_idx]                  # [B, L-1, N, d]
    neg_score = torch.einsum("bld,blnd->bln", mu_t, neg_emb).float()

    # mask degenerate negatives: pad slots or accidental positives
    neg_ids = news_ids_m[neg_idx]             # [B, L-1, N]
    bad = neg_ids == 0
    if hist_inv is not None:
        pos_ids = news_ids_m[hist_inv[:, 1:]]
        bad = bad | (neg_ids == pos_ids[..., None])
    neg_score = neg_score.masked_fill(bad, -1e30)

    logits = torch.cat([pos_score[..., None], neg_score], dim=-1)
    logp = torch.log_softmax(logits, dim=-1)[..., 0]
    if n_valid is None:
        n_valid = valid.sum()
    n = n_valid.clamp_min(1)
    loss = -(logp * valid).sum() / n
    acc = ((logits.argmax(-1) == 0) & valid).sum() / n
    return loss, {"ar_acc": acc, "n_predictions": n_valid}


def click_loss(user_emb, cand_emb, labels, cand_mask):
    """Conventional impression loss: one user embedding scores C candidates.

    user_emb: [B, d]; cand_emb: [B, C, d]; labels: [B] index of the clicked
    candidate; cand_mask: [B, C]. Returns (mean loss, {"click_acc"}).
    """
    logits = torch.einsum("bd,bcd->bc", user_emb, cand_emb).float()
    logits = logits.masked_fill(~cand_mask, -1e30)
    logp = torch.log_softmax(logits, dim=-1)
    labels = labels.long()
    loss = -logp.gather(-1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"click_acc": acc}
