"""The port's k-means stages against the JAX package's, with the JAX
draws injected.

The two packages draw from different generators, so a build of one
seed differs between them. Here every draw the port's k-means makes (the
seed index, the k-means++ picks, the mini-batch rows, the Lloyd seeding
permutation) is replaced by the JAX package's own draw for the same key,
and each stage is compared in turn: the k-means++ sampling weights, the
Lloyd update with dead-centroid reseeding, the mini-batch k-means and
full Lloyd's k-means. If they agree, the two builds differ only in the
streams their generators draw.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import pq as jpq  # noqa: E402
from repro_torch.serving import pq as tpq  # noqa: E402

CENT_TOL = 1e-5    # sums over a few hundred f32 rows in another order


class _Scripted:
    """Stands in for ``torch`` inside ``repro_torch.serving.pq``: its random
    draws return scripted values, in call order; everything else is
    torch. ``weights`` keeps what ``multinomial`` was asked to sample."""

    def __init__(self, *, randint=(), multinomial=(), randperm=()):
        self._randint = list(randint)
        self._multinomial = list(multinomial)
        self._randperm = list(randperm)
        self.weights = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def randint(self, low, high, size, **kw):
        if high == 2 ** 62:                       # pq.fork's child seed
            return torch.zeros(size, dtype=torch.long)
        out = self._randint.pop(0)
        assert tuple(out.shape) == tuple(size)
        return out

    def multinomial(self, weights, n, replacement, **kw):
        assert replacement
        self.weights.append(weights.clone())
        out = self._multinomial.pop(0)
        assert out.shape == (n,)
        return out

    def randperm(self, n, **kw):
        return self._randperm.pop(0)

    def drained(self):
        return not (self._randint or self._multinomial or self._randperm)


def _data(n=3000, d=8, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(24, d)) * 3
    x = centers[rng.integers(0, 24, n)] + rng.normal(size=(n, d))
    return x.astype(np.float32)


def _rows_of(x, cent):
    """Index in x of every row of cent (the JAX picks, recovered)."""
    eq = (np.asarray(cent)[:, None, :] == x[None, :, :]).all(-1)
    assert (eq.sum(1) == 1).all()
    return eq.argmax(1)


def _kpp_picks(key, x, k):
    """The JAX k-means++ init's draws for ``key``: the seed index, then one
    array of ``chunk`` picks per round."""
    picks = _rows_of(x, jpq._kmeanspp_init(key, jnp.asarray(x), k))
    chunk = -(-k // 16)
    rounds = -(-(k - 1) // chunk)
    rest = np.concatenate([picks[1:], np.zeros(chunk * rounds - (k - 1),
                                               np.int64)])
    return picks[0], rest.reshape(rounds, chunk)


def _d2_reference(x, chosen):
    """Squared distance of every row to its nearest chosen row (numpy)."""
    d2 = ((x[:, None, :].astype(np.float64) - x[chosen][None]) ** 2).sum(-1)
    return d2.min(1)


def test_kmeanspp_sampling_weights_match_the_jax_distribution(monkeypatch):
    x = _data()
    k = 40                              # chunk 3: 13 rounds of picks
    seed_idx, rounds = _kpp_picks(jax.random.PRNGKey(3), x, k)
    fake = _Scripted(randint=[torch.tensor([seed_idx])],
                     multinomial=[torch.as_tensor(r) for r in rounds])
    monkeypatch.setattr(tpq, "torch", fake)
    got = tpq._kmeanspp_init(torch.Generator(), torch.as_tensor(x), k)
    assert fake.drained()
    exp = jpq._kmeanspp_init(jax.random.PRNGKey(3), jnp.asarray(x), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    # the JAX draws are categorical(log(d2 + 1e-12)): the port's weights
    # must be the same distribution, d2 to the rows chosen so far
    chosen = [seed_idx]
    for w, r in zip(fake.weights, rounds):
        ref = _d2_reference(x, chosen) + 1e-12
        np.testing.assert_allclose(w.double().numpy() / float(w.sum()),
                                   ref / ref.sum(), rtol=1e-3, atol=1e-9)
        chosen += list(r)


def test_lloyd_iter_matches_jax_with_dead_centroids():
    x = _data(seed=1)
    rng = np.random.default_rng(1)
    cent = x[rng.choice(len(x), 32, replace=False)].copy()
    cent[:3] += 1e3                     # three centroids no point picks
    exp = np.asarray(jpq._lloyd_iter(jnp.asarray(x), jnp.asarray(cent)))
    got = tpq._lloyd_iter(torch.as_tensor(x), torch.as_tensor(cent)).numpy()
    np.testing.assert_allclose(got, exp, rtol=CENT_TOL, atol=CENT_TOL)
    assert np.abs(got[:3]).max() < 100     # the dead ones were re-planted


def test_kmeans_minibatch_matches_jax_with_its_draws(monkeypatch):
    x = _data(seed=2)
    k, iters, batch = 32, 12, 512
    key = jax.random.PRNGKey(7)
    kpp, kmb = jax.random.split(key)
    seed_idx, rounds = _kpp_picks(kpp, x, k)
    rows = [np.array(jax.random.randint(kk, (batch,), 0, len(x)))
            for kk in jax.random.split(kmb, iters)]
    fake = _Scripted(
        randint=[torch.tensor([seed_idx])] + [torch.as_tensor(r)
                                              for r in rows],
        multinomial=[torch.as_tensor(r) for r in rounds])
    monkeypatch.setattr(tpq, "torch", fake)
    got, got_a = tpq.kmeans_minibatch(torch.Generator(), torch.as_tensor(x),
                                      k, iters=iters, batch=batch)
    assert fake.drained()
    exp, exp_a = jpq.kmeans_minibatch(key, jnp.asarray(x), k, iters=iters,
                                      batch=batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=CENT_TOL,
                               atol=CENT_TOL)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(exp_a))


def test_kmeans_matches_jax_with_its_seeding(monkeypatch):
    x = _data(n=600, seed=4)
    k, iters = 16, 10
    key = jax.random.PRNGKey(9)
    idx = np.array(jax.random.choice(key, len(x), (k,), replace=False))
    perm = np.concatenate([idx, np.setdiff1d(np.arange(len(x)), idx)])
    monkeypatch.setattr(tpq, "torch", _Scripted(
        randperm=[torch.as_tensor(perm)]))
    got, got_a = tpq.kmeans(torch.Generator(), torch.as_tensor(x), k, iters)
    exp, exp_a = jpq.kmeans(key, jnp.asarray(x), k, iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=CENT_TOL,
                               atol=CENT_TOL)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(exp_a))
