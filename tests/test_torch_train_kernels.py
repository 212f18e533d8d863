"""The port's differentiable bus attention and BusLM encoder against the
JAX package's gradients.

On the CPU the port's ``ops.bus_attention`` is the autograd Function with
the plain forward and the plain backward formula; it is held here against
``jax.grad`` through the JAX package's custom VJP, whose backward is the
Pallas kernel run in interpret mode (as tests/test_kernels.py runs it).
The CUDA backward kernel runs only on the card (tests/test_torch_gpu.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.core.plm import init_plm as jinit_plm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.bus_attention import (  # noqa: E402
    bus_attention_bwd as jbus_bwd)
from repro_torch import core  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.bus_attention import (  # noqa: E402
    bus_attention_bwd_plain)
from repro_torch.optim.adam import leaves  # noqa: E402

GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # tests/test_kernels.py's
BUSLM_GRAD_TOL = 1e-4   # test_buslm_grad_parity_pallas_vs_xla's tolerance
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bus_inputs(M, K, S, H, D, seed=8):
    rng = np.random.default_rng(seed)
    Sk = S + K
    q = rng.normal(size=(M, K, S, H, D)).astype(np.float32)
    k = rng.normal(size=(M, K, Sk, H, D)).astype(np.float32)
    v = rng.normal(size=(M, K, Sk, H, D)).astype(np.float32)
    mask = rng.random((M, K, Sk)) < 0.75
    mask[:, :, 0] = True                  # CLS always valid
    mask[:, -1, :] = False                # one fully padded segment
    g = rng.normal(size=(M, K, S, H, D)).astype(np.float32)
    return q, k, v, mask, g


def _as_f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("M,K,S,H,D", [
    (8, 3, 32, 4, 64),     # the paper's per-head shape
    (5, 3, 8, 2, 16),      # odd merged-set size, S=8 (the smallest bucket)
    (12, 2, 16, 2, 32),    # odd multiple of the TPU block
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bus_attention_grads_match_jax_kernel(M, K, S, H, D, dtype):
    q, k, v, mask, g = _bus_inputs(M, K, S, H, D)
    jd = jnp.dtype(dtype)

    def jloss(q, k, v):
        o = jops.bus_attention(q, k, v, jnp.asarray(mask), block_m=8)
        return (o.astype(jnp.float32) * jnp.asarray(g)).sum()

    exp = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jd) for x in (q, k, v)))

    td = TORCH_DTYPE[dtype]
    tq, tk, tv = (torch.tensor(x).to(td).requires_grad_() for x in (q, k, v))
    o = ops.bus_attention(tq, tk, tv, torch.tensor(mask))
    assert o.grad_fn is not None
    (o.float() * torch.tensor(g)).sum().backward()
    for name, t, e in zip(("dq", "dk", "dv"), (tq, tk, tv), exp):
        assert t.grad.dtype == td, name
        err = np.abs(t.grad.float().numpy() - _as_f32(e)).max()
        assert err <= GRAD_TOL[dtype], f"{name} max-abs {err}"


def test_bus_attention_bwd_plain_matches_the_pallas_bwd_kernel():
    """The plain backward against the raw Pallas backward kernel; dv is
    nonzero on the masked keys of the fully padded segment (uniform p)
    and dq/dk are zero there."""
    q, k, v, mask, g = _bus_inputs(4, 3, 8, 2, 16, seed=3)
    exp = jbus_bwd(*(jnp.asarray(x) for x in (q, k, v, mask, g)),
                   block_m=4, interpret=True)
    got = bus_attention_bwd_plain(*(torch.tensor(x)
                                    for x in (q, k, v, mask, g)))
    for a, b in zip(got, exp):
        np.testing.assert_allclose(a.numpy(), _as_f32(b),
                                   rtol=GRAD_TOL["float32"],
                                   atol=GRAD_TOL["float32"])
    dq, dk, dv = (t.numpy() for t in got)
    assert np.abs(dv[:, -1]).max() > 0.1
    assert np.abs(dq[:, -1]).max() == 0 and np.abs(dk[:, -1]).max() == 0


def _buslm_setup():
    kw = dict(vocab=300, n_layers=2, d_model=64, n_heads=4, d_ff=128,
              n_segments=3, seg_len=16, news_dim=32)
    jcfg, tcfg = jcore.PLMConfig(**kw), core.PLMConfig(**kw)
    jparams = jax.tree.map(np.asarray, jinit_plm(jax.random.PRNGKey(11),
                                                 jcfg))
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 300, (8, 3, 16)).astype(np.int32)
    toks[0, -1] = 0                        # a fully padded segment
    return jcfg, tcfg, jparams, toks


@pytest.mark.parametrize("remat", [False, True])
def test_buslm_grads_match_jax(remat):
    """Gradients of sum(encode**2) against jax.grad of the XLA encoder,
    with and without per-layer recompute."""
    jcfg, tcfg, jparams, toks = _buslm_setup()
    tcfg = dataclasses.replace(tcfg, remat=remat)

    def jloss(p):
        return (jcore.buslm_encode(p, jcfg, toks, impl="xla") ** 2).sum()

    exp = params_from_jax(jax.tree.map(np.asarray, jax.grad(jloss)(jparams)),
                          device="cpu")
    tparams = params_from_jax(jparams, device="cpu")
    flat = [p.requires_grad_() for _, p in leaves(tparams)]
    loss = (core.buslm_encode(tparams, tcfg, torch.tensor(toks)) ** 2).sum()
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    n = 0
    for (path, e), gr in zip(leaves(exp), grads):
        if gr is None:           # unused leaf (freq_emb: no freq passed)
            assert float(e.abs().max()) == 0.0, path
            continue
        err = float((gr - e).abs().max())
        assert err <= BUSLM_GRAD_TOL, f"{path}: {err}"
        n += 1
    assert n >= 30
