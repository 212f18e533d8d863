"""The port's flash attention forward against the JAX package's Pallas
kernel.

On the CPU ``ops.flash_attention`` takes the kernel's plain PyTorch
version, held here against the Pallas ``flash_attention_fwd`` run in
interpret mode (as tests/test_kernels.py runs it), ``o`` and ``lse``, on
the same numpy inputs. The CUDA kernel runs only on the card:
tests/test_torch_gpu.py holds it against the plain version there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_fwd as flash_pallas)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda, flash_attention_fwd_plain)

# tests/test_kernels.py's forward tolerances
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _inputs(B, Sq, Sk, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,dtype", [
    (1, 128, 128, 4, 4, 64, True, "float32"),      # MHA
    (1, 128, 128, 4, 4, 64, False, "bfloat16"),
    (2, 256, 256, 8, 2, 64, True, "bfloat16"),     # GQA 4:1
    (1, 128, 128, 8, 1, 32, False, "float32"),     # MQA
    (1, 64, 128, 4, 4, 32, True, "float32"),       # Sq != Sk: q_off = 64
    (1, 64, 128, 4, 4, 32, True, "bfloat16"),
])
def test_plain_flash_matches_pallas(B, Sq, Sk, Hq, Hkv, D, causal, dtype):
    q, k, v = _inputs(B, Sq, Sk, Hq, Hkv, D)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    o_j, lse_j = flash_pallas(jnp.asarray(q, jd), jnp.asarray(k, jd),
                              jnp.asarray(v, jd), causal=causal, block_q=64,
                              block_k=64, interpret=True)
    o_t, lse_t = flash_attention_fwd_plain(
        torch.tensor(q).to(td), torch.tensor(k).to(td),
        torch.tensor(v).to(td), causal)
    assert o_t.dtype == td and lse_t.dtype == torch.float32
    assert lse_t.shape == (B, Hq, Sq)
    err_o = np.abs(o_t.float().numpy() - np.asarray(o_j, np.float32)).max()
    err_lse = np.abs(lse_t.numpy() - np.asarray(lse_j)).max()
    assert err_o <= TOL[dtype], err_o
    assert err_lse <= TOL[dtype], err_lse


def test_ops_flash_attention_on_the_cpu_is_the_plain_version():
    q, k, v = (torch.tensor(a) for a in _inputs(2, 64, 64, 4, 2, 16))
    got = ops.flash_attention(q, k, v, causal=True)
    exp = flash_attention_fwd_plain(q, k, v, True)[0]
    assert torch.equal(got, exp)
    # the plain version is differentiable, so training on the CPU works
    q.requires_grad_()
    assert ops.flash_attention(q, k, v).grad_fn is not None


def test_causal_call_with_more_queries_than_keys_raises():
    q, k, v = (torch.tensor(a) for a in _inputs(1, 64, 32, 2, 2, 16))
    with pytest.raises(ValueError, match="Sq <= Sk"):
        ops.flash_attention(q, k, v, causal=True)
    assert ops.flash_attention(q, k, v, causal=False).shape == q.shape


def test_flash_routing_rule_matches_jax():
    for s in range(1, 1100):
        assert ops.flash_attention_supported(s) == \
            jax_ops.flash_attention_supported(s), s
    assert ops.FLASH_BLOCK == jax_ops.FLASH_BLOCK


def test_the_cuda_wrapper_refuses_a_cpu_tensor():
    q, k, v = (torch.tensor(a) for a in _inputs(1, 64, 64, 2, 2, 16))
    with pytest.raises(RuntimeError, match="cpu"):
        flash_attention_cuda(q, k, v, True)
    assert "flash_attention" in ops.launch_counts()
