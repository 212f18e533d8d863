"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port's ``ops`` take each kernel's plain PyTorch version,
which is held here against the Pallas kernel run in interpret mode (as
tests/test_kernels.py runs it), on the same numpy inputs. The CUDA
kernels themselves run only on the card: tests/test_torch_gpu.py holds
them against the plain versions there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.bus_attention import (  # noqa: E402
    bus_attention as bus_pallas)
from repro.kernels.pq_scoring import pq_lut_scores as pq_pallas  # noqa: E402
from repro.kernels.ref import pq_lut_scores as pq_ref  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.bus_attention import (  # noqa: E402
    bus_attention_cuda, bus_attention_plain)
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    embedding_bag_bwd_cuda, embedding_bag_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_fwd_plain)
from repro_torch.kernels.pq_scoring import (  # noqa: E402
    pq_lut_scores_cuda, pq_lut_scores_plain)

BUS_TOL_F32 = 2e-4     # tests/test_kernels.py's f32 forward tolerance
BUS_TOL_BF16 = 2e-2    # ... and its bf16 one
PQ_TOL = 1e-5          # sums of M f32 table entries in another order


def _bus_inputs(M, K, S, H, D, *, seed=0, masked_segments=()):
    rng = np.random.default_rng(seed)
    Sk = S + K
    q = rng.normal(size=(M, K, S, H, D)).astype(np.float32)
    k = rng.normal(size=(M, K, Sk, H, D)).astype(np.float32)
    v = rng.normal(size=(M, K, Sk, H, D)).astype(np.float32)
    mask = rng.random((M, K, Sk)) < 0.75
    mask[:, :, 0] = True                      # CLS always valid
    for m, kk in masked_segments:
        mask[m, kk] = False                   # a segment with no valid key
    return q, k, v, mask


def _pallas_bus(q, k, v, mask, dtype=jnp.float32):
    M = q.shape[0]
    block_m = M if M % 4 else 4               # odd M: one block of all rows
    out = bus_pallas(jnp.asarray(q, dtype), jnp.asarray(k, dtype),
                     jnp.asarray(v, dtype), jnp.asarray(mask),
                     block_m=block_m, interpret=True)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("M,K,S,H,D", [
    (8, 3, 32, 4, 64),     # the paper's per-head shape
    (5, 3, 16, 2, 32),     # odd M
    (4, 5, 8, 1, 16),      # over-partitioned news
])
def test_bus_attention_plain_matches_pallas(M, K, S, H, D):
    q, k, v, mask = _bus_inputs(M, K, S, H, D, masked_segments=[(1, 1)])
    exp = _pallas_bus(q, k, v, mask)
    got = bus_attention_plain(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), exp, rtol=BUS_TOL_F32,
                               atol=BUS_TOL_F32)


def test_bus_attention_all_masked_segment_is_uniform_mean_over_sk():
    """No valid key: the -1e30 fill averages v over exactly Sk keys."""
    M, K, S, H, D = 3, 3, 8, 2, 16
    q, k, v, mask = _bus_inputs(M, K, S, H, D, masked_segments=[(2, 0)])
    got = bus_attention_plain(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), torch.tensor(mask)).numpy()
    uniform = v[2, 0].mean(axis=0)                        # [H, D] over Sk
    for i in range(S):
        np.testing.assert_allclose(got[2, 0, i], uniform, rtol=BUS_TOL_F32,
                                   atol=BUS_TOL_F32)
    np.testing.assert_allclose(_pallas_bus(q, k, v, mask)[2, 0], got[2, 0],
                               rtol=BUS_TOL_F32, atol=BUS_TOL_F32)


def test_bus_attention_plain_matches_pallas_bf16():
    q, k, v, mask = _bus_inputs(4, 3, 16, 2, 32, seed=3)
    exp = _pallas_bus(q, k, v, mask, dtype=jnp.bfloat16)
    bf = [torch.tensor(x).to(torch.bfloat16) for x in (q, k, v)]
    got = bus_attention_plain(*bf, torch.tensor(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), exp, rtol=BUS_TOL_BF16,
                               atol=BUS_TOL_BF16)


def _pq_inputs(B, M, K, N, Bc, Bv, code_dtype, seed=0):
    rng = np.random.default_rng(seed)
    lut = rng.normal(size=(B, M, K)).astype(np.float32)
    codes = rng.integers(0, K, (Bc, N, M)).astype(code_dtype)
    valid = None if Bv is None else rng.random((Bv, N)) < 0.7
    return lut, codes, valid


@pytest.mark.parametrize("code_dtype,Bc,Bv", [
    (np.uint8, 4, 4),      # per-query lists (the IVF path), per-query valid
    (np.uint8, 1, 1),      # one shared scan, shared valid
    (np.int32, 4, 1),
    (np.int32, 1, 4),
    (np.uint8, 4, None),   # no validity mask
])
def test_pq_lut_scores_plain_matches_pallas(code_dtype, Bc, Bv):
    B, M, K, N = 4, 8, 32, 300                 # N not a multiple of block_n
    lut, codes, valid = _pq_inputs(B, M, K, N, Bc, Bv, code_dtype)
    exp = np.asarray(pq_pallas(
        jnp.asarray(lut), jnp.asarray(codes),
        None if valid is None else jnp.asarray(valid), block_n=128,
        interpret=True))
    got = pq_lut_scores_plain(
        torch.tensor(lut), torch.tensor(codes),
        None if valid is None else torch.tensor(valid)).numpy()
    np.testing.assert_allclose(got, exp, rtol=PQ_TOL, atol=PQ_TOL)
    if valid is not None:
        invalid = np.broadcast_to(~valid, (B, N))
        assert np.isneginf(got[invalid]).all()
        assert np.isfinite(got[~invalid]).all()


@pytest.mark.parametrize("code_dtype,lo,hi", [
    (np.uint8, 0, 20),      # codes at and past K read against a K=16 table
    (np.int32, -20, 20),    # negative codes count from the end, as numpy's
])
def test_pq_lut_scores_plain_out_of_range_codes_match_reference(
        code_dtype, lo, hi):
    """A code outside the table scores NaN, as the JAX reference gather
    (kernels/ref.py) does; invalid slots stay -inf."""
    B, M, K, N = 3, 4, 16, 50
    rng = np.random.default_rng(4)
    lut = rng.normal(size=(B, M, K)).astype(np.float32)
    codes = rng.integers(lo, hi, (B, N, M)).astype(code_dtype)
    valid = rng.random((B, N)) < 0.7
    exp = np.asarray(pq_ref(jnp.asarray(lut), jnp.asarray(codes),
                            jnp.asarray(valid)))
    got = pq_lut_scores_plain(torch.tensor(lut), torch.tensor(codes),
                              torch.tensor(valid)).numpy()
    assert np.isnan(got).any() and np.isfinite(got).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    np.testing.assert_allclose(got, exp, rtol=PQ_TOL, atol=PQ_TOL)


def test_ops_take_the_plain_version_for_cpu_tensors():
    q, k, v, mask = _bus_inputs(2, 3, 8, 2, 16)
    t = [torch.tensor(x) for x in (q, k, v, mask)]
    lut, codes, valid = _pq_inputs(2, 8, 32, 40, 2, 2, np.uint8)
    p = [torch.tensor(x) for x in (lut, codes, valid)]
    ops.reset_launch_counts()
    assert torch.equal(ops.bus_attention(*t), bus_attention_plain(*t))
    assert torch.equal(ops.pq_lut_scores(*p), pq_lut_scores_plain(*p))
    qf, kf, vf = t[0][:, 0], t[1][:, 0, :8], t[2][:, 0, :8]   # [B, S, H, D]
    assert torch.equal(ops.flash_attention(qf, kf, vf),
                       flash_attention_fwd_plain(qf, kf, vf, True)[0])
    table, idx = t[0].reshape(-1, 16), torch.tensor([[[0, -1], [3, 5]]],
                                                    dtype=torch.int32)
    assert torch.equal(ops.embedding_bag(table, idx),
                       embedding_bag_plain(table, idx))
    tg = table.clone().requires_grad_()            # its plain backward too
    ops.embedding_bag(tg, idx).sum().backward()
    assert float(tg.grad.sum()) == 4 * table.shape[1]
    assert ops.launch_counts() == {"bus_attention": 0,
                                   "bus_attention_bwd": 0,
                                   "bus_attention_simt": 0,
                                   "bus_attention_bwd_simt": 0,
                                   "pq_lut_scores": 0,
                                   "pq_lut_scores_general": 0,
                                   "flash_attention": 0,
                                   "flash_attention_wgmma": 0,
                                   "flash_attention_tf32": 0,
                                   "flash_attention_bwd_dq": 0,
                                   "flash_attention_bwd_dkv": 0,
                                   "flash_attention_bwd_dq_wgmma": 0,
                                   "flash_attention_bwd_dkv_wgmma": 0,
                                   "flash_attention_bwd_dq_tf32": 0,
                                   "flash_attention_bwd_dkv_tf32": 0,
                                   "embedding_bag": 0,
                                   "embedding_bag_bwd": 0}


def test_cuda_wrappers_refuse_cpu_tensors():
    q, k, v, mask = (torch.tensor(x) for x in _bus_inputs(2, 3, 8, 2, 16))
    with pytest.raises(RuntimeError, match="CUDA kernel"):
        bus_attention_cuda(q, k, v, mask)
    lut, codes, valid = _pq_inputs(2, 8, 32, 40, 2, 2, np.uint8)
    with pytest.raises(RuntimeError, match="CUDA kernel"):
        pq_lut_scores_cuda(torch.tensor(lut), torch.tensor(codes))
    with pytest.raises(RuntimeError, match="CUDA kernel"):
        embedding_bag_bwd_cuda(torch.zeros(2, 3, 4),
                               torch.zeros(2, 3, 1, dtype=torch.int32), None,
                               10)


def test_kernels_refuse_a_device_that_is_not_sm90(monkeypatch):
    class FakeCudaTensor:
        device = torch.device("cuda", 0)

    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (8, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "an sm_80 card")
    with pytest.raises(RuntimeError, match="sm_90a"):
        _build.check_device(FakeCudaTensor())


def test_missing_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp_ext
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_library_name_follows_the_source_hash(tmp_path):
    """An edited source builds a new library; an unchanged one reuses its
    build."""
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    kern = _build.CudaKernel("k", "k.cu", {})
    kern.source = src
    first = kern.library_path()
    assert kern.library_path() == first
    src.write_text("// v2\n")
    assert kern.library_path() != first
    assert first.parent == _build.BUILD_DIR
