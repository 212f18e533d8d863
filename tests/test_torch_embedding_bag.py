"""The port's EmbeddingBag against the JAX package.

On the CPU ``ops.embedding_bag`` takes the kernel's plain PyTorch
version, held here against the Pallas ``embedding_bag`` run in interpret
mode (as tests/test_kernels.py runs it) and against ``kernels/ref.py``
on the same numpy inputs; ``nn.embedding_bag`` and its flat layout
against ``repro.nn``. The CUDA kernel runs only on the card:
tests/test_torch_gpu.py holds it against the plain version there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import nn as jax_nn  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.embedding_bag import embedding_bag as ebag_pallas  # noqa: E402,E501
from repro_torch import nn  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    embedding_bag_cuda, embedding_bag_plain, take_rows)

# tests/test_kernels.py's tolerances: f32 2e-4; bf16 2e-2 of the largest
# |out| (the Pallas kernel rounds its bf16 sum at every nnz step, the
# port once at the end)
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
TOL_NN = 1e-6


def _inputs(V, d, B, F, nnz, seed=0, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, d)).astype(np.float32)
    idx = rng.integers(lo, V if hi is None else hi,
                       size=(B, F, nnz)).astype(np.int32)
    w = rng.uniform(size=(B, F, nnz)).astype(np.float32)
    return table, idx, w


def _same_nan(got, exp):
    got, exp = np.asarray(got, np.float32), np.asarray(exp, np.float32)
    assert np.array_equal(np.isnan(got), np.isnan(exp))
    return got, exp


@pytest.mark.parametrize("V,d,B,F,nnz", [
    (100, 32, 8, 5, 3), (50, 16, 4, 1, 1), (1000, 64, 16, 26, 1),
    (64, 128, 2, 3, 7),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weighted", [True, False])
def test_plain_embedding_bag_matches_pallas(V, d, B, F, nnz, dtype,
                                            weighted):
    table, idx, w = _inputs(V, d, B, F, nnz)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    wj = jnp.asarray(w) if weighted else None
    exp = ebag_pallas(jnp.asarray(table, jd), jnp.asarray(idx), wj,
                      interpret=True)
    got = ops.embedding_bag(torch.tensor(table).to(td), torch.tensor(idx),
                            torch.tensor(w) if weighted else None)
    assert got.dtype == td and got.shape == (B, F, d)
    err = np.abs(got.float().numpy() - np.asarray(exp, np.float32)).max()
    scale = 1.0 if dtype == "float32" else float(np.abs(
        np.asarray(exp, np.float32)).max())
    assert err <= TOL[dtype] * scale, err


@pytest.mark.parametrize("weighted", [True, False])
def test_out_of_range_and_negative_indices_follow_the_reference(weighted):
    V = 4
    table = np.arange(V * 3, dtype=np.float32).reshape(V, 3) + 1
    # bag by bag: in range, -1 (wraps), V (NaN), -V-1 (NaN), -V (row 0),
    # an out-of-range index beside a valid one (NaN), one with weight 0
    idx = np.array([[[0, 3], [-1, 2], [V, 1], [-V - 1, 0], [-V, -2],
                     [1, V + 7]]], np.int32)
    w = np.ones(idx.shape, np.float32)
    w[0, 5, 1] = 0.0                         # weight 0 does not hide it
    wj = jnp.asarray(w) if weighted else None
    exp = ref.embedding_bag(jnp.asarray(table), jnp.asarray(idx), wj)
    got = embedding_bag_plain(torch.tensor(table), torch.tensor(idx),
                              torch.tensor(w) if weighted else None)
    got, exp = _same_nan(got, exp)
    assert np.isnan(got[0, [2, 3, 5]]).all()
    assert not np.isnan(got[0, [0, 1, 4]]).any()
    fin = ~np.isnan(exp)
    assert np.array_equal(got[fin], exp[fin])


def test_take_rows_is_jnp_take():
    table, _, _ = _inputs(6, 4, 1, 1, 1)
    ids = np.array([[0, 5, -1, -6, 6, -7, 3]], np.int32)
    exp = jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0)
    got, exp = _same_nan(take_rows(torch.tensor(table), torch.tensor(ids)),
                         exp)
    fin = ~np.isnan(exp)
    assert np.array_equal(got[fin], exp[fin])


def test_ops_embedding_bag_on_the_cpu_is_the_plain_version():
    table, idx, w = (torch.tensor(a) for a in _inputs(30, 8, 4, 3, 2))
    assert torch.equal(ops.embedding_bag(table, idx, w),
                       embedding_bag_plain(table, idx, w))
    # plain is differentiable, so the CPU path keeps its gradient
    table.requires_grad_()
    assert ops.embedding_bag(table, idx, w).grad_fn is not None


def test_cuda_wrapper_refuses_a_cpu_tensor():
    table, idx, w = (torch.tensor(a) for a in _inputs(30, 8, 4, 3, 2))
    with pytest.raises(RuntimeError, match="CUDA kernel"):
        embedding_bag_cuda(table, idx, w)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [True, False])
def test_nn_embedding_bag_matches_jax(mode, weighted):
    table, idx, w = _inputs(40, 8, 5, 3, 4, seed=1)
    w[:, :, -1] = 0.0                        # padded slots
    wj = jnp.asarray(w) if weighted else None
    exp = jax_nn.embedding_bag(jnp.asarray(table), jnp.asarray(idx), wj,
                               mode=mode)
    got = nn.embedding_bag(torch.tensor(table), torch.tensor(idx),
                           torch.tensor(w) if weighted else None, mode=mode)
    assert got.shape == exp.shape
    assert np.abs(got.numpy() - np.asarray(exp)).max() <= TOL_NN
    with pytest.raises(ValueError):
        nn.embedding_bag(torch.tensor(table), torch.tensor(idx), mode="min")


@pytest.mark.parametrize("weighted", [True, False])
def test_embedding_bag_flat_matches_jax(weighted):
    rng = np.random.default_rng(2)
    table = rng.normal(size=(30, 6)).astype(np.float32)
    ids = rng.integers(0, 30, 20).astype(np.int32)
    # sorted segments with an empty one (3), and one id past the end (5)
    seg = np.array([0] * 4 + [1] * 6 + [2] * 5 + [4] * 4 + [5],
                   np.int32)
    w = rng.uniform(size=20).astype(np.float32)
    wj = jnp.asarray(w) if weighted else None
    exp = jax_nn.embedding_bag_flat(jnp.asarray(table), jnp.asarray(ids),
                                    jnp.asarray(seg), 5, wj)
    got = nn.embedding_bag_flat(torch.tensor(table), torch.tensor(ids),
                                torch.tensor(seg), 5,
                                torch.tensor(w) if weighted else None)
    assert got.shape == (5, 6)
    assert np.abs(got.numpy() - np.asarray(exp)).max() <= TOL_NN


def test_offsets_to_fixed_matches_jax():
    rng = np.random.default_rng(3)
    indices = rng.integers(0, 50, 17).astype(np.int32)
    offsets = np.array([0, 3, 3, 9, 10], np.int64)   # an empty bag, a long one
    for nnz, pad in ((4, 0), (2, 7)):
        exp = jax_nn.offsets_to_fixed(indices, offsets, nnz, pad)
        got = nn.offsets_to_fixed(indices, offsets, nnz, pad)
        for a, b in zip(got, exp):
            assert a.dtype == b.dtype and np.array_equal(a, b)
