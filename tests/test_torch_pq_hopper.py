"""The PQ LUT scan's routes and the tiled scan's work split
(``csrc/pq_scoring.cu``), modelled on the CPU and held against the plain
version and the JAX package's Pallas kernel; and the helper that gives
the IVF-PQ scan's shape at a corpus size, held against the JAX package's
capacity buckets and its launcher's nlist rule.

The tiled scan splits a scan into units of (query group, tile of
``TILE_N`` candidates) and hands each block of a persistent grid a
contiguous range of units; a thread scores ``PER_THREAD`` consecutive
candidates of a unit against every query of the group, in float4 stores
when the vector width is 4 and one by one when it is 1. The model below
walks the same split, thread by thread, sums each candidate's table
entries in the kernel's order and flags a code past K by its byte's high
bits, as the kernel does. It checks that every output slot is written
exactly once, at any grid size, and that the result is plain's. The CUDA
kernels themselves run only on the card (``tests/test_torch_gpu.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.launch.serve as jax_serve  # noqa: E402
from repro.kernels.pq_scoring import pq_lut_scores as pq_pallas  # noqa: E402
from repro.serving.index import _next_cap as jax_next_cap  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pq_scoring as pq_mod  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402

PQ_TOL = 1e-5      # chip_smoke.py's TOL_PQ: f32 sums in another order


def _inputs(B, M, K, N, Bc, Bv, code_dtype, seed=0, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    lut = rng.normal(size=(B, M, K)).astype(np.float32)
    codes = rng.integers(lo, K if hi is None else hi,
                         (Bc, N, M)).astype(code_dtype)
    valid = None if Bv is None else rng.random((Bv, N)) < 0.7
    return lut, codes, valid


def _table_entry(row, c, K):
    """The kernels' lookup of code c (numpy-style: negative from the end,
    NaN outside [-K, K))."""
    c = c + K if c < 0 else c
    return row[c] if 0 <= c < K else np.float32(np.nan)


def _unit_range(block, grid, units):
    """The units block ``block`` of a ``grid``-block launch walks, as the
    kernel splits them: units // grid each, one more for the first
    units % grid blocks."""
    share, extra = divmod(units, grid)
    first = block * share + min(block, extra)
    return range(first, first + share + (block < extra))


def _model_tiled(lut, codes, valid, grid, qg=None):
    """The tiled scan, unit by unit and thread by thread; ``qg`` replaces
    the plan's queries a group (the kernel takes any)."""
    B, M, K = lut.shape
    Bc, N, _ = codes.shape
    Bv = 1 if valid is None else valid.shape[0]
    plan = pq_mod.tiled_plan(B, M, K, N, Bc, None if valid is None else 0)
    if qg is not None:
        groups = -(-B // qg)
        plan = {**plan, "qg": qg, "groups": groups,
                "units": groups * plan["tiles"]}
    if N % 4:
        assert plan["vec"] == 1
    out = np.full((B, N), np.float32(7.0))
    writes = np.zeros((B, N), np.int64)
    high = ~(K - 1) & 0xff              # bits a code >= K has
    for block in range(grid):
        for u in _unit_range(block, grid, plan["units"]):
            group, tile = divmod(u, plan["tiles"])
            b0 = group * plan["qg"]
            queries = range(b0, min(B, b0 + plan["qg"]))
            assert Bc == 1 or len(queries) == 1
            for tid in range(pq_mod.TILE_THREADS):
                n0 = tile * pq_mod.TILE_N + pq_mod.PER_THREAD * tid
                if n0 >= N:
                    continue
                cands = range(n0, min(N, n0 + pq_mod.PER_THREAD))
                if plan["vec"] == 4:
                    assert len(cands) == 4      # whole float4 stores
                for b in queries:
                    row = codes[0 if Bc == 1 else b]
                    for n in cands:
                        acc = np.float32(0.0)
                        for m in range(M):
                            c = int(row[n, m])
                            acc = np.float32(acc + lut[b, m, c & (K - 1)])
                        if any(int(c) & high for c in row[n]):
                            acc = np.float32(np.nan)
                        if valid is not None and \
                                not valid[0 if Bv == 1 else b, n]:
                            acc = np.float32(-np.inf)
                        out[b, n] = acc
                        writes[b, n] += 1
    assert (writes == 1).all()
    return out


def _model_general(lut, codes, valid):
    """The general scan: one thread a (query, candidate)."""
    B, M, K = lut.shape
    Bc, N, _ = codes.shape
    out = np.empty((B, N), np.float32)
    for b in range(B):
        row = codes[0 if Bc == 1 else b]
        for n in range(N):
            acc = np.float32(0.0)
            for m in range(M):
                acc = np.float32(acc + _table_entry(lut[b, m],
                                                    int(row[n, m]), K))
            if valid is not None and not valid[0 if valid.shape[0] == 1
                                               else b, n]:
                acc = np.float32(-np.inf)
            out[b, n] = acc
    return out


def _hold(got, exp):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(exp))
    np.testing.assert_allclose(got, exp, rtol=PQ_TOL, atol=PQ_TOL)


def _pallas(lut, codes, valid):
    return np.asarray(pq_pallas(
        jnp.asarray(lut), jnp.asarray(codes),
        None if valid is None else jnp.asarray(valid), block_n=128,
        interpret=True))


@pytest.mark.parametrize("Bc,Bv", [(3, 3), (3, 1), (1, 3), (1, 1),
                                   (3, None), (1, None)])
@pytest.mark.parametrize("N,grid", [(2500, 2), (2500, 5), (2052, 3)])
def test_tiled_split_model_matches_plain_and_pallas(Bc, Bv, N, grid):
    # N = 2500: a ragged last tile and N % 4 != 0 (scalar width); 2052: a
    # ragged tile of whole float4 groups. grid = 5 > the units of a shared
    # scan: blocks with no unit
    B, M, K = 3, 8, 32
    lut, codes, valid = _inputs(B, M, K, N, Bc, Bv, np.uint8, seed=N + grid)
    assert pq_mod.pq_route(M, K, torch.uint8, 0) == "pq_lut_scores"
    got = _model_tiled(lut, codes, valid, grid)
    exp = pq_mod.pq_lut_scores_plain(
        torch.tensor(lut), torch.tensor(codes),
        None if valid is None else torch.tensor(valid)).numpy()
    _hold(got, exp)
    _hold(got, _pallas(lut, codes, valid))


def test_tiled_split_model_groups_queries_on_shared_codes():
    # K=256: 8 KB tables, at most 6 queries a group, so 8 queries are 2
    # groups of 6 and 2 (the plan keeps 1 a group at this size, to fill
    # the card; the kernel takes any group)
    B, M, K, N = 8, 8, 256, 1030
    lut, codes, valid = _inputs(B, M, K, N, 1, B, np.uint8, seed=5)
    assert pq_mod.tiled_plan(B, M, K, N, 1, 0)["qg"] == 1
    got = _model_tiled(lut, codes, valid, grid=3, qg=6)
    _hold(got, pq_mod.pq_lut_scores_plain(
        torch.tensor(lut), torch.tensor(codes), torch.tensor(valid)).numpy())


@pytest.mark.parametrize("K,hi", [(32, 40), (16, 200)])
def test_tiled_split_model_scores_codes_past_k_nan(K, hi):
    B, M, N = 2, 16, 1100
    lut, codes, valid = _inputs(B, M, K, N, B, B, np.uint8, seed=K, hi=hi)
    got = _model_tiled(lut, codes, valid, grid=2)
    exp = pq_mod.pq_lut_scores_plain(
        torch.tensor(lut), torch.tensor(codes), torch.tensor(valid)).numpy()
    assert np.isnan(exp).any()
    _hold(got, exp)


@pytest.mark.parametrize("Bc,Bv", [(3, 3), (1, 3), (3, 1), (1, None)])
@pytest.mark.parametrize("lo", [0, -32])
def test_general_scan_model_with_int32_codes_matches_plain_and_pallas(
        Bc, Bv, lo):
    # int32 codes take the general scan; negative ones count from the end
    # (plain's and the JAX reference's rule; the Pallas kernel is held on
    # codes in [0, K), as tests/test_torch_kernels.py holds it)
    B, M, K, N = 3, 8, 32, 301
    lut, codes, valid = _inputs(B, M, K, N, Bc, Bv, np.int32, seed=Bc,
                                lo=lo)
    assert pq_mod.pq_route(M, K, torch.int32, 0) == "pq_lut_scores_general"
    got = _model_general(lut, codes, valid)
    exp = pq_mod.pq_lut_scores_plain(
        torch.tensor(lut), torch.tensor(codes),
        None if valid is None else torch.tensor(valid)).numpy()
    _hold(got, exp)
    if lo == 0:
        _hold(got, _pallas(lut, codes, valid))


@pytest.mark.parametrize("M,K,dtype,addr,route", [
    (8, 32, torch.uint8, 0, "pq_lut_scores"),            # every config
    (16, 256, torch.uint8, 4096, "pq_lut_scores"),
    (8, 1, torch.uint8, 16, "pq_lut_scores"),
    (8, 32, torch.int32, 0, "pq_lut_scores_general"),   # int32 codes
    (8, 32, torch.uint8, 8, "pq_lut_scores_general"),   # base off 16 B
    (5, 32, torch.uint8, 0, "pq_lut_scores_general"),   # M % 8 != 0
    (24, 32, torch.uint8, 0, "pq_lut_scores_general"),  # M not 8 or 16
    (8, 20, torch.uint8, 0, "pq_lut_scores_general"),   # K no power of 2
    (16, 1024, torch.int32, 0, "pq_lut_scores_general"),  # a 64 KB table
])
def test_pq_route(M, K, dtype, addr, route):
    assert pq_mod.pq_route(M, K, dtype, addr) == route
    assert route in ops.KERNELS and route in pq_mod.ROUTES


@pytest.mark.parametrize("B,N,Bc,valid_addr,plan", [
    (16, 524288, 16, 0, (1, 16, 512, 4)),      # deployment IVF
    (16, 1204224, 1, None, (16, 1, 1176, 4)),  # deployment flat
    (16, 16384, 16, 64, (1, 16, 16, 4)),       # a serve-path scan
    (16, 16384, 1, 64, (1, 16, 16, 4)),        # shared, small: 1 a unit
    (16, 65536, 1, None, (2, 8, 64, 4)),       # shared: 512 units kept
    (16, 5003, 16, 0, (1, 16, 5, 1)),          # N % 4 != 0: scalar width
    (16, 5004, 16, 2, (1, 16, 5, 1)),          # valid off 4 bytes: scalar
    (1, 100, 1, None, (1, 1, 1, 4)),
])
def test_tiled_plan(B, N, Bc, valid_addr, plan):
    got = pq_mod.tiled_plan(B, 8, 32, N, Bc, valid_addr)
    assert (got["qg"], got["groups"], got["tiles"], got["vec"]) == plan
    assert got["units"] == got["groups"] * got["tiles"]


@pytest.mark.parametrize("units,grid", [(8192, 528), (1176, 528), (16, 528),
                                        (7, 3)])
def test_unit_ranges_cover_each_unit_once(units, grid):
    seen = [u for blk in range(min(grid, units))
            for u in _unit_range(blk, min(grid, units), units)]
    assert seen == list(range(units))


class _Built(Exception):
    """Raised by the stand-in IndexBuilder: the launcher's rule has run."""


@pytest.mark.parametrize("n_rows", [40, 129, 1000, 2049, 16385, 1_204_224])
def test_ivf_scan_shape_matches_the_jax_launcher_and_buckets(n_rows,
                                                             monkeypatch):
    # the JAX launcher's nlist, read off the IndexBuilder it constructs
    # (a stand-in that stops the build), over a corpus of n_rows
    seen = {}

    def builder(kind, dim, *, ivf, **kw):
        seen["nlist"], seen["nprobe"] = ivf.nlist, ivf.nprobe
        raise _Built

    rec = jax_serve.Recommender(None, None, None, index_kind="ivf-pq",
                                nprobe=16)
    monkeypatch.setattr(rec, "_encode_corpus", lambda chunk: np.zeros(
        (n_rows, 4), np.float32))
    monkeypatch.setattr(jax_serve.serving, "IndexBuilder", builder)
    with pytest.raises(_Built):
        rec.build_index()
    shape = port_serve.ivf_scan_shape(n_rows, 16)
    assert shape["nlist"] == seen["nlist"]
    assert shape["probes"] == seen["nprobe"]
    assert shape["cap"] == jax_next_cap(-(-n_rows // seen["nlist"]))
    assert shape["N"] == shape["probes"] * shape["cap"]
    if n_rows == 1_204_224:           # PROD's corpus: the deployment shape
        assert (shape["nlist"], shape["per_list"], shape["cap"],
                shape["N"]) == (64, 18816, 32768, 524288)


def test_pq_scan_inputs_validity_follows_the_probed_lists():
    g = torch.Generator().manual_seed(0)
    x = port_serve.pq_scan_inputs(5000, batch=4, n_subvec=8, n_codes=32,
                                  nprobe=16, gen=g, device="cpu")
    cap, N = x["cap"], x["N"]
    assert x["codes"].shape == (4, N, 8) and x["codes"].dtype == torch.uint8
    assert x["valid"].shape == (4, N) and x["lut"].shape == (4, 8, 32)
    lens = x["valid"].reshape(4, x["probes"], cap).sum(-1)
    # each probed list's slots are valid from 0 to its length, then not
    front = torch.arange(cap)[None, None] < lens[..., None]
    assert torch.equal(x["valid"].reshape(4, x["probes"], cap), front)
    share = x["per_list"]
    assert bool(((lens >= 0.95 * share - 1) & (lens <= min(cap, 1.05 * share)))
                .all())
    flat = port_serve.pq_scan_inputs(5000, batch=4, n_subvec=8, n_codes=32,
                                     nprobe=None, gen=g, device="cpu")
    assert flat["codes"].shape == (1, 5000, 8) and flat["valid"] is None
