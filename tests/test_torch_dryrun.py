"""The port's dry-run (``launch/dryrun.py``, ``op_analysis``,
``roofline``, ``roofline_table``) against the JAX package's, on the CPU.

The port counts a cell's step on meta tensors; the JAX package lowers it
through XLA. Held here:

* counted FLOPs against JAX's ``from_compiled`` on the 1-device mesh,
  within 1e-3 for the three CTR ``serve_p99`` cells and 1e-2 for DimeNet
  ``molecule``, and the serve peaks within 10% of JAX's
  ``peak_memory_per_chip`` (JAX's bytes count a gather's whole table, so
  the port's bytes are held to hand counts instead);
* every non-skipped cell's ``abstract_args()`` against the JAX cell's
  ``abstract_args(None)``: the batch's leaves (keys, shapes, dtypes)
  equal, the parameters and the Adam state the same element count per
  dtype, every leaf on meta;
* ``OpCounter``'s byte rules on small functions with exact counts, its
  peak live bytes and ``quad_bytes``;
* each kernel wrapper's meta route: the card's route and output shapes,
  its ``work()`` recorded, a raise where no route takes the shape, no
  launch counted;
* ``Roofline.to_dict`` with JAX's keys, the measure path on the CPU, the
  table, ``gather_dedup``'s fixed-size unique against the old code and
  JAX, and the CLI's count of two of the largest cells in a subprocess
  under 4 GB of resident memory.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.core import centralized as jax_centralized  # noqa: E402
from repro.launch import roofline as jax_rl  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs import recsys_family  # noqa: E402
from repro_torch.core import centralized  # noqa: E402
from repro_torch.kernels import bus_attention as bus  # noqa: E402
from repro_torch.kernels import embedding_bag as ebag  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pq_scoring as pq  # noqa: E402
from repro_torch.launch import dryrun, op_analysis  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch import roofline_table  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(name, shape) for name in configs.list_archs()
         for shape, cell in configs.get_arch(name).cells.items()
         if not cell.skip]


def meta(*shape, dtype=torch.float32, **kw):
    return torch.empty(shape, dtype=dtype, device="meta", **kw)


# ---------------------------------------------------------------- vs JAX

@pytest.mark.parametrize("arch,shape,tol", [
    ("dcn-v2", "serve_p99", 1e-3), ("dlrm-rm2", "serve_p99", 1e-3),
    ("wide-deep", "serve_p99", 1e-3), ("dimenet", "molecule", 1e-2)])
def test_counted_flops_and_peak_match_the_jax_dry_run(arch, shape, tol):
    from repro.launch.mesh import make_mesh_for, set_mesh
    jcell = jax_configs.get_arch(arch).cells[shape]
    mesh = make_mesh_for(1, model=1)
    with set_mesh(mesh):
        compiled = jax.jit(jcell.make_fn(mesh)).lower(
            *jcell.abstract_args(mesh)).compile()
    want = jax_rl.from_compiled(jcell, compiled, "1x1", 1)
    rec = dryrun.run_cell(configs.get_arch(arch).cells[shape], verbose=False)
    assert rec["status"] == "ok" and rec["mesh"] == rl.MESH
    assert abs(rec["flops_per_chip"] / want.flops_per_chip - 1) <= tol
    if shape == "serve_p99":
        assert abs(rec["peak_memory_per_chip"] / want.peak_memory_per_chip
                   - 1) <= 0.10
    assert rec["model_flops"] == want.model_flops
    assert rec["t_collective"] == 0.0 and rec["chips"] == 1


def _split(cell, args):
    """(params, Adam state or None, the rest by name) of a cell's
    arguments, for either package."""
    if cell.kind == "train":
        if cell.arch == "speedyfeed":
            if len(args) == 2:                        # JAX: (TrainState, batch)
                state, batch = args
                return state.params, state.opt, {"cache": state.cache,
                                                 "batch": batch}
            params, opt, cache, _, _, batch = args
            return params, opt, {"cache": cache, "batch": batch}
        return args[0], args[1], {"batch": args[2]}
    if cell.kind == "decode":
        return args[0], None, {"token": args[1], "cache": args[2]}
    names = {"prefill": ("tokens",), "serve": ("batch",),
             "retrieval": ("batch", "cand")}[cell.kind]
    if cell.arch == "speedyfeed":
        names = ("tokens", "freq")
    return args[0], None, dict(zip(names, args[1:]))


def _flat(tree, prefix=""):
    """{path: (shape, dtype name)} of a tree of dicts, lists, tuples and
    named tuples of jax ShapeDtypeStructs or torch tensors."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flat(tree[key], f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree)
                for k, v in _flat(x, f"{prefix}{i}/").items()}
    dtype = str(tree.dtype)
    return {prefix[:-1]: (tuple(tree.shape), dtype.removeprefix("torch."))}


def _count_by_dtype(tree) -> dict:
    out = {}
    for shape, dtype in _flat(tree).values():
        out[dtype] = out.get(dtype, 0) + int(np.prod(shape, dtype=np.int64))
    return out


@pytest.mark.parametrize("arch,shape", CELLS)
def test_abstract_args_match_the_jax_cell(arch, shape):
    cell = configs.get_arch(arch).cells[shape]
    jcell = jax_configs.get_arch(arch).cells[shape]
    args = cell.abstract_args()
    params, opt, rest = _split(cell, args)
    jparams, jopt, jrest = _split(jcell, jcell.abstract_args(None))
    assert _flat(rest) == _flat(jrest)
    assert _count_by_dtype(params) == _count_by_dtype(jparams)
    assert (opt is None) == (jopt is None)
    if opt is not None:
        assert _count_by_dtype(opt) == _count_by_dtype(jopt)
    leaves = [t for t in jax.tree.leaves((params, opt, rest))
              if isinstance(t, torch.Tensor)]
    assert leaves and all(t.device.type == "meta" for t in leaves)


def test_roofline_to_dict_has_the_jax_keys():
    kw = dict(arch="a", shape="s", mesh="m", chips=1, flops_per_chip=1e12,
              bytes_per_chip=1e9, coll_bytes_per_chip=0.0, coll_detail={},
              peak_memory_per_chip=1e9, model_flops=5e11)
    got = rl.Roofline(**kw, flops_by_dtype={"float32": 1e12}).to_dict()
    assert set(got) == set(jax_rl.Roofline(**kw).to_dict())


# ------------------------------------------------------------ byte rules

def test_matmul_relu_backward_counts_and_peak():
    x, g = meta(64, 128), meta(64, 256)
    w = meta(128, 256, requires_grad=True)
    with op_analysis.OpCounter((x, w, g)) as c:
        y = torch.relu(x @ w)
        gw, = torch.autograd.grad(y, w, g)
    r = c.result()
    X, W, Y = 64 * 128 * 4, 128 * 256 * 4, 64 * 256 * 4
    assert r["breakdown"]["matmul"] == {
        "calls": 2, "flops": 2 * 2 * 64 * 128 * 256, "bytes": 2 * (X + W + Y)}
    # relu: y in, out; its backward: the cotangent and y in, out
    assert r["breakdown"]["elementwise"] == {"calls": 2, "flops": 0.0,
                                             "bytes": 2 * Y + 3 * Y}
    assert r["bytes"] == 2 * (X + W + Y) + 5 * Y
    assert r["flops_by_dtype"] == {"float32": 2 * 2 * 64 * 128 * 256}
    # the arguments, y, the relu's gradient and gw live at once
    assert r["args_bytes"] == X + W + Y
    assert r["peak_bytes"] == X + W + Y + Y + Y + W


@pytest.mark.parametrize("how", ["index", "index_select", "embedding",
                                 "gather"])
def test_a_gather_counts_indices_and_twice_its_output(how):
    t, i = meta(1000, 32), meta(50, dtype=torch.int64)
    with op_analysis.OpCounter() as c:
        if how == "index":
            t[i]
        elif how == "index_select":
            t.index_select(0, i)
        elif how == "embedding":
            torch.nn.functional.embedding(i, t)
        else:
            t.gather(0, meta(50, 32, dtype=torch.int64))
    n_idx = 50 * 32 * 8 if how == "gather" else 50 * 8
    assert c.result()["breakdown"] == {"gather/scatter": {
        "calls": 1, "flops": 0.0, "bytes": n_idx + 2 * 50 * 32 * 4}}


def test_index_add_counts_src_indices_and_touched_rows_twice():
    z, i, s = meta(1000, 32), meta(50, dtype=torch.int64), meta(50, 32)
    with op_analysis.OpCounter() as c:
        z.index_add_(0, i, s)
    assert c.result()["bytes"] == 50 * 32 * 4 + 50 * 8 + 2 * 50 * 32 * 4


def test_in_place_add_reads_and_writes_its_operand_and_views_are_free():
    a, b = meta(100, 100), meta(100, 100)
    with op_analysis.OpCounter() as c:
        a.add_(b)
        a.view(-1), a.t(), a[:, :10], a.unsqueeze(0)
    r = c.result()
    assert r["bytes"] == 3 * 100 * 100 * 4
    assert r["breakdown"] == {"elementwise": {"calls": 1, "flops": 0.0,
                                              "bytes": 3 * 100 * 100 * 4}}


def test_quad_bytes_of_an_attention_sized_product():
    with op_analysis.OpCounter() as c:
        meta(2, 4, 1024, 64) @ meta(2, 4, 64, 1024)
    assert c.result()["quad_bytes"] == 2 * 4 * 1024 * 1024 * 4


# ------------------------------------------------------- kernel meta routes

def _kernel_call(name, dtype, D):
    """(call on meta, the card's route, the work it must record, the
    output shapes' plain version on the CPU)."""
    if name == "bus":
        M, K, S, Sk, H = 4, 3, 8, 11, 2
        q, k, v = (meta(M, K, s, H, D, dtype=dtype, requires_grad=True)
                   for s in (S, Sk, Sk))
        mask = meta(M, K, Sk, dtype=torch.bool)
        do = meta(M, K, S, H, D, dtype=dtype)

        def call():
            o = ops.bus_attention(q, k, v, mask)
            return (o, *torch.autograd.grad(o, (q, k, v), do))
        fwd, bwd = bus.bus_route(S, Sk, D)
        return call, [(fwd, bus.work(M, K, S, Sk, H, D, dtype)),
                      (bwd, bus.work(M, K, S, Sk, H, D, dtype, True))], \
            [q.shape, q.shape, k.shape, v.shape]
    if name == "flash":
        B, S, Hq, Hkv = 2, 64, 4, 2
        q = meta(B, S, Hq, D, dtype=dtype, requires_grad=True)
        k, v = (meta(B, S, Hkv, D, dtype=dtype, requires_grad=True)
                for _ in range(2))
        do = meta(B, S, Hq, D, dtype=dtype)

        def call():
            o = ops.flash_attention(q, k, v)
            return (o, *torch.autograd.grad(o, (q, k, v), do))
        return call, [
            (flash.forward_route(dtype, D),
             flash.work(B, S, S, Hq, Hkv, D, dtype, True)),
            ("+".join(flash.backward_route(dtype, D)),
             flash.work(B, S, S, Hq, Hkv, D, dtype, True, True))], \
            [q.shape, q.shape, k.shape, v.shape]
    if name == "pq":
        B, M, K, N = 3, 8, 32, 1000
        lut, codes = meta(B, M, K), meta(1, N, M, dtype=dtype)
        valid = meta(B, N, dtype=torch.bool)
        route = pq.pq_route(M, K, dtype, 0)
        return (lambda: (ops.pq_lut_scores(lut, codes, valid),)), \
            [(route, pq.work(B, M, K, N, 1, dtype.itemsize, B))], [(B, N)]
    V, B, F, nnz = 1000, 16, 5, 2
    table = meta(V, D, dtype=dtype, requires_grad=True)
    idx = meta(B, F, nnz, dtype=torch.int32)
    w = meta(B, F, nnz)
    dout = meta(B, F, D, dtype=dtype)

    def call():
        o = ops.embedding_bag(table, idx, w)
        return (o, *torch.autograd.grad(o, table, dout))
    return call, [("embedding_bag", ebag.work(V, D, B, F, nnz, dtype, True)),
                  ("embedding_bag_bwd",
                   ebag.bwd_work(V, D, B, F, nnz, dtype, True))], \
        [(B, F, D), (V, D)]


@pytest.mark.parametrize("name,dtype,D", [
    ("bus", torch.float32, 64), ("bus", torch.bfloat16, 32),
    ("bus", torch.float32, 8), ("flash", torch.bfloat16, 128),
    ("flash", torch.float32, 64), ("flash", torch.float32, 16),
    ("pq", torch.uint8, 0), ("pq", torch.int32, 0),
    ("embedding_bag", torch.float32, 64),
    ("embedding_bag", torch.bfloat16, 8)])
def test_kernel_meta_route_records_the_cards_route_and_work(name, dtype, D):
    call, want, shapes = _kernel_call(name, dtype, D)
    before = ops.launch_counts()
    with op_analysis.OpCounter() as c:
        outs = call()
    assert ops.launch_counts() == before
    assert [tuple(o.shape) for o in outs] == [tuple(s) for s in shapes]
    assert all(o.device.type == "meta" for o in outs)
    got = {k[len("kernel:"):]: v for k, v in c.result()["breakdown"].items()
           if k.startswith("kernel:")}
    assert got == {route: {"calls": 1, "flops": w["flops"],
                           "bytes": w["bytes"]} for route, w in want}
    # a product kernel's FLOPs count in the step's; a gather-sum's do not
    products = sum(w["flops"] for _, w in want if w["op_class"] == "matmul")
    assert sum(c.result()["flops_by_dtype"].values()) == products


def test_kernel_meta_routes_raise_where_no_route_takes_the_shape():
    with pytest.raises(ValueError, match="head dim 20"):       # flash
        ops.flash_attention(*(meta(1, 64, 2, 20) for _ in range(3)))
    q = meta(1, 1, 512, 1, 128)                                 # bus smem
    with pytest.raises(ValueError, match="shared memory"):
        ops.bus_attention(q, q, q, meta(1, 1, 512, dtype=torch.bool))
    with pytest.raises(TypeError, match="lut must be float32"):  # pq
        ops.pq_lut_scores(meta(2, 8, 32, dtype=torch.float64),
                          meta(1, 10, 8, dtype=torch.uint8))
    with pytest.raises(TypeError, match="idx must be int32"):   # ebag
        ops.embedding_bag(meta(10, 4), meta(2, 3, 1, dtype=torch.int64))
    with pytest.raises(RuntimeError, match="meta route"):
        flash.flash_attention_meta(*(torch.zeros(1, 8, 1, 16)
                                     for _ in range(3)))


# ------------------------------------------------------- measure and table

def _small_ctr_cell():
    """dcn-v2's serve cell at the reduced CTR widths and B=32, with both
    argument builders."""
    cfg = recsys_family.reduced_ctr(recsys_family.DCN_V2)
    return base.Cell(
        arch="dcn-v2-reduced", shape="serve", kind="serve",
        make_fn=lambda device="cuda": recsys_family.make_fn(
            cfg, "serve", device=device),
        meta={"model_flops": 1e6},
        abstract_args=lambda: (
            base.abstract_params(lambda g: recsys_family.ctr.init(g, cfg)),
            recsys_family._abstract_batch(cfg, "serve", 32)),
        concrete_args=lambda device: (
            recsys_family.ctr.init(
                torch.Generator(device=device).manual_seed(0), cfg),
            {k: v for k, v in recsys_family.recsys_synth.ctr_batch(
                np.random.default_rng(0), batch=32, n_dense=cfg.n_dense,
                vocab_sizes=cfg.sparse.vocab_sizes, device=device).items()
             if k != "label"}))


def test_measure_on_the_cpu_and_the_table(tmp_path):
    cell = _small_ctr_cell()
    rec = dryrun.run_cell(cell, measure=True, device="cpu", verbose=False)
    assert rec["status"] == "ok" and rec["fits_one_card"]
    assert rec["measured_on"] == "cpu" and len(rec["measured_s_each"]) == 3
    assert rec["achieved"] == rec["step_time_lb"] / rec["measured_s"]
    assert rec["mfu"] == 1e6 / (rec["peak_flops"] * rec["measured_s"])
    assert "kernel:embedding_bag" in rec["breakdown"]
    path = tmp_path / "dry.jsonl"
    unmeasured = dict(rec, shape="other")
    for k in ("measured_s", "achieved", "mfu"):
        unmeasured.pop(k)
    path.write_text("\n".join(json.dumps(r) for r in (
        rec, unmeasured, {"arch": "x", "shape": "y", "mesh": rl.MESH,
                          "status": "skip"})) + "\n")
    rows = roofline_table.summary_table(path).splitlines()
    assert len(rows) == 4 and rows[0].endswith("| measured ms | achieved "
                                               "| mfu |")
    assert rows[2].split("|")[-5].strip() == "yes"          # other: fits
    measured = [r for r in rows if "| serve |" in r][0]
    assert f"{rec['measured_s'] * 1e3:.3f}" in measured


def test_a_skipped_cell_is_recorded_not_counted(tmp_path):
    out = tmp_path / "dry.jsonl"
    out.write_text(json.dumps({"arch": "x", "shape": "y", "mesh": rl.MESH,
                               "status": "ok"}) + "\n")
    recs = dryrun.run(["qwen3-14b"], "long_500k", str(out))
    assert [r["status"] for r in recs] == ["skip"]
    # the run empties --out first: its one line is this run's record
    assert json.loads(out.read_text())["reason"].startswith("pure full")


def test_a_later_fail_line_replaces_an_earlier_ok_one(tmp_path):
    ok = {"arch": "a", "shape": "s", "mesh": rl.MESH, "status": "ok"}
    path = tmp_path / "dry.jsonl"
    path.write_text(json.dumps(ok) + "\n" + json.dumps(
        dict(ok, status="fail", error="RuntimeError: x")) + "\n")
    assert roofline_table.load(path) == {}
    path.write_text(json.dumps(dict(ok, status="fail")) + "\n"
                    + json.dumps(ok) + "\n")
    assert list(roofline_table.load(path)) == [("a", "s", rl.MESH)]


def test_measuring_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rec = {"step_time_lb": 1.0, "model_flops": 1.0, "peak_flops": 1.0}
    with pytest.raises(RuntimeError, match="no.*available|none is"):
        dryrun.measure_cell(_small_ctr_cell(), rec)


@pytest.mark.parametrize("arch,shape", [("speedyfeed", "train_prod"),
                                        ("dimenet", "ogb_products")])
def test_cli_counts_large_cells_in_little_memory(arch, shape):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               PYTHONDONTWRITEBYTECODE="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape], capture_output=True, text=True, env=env,
        timeout=300, check=True).stdout
    m = re.search(r"dry-run summary: (\d+) ok, (\d+) fail, (\d+) skip; "
                  r"[\d.]+ s; ru_maxrss ([\d.]+) GB", out)
    assert m and m.groups()[:3] == ("1", "0", "0"), out[-2000:]
    assert float(m.group(4)) < 4.0


# ------------------------------------------------------------ gather_dedup

def _old_gather_dedup_ids(flat, m_cap):
    """The port's merged set before it was made static in size."""
    uniq = torch.unique(flat, sorted=True)[:m_cap]
    uniq = torch.cat([uniq, uniq.new_zeros(m_cap - uniq.shape[0])])
    return torch.sort(uniq).values


@pytest.mark.parametrize("m_cap,n_ids,with_cands", [
    (64, 40, True), (64, 500, True), (128, 100, False), (16, 1000, True)])
def test_gather_dedup_equals_the_old_code_and_jax(m_cap, n_ids, with_cands):
    rng = np.random.default_rng(m_cap + n_ids)
    hist = rng.integers(0, n_ids, (8, 12)).astype(np.int32)
    cand = rng.integers(0, n_ids, (8, 3)).astype(np.int32) if with_cands \
        else None
    got = centralized.gather_dedup(
        torch.from_numpy(hist),
        None if cand is None else torch.from_numpy(cand), m_cap=m_cap)
    want = jax_centralized.gather_dedup(
        jnp.asarray(hist), None if cand is None else jnp.asarray(cand),
        m_cap=m_cap)
    flat = torch.cat([torch.zeros(1, dtype=torch.int32),
                      torch.from_numpy(hist).reshape(-1)]
                     + ([torch.from_numpy(cand).reshape(-1)]
                        if cand is not None else []))
    assert torch.equal(got.ids, _old_gather_dedup_ids(flat, m_cap))
    for a, b in ((got.ids, want.ids), (got.inv_hist, want.inv_hist),
                 (got.overflow, want.overflow)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    if cand is not None:
        assert np.array_equal(got.inv_cand.numpy(),
                              np.asarray(want.inv_cand))
    n_unique = len(np.unique(flat.numpy()))
    assert (int(got.overflow) > 0) == (n_unique > m_cap)
