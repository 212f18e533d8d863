"""The port stands alone: no JAX and nothing of the JAX package in its
sources or in chip_smoke.py, and no silent move to the CPU."""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


def test_the_walk_covers_the_package():
    names = {p.name for p in PORT_FILES}
    assert {"ops.py", "buslm.py", "index.py", "serve.py", "cache.py",
            "pipeline.py", "adam.py", "straggler.py", "prefetch.py",
            "trainer.py", "train.py", "lm.py", "lm_family.py", "rope.py",
            "flash_attention.py", "device.py", "chip_smoke.py",
            "embedding_bag.py", "common.py", "ctr.py", "bert4rec.py",
            "recsys_synth.py", "recsys_family.py", "ckpt.py", "faults.py",
            "supervise.py", "registry.py", "span.py", "export.py",
            "_default.py", "base.py", "state.py", "bridge.py", "news.py",
            "tables.py", "scheduler.py", "loadgen.py", "tune.py",
            "online.py", "service.py", "graph.py", "dimenet.py",
            "gnn_family.py"} <= names
    # the registry: configs/__init__.py beside base.py's Cell and Arch
    assert ROOT / "src" / "repro_torch" / "configs" / "__init__.py" in \
        PORT_FILES
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    assert (csrc / "embedding_bag.cu").is_file()
    # both embedding_bag.py files: the kernel's module and nn's plain one
    assert sum(p.name == "embedding_bag.py" for p in PORT_FILES) == 2


def _require_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")


def test_recommender_default_device_raises_without_a_gpu():
    _require_no_gpu()
    from repro_torch.launch import serve, train
    cfg = train.small_speedyfeed_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.Recommender(cfg, {}, store=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--requests", "1"])


def test_service_default_device_raises_without_a_gpu():
    _require_no_gpu()
    from repro_torch import serving
    builder = serving.IndexBuilder("exact", 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.RetrievalService(builder, np.zeros((4, 8), np.float32))


def test_train_entry_points_default_device_raises_without_a_gpu():
    _require_no_gpu()
    from repro_torch import training
    from repro_torch.launch import train
    cfg = train.small_speedyfeed_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.train_speedyfeed(steps=1, cfg=cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        training.get_trainer("speedyfeed", cfg=cfg)


def test_prefetcher_default_device_raises_without_a_gpu():
    _require_no_gpu()
    from repro_torch import training
    with pytest.raises(RuntimeError, match="device='cpu'"):
        training.DevicePrefetcher(lambda epoch: None)
    pf = training.DevicePrefetcher(lambda epoch: None, device="cpu")
    assert pf._device == torch.device("cpu")


def test_lm_cache_default_device_raises_without_a_gpu():
    _require_no_gpu()
    from repro_torch.configs import lm_family
    from repro_torch.models import lm
    cfg = lm_family.reduced_lm(lm_family.QWEN3_14B)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_cache(cfg, 1, 8)
    assert lm.init_cache(cfg, 1, 8, device="cpu")["k"].device.type == "cpu"


def test_recsys_entry_points_default_device_raises_without_a_gpu():
    _require_no_gpu()
    from repro_torch.configs import recsys_family
    from repro_torch.data import recsys_synth
    cfg = recsys_family.reduced_ctr(recsys_family.DLRM_RM2)
    kw = dict(batch=2, n_dense=cfg.n_dense,
              vocab_sizes=cfg.sparse.vocab_sizes)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        recsys_synth.ctr_batch(np.random.default_rng(0), **kw)
    b4r = dict(batch=2, seq_len=8, n_items=50, n_mask=2, n_neg=3,
               mask_token=50)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        recsys_synth.bert4rec_batch(np.random.default_rng(0), **b4r)
    for c in (cfg, recsys_family.BERT4REC):
        for kind in ("serve", "retrieval"):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                recsys_family.make_fn(c, kind)
    batch = recsys_synth.ctr_batch(np.random.default_rng(0), device="cpu",
                                   **kw)
    assert batch["sparse_idx"].device.type == "cpu"
    assert recsys_synth.bert4rec_batch(np.random.default_rng(0),
                                       device="cpu", **b4r)[
        "tokens"].device.type == "cpu"
    assert callable(recsys_family.make_fn(cfg, "serve", device="cpu"))


def test_gnn_entry_points_default_device_raises_without_a_gpu():
    _require_no_gpu()
    from repro_torch.configs import gnn_family
    from repro_torch.data import graph
    rng = np.random.default_rng(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graph.random_molecule_batch(rng, n_graphs=2, nodes_per_graph=4,
                                    t_cap=8)
    src, dst = graph.random_graph(rng, 20, 60)
    g = graph.CSRGraph(20, src, dst)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graph.padded_subgraph_batch(
            g, np.zeros((20, 3), np.float32), np.zeros(20, np.int64),
            np.arange(2), (2,), n_cap=8, e_cap=8, t_cap=8, rng=rng)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gnn_family.train_batch("molecule", rng)
    b = graph.random_molecule_batch(rng, n_graphs=2, nodes_per_graph=4,
                                    t_cap=8, device="cpu")
    assert b["pos"].device.type == "cpu"


def test_registry_smokes_and_arch_launcher_default_device_raise_without_a_gpu():
    _require_no_gpu()
    from repro_torch import configs
    from repro_torch.launch import train
    for name in configs.ASSIGNED + ["speedyfeed"]:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            configs.get_arch(name).smoke()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "dimenet"])
