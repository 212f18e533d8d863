"""The port's architecture registry (``repro_torch.configs``) against the
JAX package's, and every arch's reduced smoke on the CPU.

The registries must list the same arches, ``ASSIGNED`` the same ten, and
each arch the same family and cells; each cell the same kind, the same
``skip`` text and the same ``meta["model_flops"]`` (and, for the LMs,
``params`` and ``active_params``; for the CTR models
``embedding_rows``). The smokes run the JAX package's reduced configs
with torch draws, so their numbers differ from JAX's; they must return
the JAX smoke's keys, finite. ``launch.train --arch`` runs them.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import train  # noqa: E402

# the keys each family's JAX smoke returns
SMOKE_KEYS = {"lm": {"loss", "vocab"}, "recsys": {"loss"},
              "gnn": {"loss", "node_loss"},
              "news": {"losses", "reused_final"}}
ALL = configs.ASSIGNED + ["speedyfeed"]


def test_registry_lists_the_jax_packages_arches():
    assert configs.list_archs() == jax_configs.list_archs()
    assert configs.ASSIGNED == jax_configs.ASSIGNED
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_arch("no-such-arch")


@pytest.mark.parametrize("name", ALL)
def test_cells_match_the_jax_registry(name):
    arch, jarch = configs.get_arch(name), jax_configs.get_arch(name)
    assert arch.name == jarch.name == name
    assert arch.family == jarch.family
    assert list(arch.cells) == list(jarch.cells)
    for shape, cell in arch.cells.items():
        jcell = jarch.cells[shape]
        assert cell.key == jcell.key == f"{name}/{shape}"
        assert (cell.arch, cell.shape, cell.kind, cell.skip) == (
            jcell.arch, jcell.shape, jcell.kind, jcell.skip)
        assert math.isclose(cell.meta["model_flops"],
                            jcell.meta["model_flops"], rel_tol=1e-12)
        for key in ("params", "active_params", "embedding_rows"):
            assert cell.meta.get(key) == jcell.meta.get(key), (shape, key)
        # donate_argnums is XLA's buffer donation: nothing in the port
        assert set(cell.meta) == set(jcell.meta) - {"donate_argnums"}


@pytest.mark.parametrize("name", ALL)
def test_cell_make_fn_gives_a_step(name):
    for cell in configs.get_arch(name).cells.values():
        kw = {"device": "cpu"} if configs.get_arch(name).family == \
            "recsys" else {}
        assert callable(cell.make_fn(**kw)), cell.key


@pytest.mark.parametrize("name", ALL)
def test_arch_smoke_on_the_cpu(name):
    arch = configs.get_arch(name)
    metrics = arch.smoke(device="cpu")
    assert set(metrics) == SMOKE_KEYS[arch.family]
    for v in metrics.values():
        assert all(math.isfinite(x) for x in
                   (v if isinstance(v, list) else [v]))


def test_train_launcher_runs_an_arch_smoke(capsys):
    metrics = train.main(["--arch", "dimenet", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "smoke train for dimenet" in out
    assert set(metrics) == SMOKE_KEYS["gnn"]
    assert all(math.isfinite(v) for v in metrics.values())
    assert repr(metrics) in out
    with pytest.raises(KeyError, match="unknown arch"):
        train.main(["--arch", "no-such-arch", "--device", "cpu"])
