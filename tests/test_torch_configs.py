"""The port's configs and layer plans equal the JAX package's, and the port
imports neither jax nor the JAX package."""
import ast
import dataclasses
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")  # the machine with the card has no JAX

from repro import configs as jcfg  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(jcfg.all_configs())


def test_same_registry():
    assert sorted(tcfg.all_configs()) == ARCHS
    assert tcfg.ARCH_MODULES == jcfg.ARCH_MODULES
    assert [s.__dict__ for s in tcfg.LM_SHAPES] == [s.__dict__ for s in jcfg.LM_SHAPES]


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal(arch):
    j, t = jcfg.get_config(arch), tcfg.get_config(arch)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert t.resolved_head_dim == j.resolved_head_dim


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_layer_plan_equal(arch, reduced):
    j, t = jcfg.get_config(arch), tcfg.get_config(arch)
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert [dataclasses.astuple(b) for b in ttf.layer_plan(t)] == [
        dataclasses.astuple(b) for b in jtf.layer_plan(j)
    ]


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.JoinedStr):
                names.append("".join(v.value for v in arg.values
                                     if isinstance(v, ast.Constant)))
            elif isinstance(arg, ast.Constant):
                names.append(arg.value)
    bad = [n for n in names
           if n.split(".")[0] in ("jax", "jaxlib", "repro") or n.startswith("repro.")]
    assert not bad, f"{path.name} imports {bad}"
