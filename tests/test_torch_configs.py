"""The port's own configs module against the JAX package's, and the rule
that the port imports nothing of the JAX package.

Each factory's output is compared field by field (nested dataclasses,
properties included), and the dict round trip is checked on the port's
copy. The import rule is an AST scan of every module of ``intentbev_torch``
and of its entry points: ``chip_smoke.py``, ``bench_torch.py``, every
``tools/*_torch.py`` and every ``examples/*_torch.py`` (the demo twin).
"""

import ast
import dataclasses
from pathlib import Path

import pytest

from intentbev import configs as jcfg
from intentbev_torch import configs as tcfg

ROOT = Path(__file__).resolve().parents[1]


def _fields(cfg, prefix=""):
    """(dotted name, value) of every field and property, recursively."""
    out = []
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out += _fields(v, f"{prefix}{f.name}.")
        else:
            out.append((prefix + f.name, v))
    for name, attr in vars(type(cfg)).items():
        if isinstance(attr, property):
            out.append((prefix + name, getattr(cfg, name)))
    return out


@pytest.mark.parametrize("factory", ["default_vit_config", "default_cnn_config",
                                     "tiny_test_config"])
def test_factories_match_field_by_field(factory):
    want = getattr(jcfg, factory)()
    got = getattr(tcfg, factory)()
    assert _fields(got) == _fields(want)
    assert [type(x).__name__ for x in (got, got.grid, got.vit)] == \
        [type(x).__name__ for x in (want, want.grid, want.vit)]
    assert got.anchors.num_total_anchors(got.grid) == want.anchors.num_total_anchors(want.grid)
    assert tcfg.config_to_dict(got) == jcfg.config_to_dict(want)
    assert tcfg.config_from_dict(tcfg.config_to_dict(got)) == got
    assert dict(tcfg.INTENTIONS_MAP) == dict(jcfg.INTENTIONS_MAP)


def _imports_of(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_nothing_of_the_jax_package():
    files = sorted((ROOT / "intentbev_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "bench_torch.py", ROOT / "tools" / "bench_train_torch.py",
        ROOT / "tools" / "profile_torch_slice.py", ROOT / "tools" / "bench_flash_torch.py"]
    files += sorted(set((ROOT / "tools").glob("*_torch.py")) - set(files))
    files += sorted((ROOT / "examples").glob("*_torch.py"))
    assert len(files) > 20
    assert ROOT / "examples" / "end_to_end_demo_torch.py" in files
    assert ROOT / "intentbev_torch" / "parallel" / "train_dp.py" in files
    bad = [(p.relative_to(ROOT).as_posix(), m) for p in files for m in _imports_of(p)
           if m.split(".")[0] in ("intentbev", "jax", "jaxlib", "flax", "optax")]
    assert not bad, bad
