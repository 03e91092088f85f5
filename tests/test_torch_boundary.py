"""The port's boundary: it imports neither JAX nor the JAX package, nor
``msgpack`` or ``zstandard`` (the card's host has neither), keeps the JAX
package's config fields and defaults, and refuses to run on the CPU
unless asked to."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # parallel test workers share the cores

from repro.configs import base as jbase
from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import get_smoke_config as j_get_smoke_config
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import get_config, get_smoke_config

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
CONFIG_CLASSES = ("LSHConfig", "CommConfig", "ObsConfig", "MoEConfig",
                  "SSMConfig", "XLSTMConfig", "ModelConfig", "OptimizerConfig",
                  "TrainConfig")


def _port_modules():
    return sorted("repro_torch." + ".".join(
        p.relative_to(PORT).with_suffix("").parts).replace(".__init__", "")
        for p in PORT.rglob("*.py"))


def test_port_imports_no_jax():
    """Importing every port module (serve included) leaves neither jax nor
    repro, msgpack or zstandard in sys.modules."""
    mods = ["repro_torch"] + [m for m in _port_modules() if m != "repro_torch"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'msgpack', 'zstandard'))\n"
            "print('BAD', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert {"repro_torch.launch.serve", "repro_torch.launch.train",
            "repro_torch.checkpoint.checkpoint"} <= set(mods)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"),
                                       ROOT / "chip_smoke.py"]))
def test_port_sources_import_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "msgpack",
                               "zstandard"), f"{path}: {name}"


def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            d = f.default
        else:
            d = f.default_factory()
        out.append((f.name, dataclasses.asdict(d)
                    if dataclasses.is_dataclass(d) else d))
    return out


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_fields_match_jax(name):
    assert _fields(getattr(tbase, name)) == _fields(getattr(jbase, name))


def test_granite_config_and_param_count_match_jax():
    arch = "granite-moe-3b-a800m"
    for jcfg, tcfg in ((j_get_config(arch), get_config(arch)),
                       (j_get_smoke_config(arch), get_smoke_config(arch))):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tbase.param_count(tcfg) == jbase.param_count(jcfg)
    assert 3.2e9 < tbase.param_count(get_config(arch)) < 3.4e9


def test_unknown_arch_lists_known():
    with pytest.raises(KeyError, match="granite-moe-3b-a800m"):
        get_config("no-such-arch")


def test_entry_points_need_cuda_or_explicit_cpu(monkeypatch):
    """With no CUDA device and no explicit CPU request, entry points raise
    instead of running quietly on the CPU."""
    from repro_torch.convert import params_from_jax
    from repro_torch.launch import serve, train
    from repro_torch.models import model as tmodel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("granite-moe-3b-a800m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodel.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodel.init_decode_state(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({"blocks": [], "x": np.zeros(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "granite-moe-3b-a800m", "--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "granite-moe-3b-a800m", "--smoke"])
    assert tmodel.init_params(cfg, device="cpu")["layers"]
