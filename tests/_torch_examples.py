"""The JAX package's example scripts (examples/*.py) as modules, and what
one of them hands a function it calls.  The scripts build their configs
inside ``main()``, so a test runs ``main()`` with some functions wrapped
to record their arguments and one replaced by a stop, and reads the
config the script built from the record.  Nothing under examples/ is
edited.  Used by tests/test_torch_example_*.py.
"""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


class Stop(Exception):
    """Raised in place of the stop function: the script ends there."""


def jax_example(name: str):
    """examples/<name>.py imported as a module (once a process)."""
    key = f"_jax_example_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, EXAMPLES / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


def run_until(main, stop, record=(), argv=("example",), replace=()):
    """Run ``main()`` under ``argv`` until it calls ``stop`` = (object,
    attribute name); each (object, name) of ``record`` is called through
    and ``replace`` holds (object, name, value) set for the run.
    Returns {name: [(args, kwargs), ...]} of the recorded and stop
    calls."""
    calls = {}

    def recorder(real, name):
        def wrapper(*a, **k):
            calls.setdefault(name, []).append((a, k))
            return real(*a, **k)
        return wrapper

    def stopper(*a, **k):
        calls.setdefault(stop[1], []).append((a, k))
        raise Stop

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", list(argv))
        for obj, name in record:
            mp.setattr(obj, name, recorder(getattr(obj, name), name))
        for obj, name, value in replace:
            mp.setattr(obj, name, value)
        mp.setattr(*stop, stopper)
        with pytest.raises(Stop):
            main()
    return calls


def f32(cfg):
    """A JAX or port ModelConfig in f32 with the f32 LSH wire."""
    moe = cfg.moe
    return dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        moe, lsh=dataclasses.replace(moe.lsh, wire_dtype="float32")))


def np_tree(tree):
    """A JAX tree as numpy arrays."""
    return jax.tree.map(np.asarray, tree)
