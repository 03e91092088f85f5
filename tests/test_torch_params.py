"""The port's placement rules (runtime/params.py) against the JAX
package's ``param_specs`` / ``moment_specs``, with no devices.

JAX's specs come from ``jax.eval_shape`` of its ``init_params`` on an
``AbstractMesh`` (nothing is allocated), the port's from
``runtime.params.model_specs`` (the params' shapes on the meta device),
for all ten configs at their smoke and full shapes on the (data, model)
meshes (1, 2), (2, 1), (2, 2) and (1, 4): every leaf's spec equal, and
the AdamW moments' with f32 and int8 moments (``model_moment_specs``,
which the train state is laid out, updated and checkpointed by).  JAX's stacked blocks
[num_super_blocks, ...] carry a leading None that the port's per-layer
``layers[i]`` (layout entry i % len(layout)) does not.  Beside them:
full granite-8b's param elements a rank at (2, 2) are JAX's 2 114 228 224
exactly, and ``_divisible``'s cases (a vocabulary of 49155 stays whole
over model 2 and 4; a dimension splits over an axis of one rank).
"""
import functools
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # parallel test workers share the cores
jax = pytest.importorskip("jax")

HERE = Path(__file__).resolve()
SRC = HERE.parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from jax.sharding import AbstractMesh, PartitionSpec  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.runtime import params as jparams  # noqa: E402
from repro.runtime import sharding as jsharding  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.runtime import params as tparams  # noqa: E402

ARCHS = ("granite-8b", "granite-moe-3b-a800m", "internvl2-26b",
         "jamba-1.5-large-398b", "nemotron-4-15b", "phi3-mini-3.8b",
         "qwen3-moe-30b-a3b", "smollm-360m", "whisper-base", "xlstm-350m")
MESHES = ((1, 2), (2, 1), (2, 2), (1, 4))


def _entry(e):
    if e is None:
        return ()
    return (e,) if isinstance(e, str) else tuple(e)


def _is_spec(x):
    return isinstance(x, PartitionSpec) or x is None


def _names(path):
    return tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _jax_flat(tree, specs, n_layout):
    """{port key: spec as the port writes it} of a JAX spec tree over the
    shapes ``tree``: the blocks' entry i, stacked over super-blocks,
    becomes the port's layers sb * n + i, its leading (stacked) entry
    dropped; an int8 moment's q / scale reads its param's rank."""
    shapes = {_names(p): leaf.shape
              for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=_is_spec)[0]:
        if spec is None:
            continue
        names = _names(path)
        shape = shapes[names if names in shapes else names[:-1]]
        entries = [_entry(e) for e in spec] + [()] * (len(shape) - len(spec))
        if "blocks" not in names:
            out["/".join(names)] = tuple(entries)
            continue
        b = names.index("blocks")
        for sb in range(shape[0]):
            layer = sb * n_layout[names[:b]] + int(names[b + 1])
            key = names[:b] + ("layers", str(layer)) + names[b + 2:]
            out["/".join(key)] = tuple(entries[1:])
    return out


def _port_flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch, smoke, model):
    """JAX's ``init_params`` shapes, which depend on the mesh through
    the model axis alone (the experts pad to it)."""
    jcfg = (jreg.get_smoke_config if smoke else jreg.get_config)(arch)
    amesh = AbstractMesh((1, model), ("data", "model"))
    return jax.eval_shape(lambda k: jmodel.init_params(k, jcfg, amesh),
                          jax.random.PRNGKey(0))


def _both(arch, smoke, shape):
    jcfg = (jreg.get_smoke_config if smoke else jreg.get_config)(arch)
    tcfg = (treg.get_smoke_config if smoke else treg.get_config)(arch)
    amesh = AbstractMesh(shape, ("data", "model"))
    return jcfg, tcfg, amesh, _jax_shapes(arch, smoke, shape[1]), \
        Mesh(shape)


def _equal(want, got, what):
    got = {k: v for k, v in got.items() if v is not None}
    assert set(want) == set(got), (what, sorted(set(want) ^ set(got))[:6])
    bad = [(k, got[k], w) for k, w in want.items() if got[k] != w]
    assert not bad, (what, len(bad), bad[:4])


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_jax(arch, smoke):
    """Every param leaf's and every moment's spec (f32 and int8) equal to
    the JAX package's, on the four meshes."""
    for shape in MESHES:
        jcfg, tcfg, amesh, tree, mesh = _both(arch, smoke, shape)
        n = {(): len(jcfg.layout), ("encoder",): 1}
        what = f"{arch} {'smoke' if smoke else 'full'} {shape}"
        # a dp_only config's specs are those of its own profile, as the
        # JAX dry run and trainer take them
        with jsharding.parallelism_profile(jcfg.dp_only):
            jspecs = jparams.param_specs(tree, amesh)
            jmoments = {d: jparams.moment_specs(tree, amesh, d)
                        for d in ("float32", "int8")}
        _equal(_jax_flat(tree, jspecs, n),
               _port_flat(tparams.model_specs(tcfg, mesh)), what)
        for dtype in ("float32", "int8"):
            got = tparams.model_moment_specs(tcfg, mesh, dtype)
            _equal(_jax_flat(tree, jmoments[dtype], n),
                   _port_flat(got), f"{what} {dtype} moments")
            # what the state is laid out and checkpointed by
            state = tparams.train_state_specs(tcfg, mesh, dtype)
            assert state.params is tparams.model_specs(tcfg, mesh)
            assert state.opt.m is got and state.opt.v is got


def _elements(specs, params, mesh):
    return sum(math.prod(tparams.local_shape(t.shape, s, mesh))
               for t, s in zip(_port_flat(params).values(),
                               _port_flat(specs).values()))


def test_granite_8b_elements_a_rank_at_2x2():
    """Full granite-8b at (2, 2): 2 114 228 224 param elements a rank in
    both packages (8.255 G whole)."""
    jcfg, tcfg, amesh, tree, mesh = _both("granite-8b", False, (2, 2))
    jspecs = jparams.param_specs(tree, amesh)
    jtot = 0
    for leaf, spec in zip(jax.tree.leaves(tree),
                          jax.tree.leaves(jspecs, is_leaf=_is_spec)):
        n = 1
        for d, size in enumerate(leaf.shape):
            e = _entry(spec[d] if d < len(spec) else None)
            n *= size // math.prod(amesh.shape[a] for a in e)
        jtot += n
    meta = tmodel.logical_params(tcfg, mesh)
    got = _elements(tparams.model_specs(tcfg, mesh), meta, mesh)
    whole = sum(t.numel() for t in _port_flat(meta).values())
    print(f"granite-8b at (2, 2): {got} of {whole} elements a rank")
    assert got == jtot == 2_114_228_224


@pytest.mark.parametrize("model", [2, 4])
def test_divisible_keeps_a_dimension_that_does_not_split_whole(model):
    """granite-moe's vocabulary of 49155 splits over neither 2 nor 4
    model ranks: its table stays whole and its head splits over data
    only; a dimension over an axis of one rank is 'split' into one
    block."""
    cfg = treg.get_config("granite-moe-3b-a800m")
    specs = tparams.model_specs(cfg, Mesh((2, model)))
    assert specs["embed"]["table"] == ((), ())
    assert specs["head"]["w"] == (("data",), ())
    assert tparams.leaf_spec(("wq",), (6, 8), Mesh((1, 1))) == \
        (("data",), ("model",))
    assert tparams.leaf_spec(("wq",), (6, 8), Mesh((4, 1))) == \
        ((), ("model",))
    assert tparams.leaf_spec(("a_log",), (3,), Mesh((1, 2))) == ((),)
