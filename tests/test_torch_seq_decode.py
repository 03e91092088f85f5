"""Decode over a sequence-split cache: the port's ``decode_step`` on a
state laid out by JAX's ``decode_state_specs`` (runtime/params.
decode_layout, models/model.init_decode_state(mesh=)), against JAX's
``decode_step`` jitted with ``in_shardings`` from ``param_specs`` and
``decode_state_specs`` (as ``repro/launch/dryrun.py`` lowers its decode
cells), on the same mesh.

One ``python <this file> jax ...`` subprocess with four forced host
devices writes each case's params first (seeded numpy values in the
tree of JAX's ``init_params`` on the case's mesh, so the port's ranks
start at once) and runs JAX's 8 teacher-forced f32 steps; one spawn of
4 gloo ranks runs the port on the same numpy params
(``convert.params_from_jax``).  Cases (smoke configs):

- granite-moe-3b-a800m, 4 rows, a 16-position cache, at (1, 4) (the
  sequence in blocks of 4 over ``model``: the steps cross two block
  edges, blocks 2 and 3 stay wholly in the future) and at (2, 2) (rows
  over ``data``, blocks of 8: block 1 stays in the future);
- the same at (2, 2) over a 17-position cache (17 does not split: the kv
  heads split over ``model``) and at (1, 4) over 18 (the head dimension
  splits over ``model``);
- jamba-1.5-large-398b at batch 1 over (2, 2): the sequence over
  (data, model), the Mamba heads over ``model``.

Bounds: logits within atol 1e-4 (tests/test_torch_decode.py's), equal
greedy tokens at every step, every state leaf gathered whole within 1e-5
relative L2 of JAX's; a second run of the (1, 4) case bitwise the first
(the combine is a gather summed in rank order, no all-reduce); and
each rank's ``decode_attention`` on its block of a 16-row cache at
(1, 4), combined over gloo, bitwise ``split_decode_attention`` on the
whole cache, f32 and bf16, at positions across the block edges and as
cross-attention.

In this process, with no process group: ``split_decode_attention``
(the split's one-process emulation, which computes each block's partial
from a copy of its rows as a rank holds them) against the whole-cache
``decode_attention``, f32 and bf16 caches, at positions 0, a block's
last row, the next block's first and the cache's last, and as
cross-attention: within 1e-6 relative L2 for n = 2, 4, 8, and n = 1
bitwise; and ``init_decode_state(mesh=)``'s shapes and layout on meshes
without groups.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # parallel test workers share the cores
if __name__ != "__main__":
    pytest.importorskip("jax")

HERE = Path(__file__).resolve()
SRC = HERE.parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch.launch import mesh as tmesh  # noqa: E402

STEPS = 8
# name: (arch, (data, model), rows, cache length)
CASES = {
    "granite-1x4": ("granite-moe-3b-a800m", (1, 4), 4, 16),
    "granite-2x2": ("granite-moe-3b-a800m", (2, 2), 4, 16),
    "granite-2x2-heads": ("granite-moe-3b-a800m", (2, 2), 4, 17),
    "granite-1x4-dh": ("granite-moe-3b-a800m", (1, 4), 4, 18),
    "jamba-2x2-b1": ("jamba-1.5-large-398b", (2, 2), 1, 16),
}
ATOL = 1e-4
STATE_RTOL = 1e-5
SPLIT_RTOL = 1e-6


def _cfg(registry, arch):
    return registry.get_smoke_config(arch).replace(dtype="float32")


def _tokens(cfg, rows):
    return np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(rows, STEPS)).astype(np.int32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _unflat(flat):
    root = {}
    for key, v in flat.items():
        node, parts = root, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(t):
        if isinstance(t, dict):
            t = {k: fix(v) for k, v in t.items()}
            if t and all(k.isdigit() for k in t):
                return [t[str(i)] for i in range(len(t))]
        return t
    return fix(root)


# ------------------------------------------------- the JAX reference --

def _fill(shapes):
    """Seeded numpy values for JAX's param tree of ``shapes`` (its
    ``eval_shape``; drawing them eagerly over four host devices takes
    about 10 s a config): matrices normal / sqrt(fan-in), conv_w normal
    0.2, norm scales and ``d_skip`` 1 + normal 0.1, ``dt_bias`` normal
    0.1, ``a_log`` log(1..16) as JAX draws it, a placement the
    identity."""
    import jax
    rng = np.random.default_rng(0)

    def one(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = leaf.shape
        if name == "placement":
            return np.broadcast_to(np.arange(shape[-1], dtype=np.int32),
                                   shape).copy()
        if name == "a_log":
            return np.broadcast_to(np.log(np.linspace(
                1.0, 16.0, shape[-1], dtype=np.float32)), shape).copy()
        r = rng.standard_normal(shape).astype(np.float32)
        if name in ("scale", "d_skip"):
            return 1.0 + 0.1 * r
        if name == "dt_bias":
            return 0.1 * r
        if name == "conv_w":
            return 0.2 * r
        return r / np.sqrt(shape[-2]).astype(np.float32)
    return jax.tree_util.tree_map_with_path(one, shapes)


def _jax_main(tmp):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.compat import set_mesh
    from repro.configs import registry as jreg
    from repro.launch.mesh import make_host_mesh
    from repro.models import model as jmodel
    from repro.runtime import params as jparams
    from repro.runtime import sharding as jsharding

    tmp = Path(tmp)
    meshes, params = {}, {}
    for name, (arch, (d, m), rows, length) in CASES.items():
        cfg = _cfg(jreg, arch)
        meshes[name] = mesh = make_host_mesh(d, 1, m)
        with set_mesh(mesh):
            shapes = jax.eval_shape(lambda k: jmodel.init_params(
                k, cfg, mesh), jax.random.PRNGKey(0))
        params[name] = _fill(shapes)
        np.savez(tmp / f"params_{name}.npz", **_flat(params[name]))
    (tmp / "params.done").write_text("")
    for name, (arch, _, rows, length) in CASES.items():
        cfg, mesh = _cfg(jreg, arch), meshes[name]

        def shard(specs):
            return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                                is_leaf=lambda x: isinstance(x, P))
        tokens = _tokens(cfg, rows)
        with set_mesh(mesh):
            p = jax.tree.map(jnp.asarray, params[name])
            p_sh = shard(jparams.param_specs(p, mesh))
            st_sh = shard(jparams.decode_state_specs(cfg, rows, mesh,
                                                     max_len=length))
            tok_sh = NamedSharding(mesh, jparams._divisible(
                jsharding.resolve(mesh, "batch", None), (rows, 1), mesh))
            state = jax.device_put(
                jmodel.init_decode_state(cfg, rows, length, mesh), st_sh)
            step = jax.jit(lambda p, s, t: jmodel.decode_step(
                p, cfg, mesh, s, t), in_shardings=(p_sh, st_sh, tok_sh))
            logits = []
            for i in range(STEPS):
                lg, state = step(p, state, jax.device_put(
                    jnp.asarray(tokens[:, i:i + 1]), tok_sh))
                logits.append(np.asarray(lg))
        out = {"logits": np.concatenate(logits, 1)}
        out.update({f"state/{k}": v for k, v in _flat(
            jax.tree.map(np.asarray, state["entries"])).items()})
        np.savez(tmp / f"jax_{name}.npz", **out)


# ------------------------------------------------- the port's ranks --

def _run_case(name, tmp, rank):
    from repro_torch.comm import collectives
    from repro_torch.configs import registry as treg
    from repro_torch.convert import params_from_jax, shard_params
    from repro_torch.models import model as tmodel
    from repro_torch.runtime import params as tparams
    from repro_torch.runtime import sharding

    arch, (d, m), rows, length = CASES[name]
    cfg = _cfg(treg, arch)
    mesh = tmesh.make_mesh(d, m)
    full = params_from_jax(_unflat(dict(np.load(
        Path(tmp) / f"params_{name}.npz"))), device="cpu")
    local = shard_params(full, mesh, tparams.model_specs(cfg, mesh))
    del full
    state = tmodel.init_decode_state(cfg, rows, length, device="cpu",
                                     mesh=mesh)
    layout = state["layout"]
    r0, n = layout["rows"]
    tokens = torch.from_numpy(_tokens(cfg, rows)).long()[r0:r0 + n]
    logits = []
    for i in range(STEPS):
        lg, state = tmodel.decode_step(local, cfg, state,
                                       tokens[:, i:i + 1], mesh=mesh)
        logits.append(lg)
    logits = torch.cat(logits, 1).contiguous()
    if n < rows:
        logits = collectives.raw_all_gather(logits,
                                            sharding.dp_group(mesh), 0)
    out = {"logits": logits, "layout": json.dumps(
        {k: v for k, v in layout.items() if k not in ("specs", "shapes")})}
    for i, (cache, specs) in enumerate(zip(state["layers"],
                                           layout["specs"])):
        for k, t in cache.items():
            out[f"state/{i}/{k}"] = tparams.gather(t.contiguous(), specs[k],
                                                   mesh)
    return out


def _attn_rank_path(rank, tmp):
    """``decode_attention`` on this rank's block of a 16-row cache at
    (1, 4) (``model.cache_split`` of ``init_decode_state(mesh=)``'s
    layout: 4 blocks over ``model``, gathered and combined over gloo)
    against ``split_decode_attention`` on the whole cache in this
    process: the outputs and the rank's written block, bitwise.  Writes
    the cases that differ."""
    from repro_torch.configs import registry as treg
    from repro_torch.models import attention as attn
    from repro_torch.models import model as tmodel
    mesh = tmesh.make_mesh(1, 4)
    layout = tmodel.init_decode_state(
        _cfg(treg, "granite-moe-3b-a800m"), 3, 16, device="meta",
        mesh=mesh)["layout"]
    split = tmodel.cache_split(mesh, layout)
    n = 16 // split.blocks
    missed = [] if (split.blocks, split.offset) == (4, n * rank) \
        else [f"split {split}"]
    for dtype in (torch.float32, torch.bfloat16):
        params, x, cache, kw = _attn_inputs(dtype, seed=2)
        for cross in (False, True):
            for pos in (0, 3, 4, 5, 15):
                whole = {k: v.clone() for k, v in cache.items()}
                block = {k: v[:, split.offset:split.offset + n].clone()
                         for k, v in cache.items()}
                want, _ = attn.split_decode_attention(
                    params, x, whole, pos, 4, cross=cross, **kw)
                got, _ = attn.decode_attention(
                    params, x, block, pos, cross=cross, split=split, **kw)
                if not (torch.equal(got, want) and all(torch.equal(
                        block[k], whole[k][:, split.offset:
                                           split.offset + n])
                        for k in block)):
                    missed.append(f"{dtype} cross={cross} position {pos}")
    (Path(tmp) / f"attn_rank{rank}.json").write_text(json.dumps(missed))


def _port_main(rank, world, args):
    tmp = Path(args[0])
    _attn_rank_path(rank, tmp)
    while not (tmp / "params.done").exists():
        time.sleep(0.05)
    for name in CASES:
        out = _run_case(name, tmp, rank)
        if name == "granite-1x4":
            again = _run_case(name, tmp, rank)
            out["repeat_bitwise"] = np.asarray(all(
                torch.equal(again[k], v) for k, v in out.items()
                if torch.is_tensor(v)))
        if rank == 0:
            np.savez(tmp / f"port_{name}.npz",
                     **{k: v.numpy() if torch.is_tensor(v) else v
                        for k, v in out.items()})
    return 0


# ------------------------------------------------------------- tests --

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seqdecode")
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_proc = subprocess.Popen(
        [sys.executable, str(HERE), "jax", str(tmp)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port_env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    try:
        while not (tmp / "params.done").exists():
            if jax_proc.poll() is not None:
                break
            time.sleep(0.05)
        if jax_proc.poll() is None or jax_proc.returncode == 0:
            tmesh.spawn_cpu_ranks(str(HERE), 4, [str(tmp)],
                                  store=str(tmp / "store"), env=port_env,
                                  timeout_s=300)
    finally:
        _, err = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, err[-4000:]
    out = {name: (dict(np.load(tmp / f"jax_{name}.npz")),
                  dict(np.load(tmp / f"port_{name}.npz")))
           for name in CASES}
    out["attn"] = [json.loads((tmp / f"attn_rank{r}.json").read_text())
                   for r in range(4)]
    return out


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name", list(CASES))
def test_split_decode_matches_jax(runs, name):
    want, got = runs[name]
    arch, _, rows, length = CASES[name]
    layout = json.loads(str(got["layout"]))
    assert got["logits"].shape == want["logits"].shape
    err = float(np.abs(got["logits"] - want["logits"]).max())
    # the state: the port's layer sb * len(layout) + i is JAX's layout
    # entry i of super-block sb
    from repro_torch.configs import registry as treg
    n_entries = len(_cfg(treg, arch).layout)
    worst = 0.0
    for key, v in got.items():
        if not key.startswith("state/"):
            continue
        _, layer, leaf = key.split("/")
        sb, i = divmod(int(layer), n_entries)
        ref = want[f"state/{i}/{leaf}"][sb]
        assert v.shape == ref.shape, (key, v.shape, ref.shape)
        worst = max(worst, _rel_l2(v, ref))
    print(f"{name} {layout}: logits max |diff| {err:.3g}, worst state "
          f"leaf rel L2 {worst:.3g}")
    assert err <= ATOL
    np.testing.assert_array_equal(got["logits"].argmax(-1),
                                  want["logits"].argmax(-1))
    assert worst <= STATE_RTOL
    want_axes = {"granite-1x4": (["model"], [], []),
                 "granite-2x2": (["model"], [], []),
                 "granite-2x2-heads": ([], ["model"], []),
                 "granite-1x4-dh": ([], [], ["model"]),
                 "jamba-2x2-b1": (["data", "model"], [], [])}[name]
    assert (layout["seq_axes"], layout["kv_axes"],
            layout["dh_axes"]) == want_axes


def test_split_decode_repeats_its_bits(runs):
    assert bool(runs["granite-1x4"][1]["repeat_bitwise"])


def test_rank_path_is_its_one_process_emulation_bitwise(runs):
    """The 4 ranks' ``decode_attention(split=)`` over gloo equals
    ``split_decode_attention`` at n = 4, f32 and bf16 caches, positions
    0, 3 (a block's last row), 4, 5 (past a block edge) and 15, and as
    cross-attention."""
    assert runs["attn"] == [[]] * 4, runs["attn"]


def _attn_inputs(dtype, B=3, nh=6, nkv=2, dh=8, S=16, H=24, seed=0):
    g = torch.Generator().manual_seed(seed)

    def f(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale
    params = {"wq": f(H, nh * dh, scale=0.3), "wk": f(H, nkv * dh, scale=0.3),
              "wv": f(H, nkv * dh, scale=0.3), "wo": f(nh * dh, H, scale=0.3)}
    cache = {"k": f(B, S, nkv, dh).to(dtype), "v": f(B, S, nkv, dh).to(dtype)}
    kw = dict(num_heads=nh, num_kv_heads=nkv, head_dim=dh, rope_theta=1e4)
    return params, f(B, 1, H), cache, kw


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_form_matches_the_whole_cache(dtype, cross):
    from repro_torch.models import attention as attn
    params, x, cache, kw = _attn_inputs(dtype)
    S = cache["k"].shape[1]
    for n in (1, 2, 4, 8):
        b = S // n
        for pos in sorted({0, b - 1, min(b, S - 1), S - 1}):
            c0 = {k: v.clone() for k, v in cache.items()}
            c1 = {k: v.clone() for k, v in cache.items()}
            want, _ = attn.decode_attention(params, x, c0, pos, cross=cross,
                                            **kw)
            got, _ = attn.split_decode_attention(params, x, c1, pos, n,
                                                 cross=cross, **kw)
            assert all(torch.equal(c0[k], c1[k]) for k in c0)
            if n == 1:
                assert torch.equal(got, want), (pos, dtype, cross)
            else:
                rel = _rel_l2(got.numpy(), want.numpy())
                assert rel <= SPLIT_RTOL, (n, pos, dtype, cross, rel)


def test_a_block_wholly_in_the_future_weighs_zero():
    """At position 0 every block but the first is masked: the combine
    gives the first row's value exactly, as the softmax does."""
    from repro_torch.models import attention as attn
    params, x, cache, kw = _attn_inputs(torch.float32, seed=1)
    c0 = {k: v.clone() for k, v in cache.items()}
    c1 = {k: v.clone() for k, v in cache.items()}
    want, _ = attn.decode_attention(params, x, c0, 0, **kw)
    got, _ = attn.split_decode_attention(params, x, c1, 0, 8, **kw)
    assert torch.equal(got, want)


def test_a_laid_out_state_needs_its_mesh():
    """A state of ``init_decode_state(mesh=)`` holds one rank's block:
    stepping it without the mesh raises before any work."""
    from repro_torch.configs import registry as treg
    from repro_torch.models import model as tmodel
    cfg = _cfg(treg, "granite-moe-3b-a800m")
    mesh = tmesh.Mesh((1, 4), rank=0)
    tokens = torch.zeros(4, 1, dtype=torch.long)
    with pytest.raises(ValueError, match="laid out"):
        tmodel.decode_step({}, cfg, tmodel.init_decode_state(
            cfg, 4, 16, device="meta", mesh=mesh), tokens)


@pytest.mark.parametrize("arch,shape,rows,length,want", [
    ("granite-moe-3b-a800m", (16, 16), 128, 32768,
     {"rows": (0, 8), "seq_axes": ("model",), "seq_blocks": 16}),
    ("jamba-1.5-large-398b", (16, 16), 1, 524288,
     {"rows": (0, 1), "seq_axes": ("data", "model"), "seq_blocks": 256,
      "mamba_axes": ("model",)}),
    ("jamba-1.5-large-398b", (2, 16, 16), 1, 524288,
     {"rows": (0, 1), "seq_axes": ("pod", "data", "model"),
      "seq_blocks": 512}),
    ("xlstm-350m", (16, 16), 128, 32768, {"rows": (0, 8), "seq_axes": ()}),
])
def test_init_decode_state_holds_the_rank_block(arch, shape, rows, length,
                                                want):
    """On meta tensors over a mesh without groups (the last rank): each
    leaf the rank's block of the whole state by the layout's specs."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as tmodel
    from repro_torch.runtime import params as tparams
    cfg = get_config(arch)
    axes = ("pod", "data", "model") if len(shape) == 3 else None
    last = int(np.prod(shape)) - 1
    mesh = tmesh.Mesh(shape, rank=last, axes=axes)
    state = tmodel.init_decode_state(cfg, rows, length, device="meta",
                                     mesh=mesh)
    whole = tmodel.init_decode_state(cfg, rows, length, device="meta")
    lay = state["layout"]
    n_dp = int(np.prod(shape[:-1]))
    want = dict(want, rows=want["rows"] if rows < n_dp else
                ((n_dp - 1) * rows // n_dp, rows // n_dp))
    for k, v in want.items():
        assert lay[k] == v, (k, lay[k], v)
    assert lay["seq_offset"] == length - length // lay["seq_blocks"]
    for c, w, specs in zip(state["layers"], whole["layers"], lay["specs"]):
        for k in c:
            assert c[k].shape == tparams.local_shape(w[k].shape, specs[k],
                                                     mesh)


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_main(sys.argv[2])
    else:                                   # RANK WORLD STORE args...
        sys.exit(tmesh.run_cpu_rank(sys.argv[1:], _port_main))
