"""The dry run (launch/dryrun.py, launch/cost_analysis.py) and what it
needed of the port: the ``pod`` axis, ``dp_only`` with FSDP over
``data``, the kernels as registered ops.

One ``python <this file> dry OUT`` subprocess (never this process: the
fake default group, and the JAX package's dry run sets ``XLA_FLAGS`` at
import, so that module is never imported here) runs every fake-group
case in a pool of 4 processes: each arch's smoke config through train,
prefill and decode on fake meshes (2, 4) and (2, 2, 2) at a small shape;
the full-size granite-moe-3b-a800m / train_4k / single cell; the
arguments of every arch's ``train_4k`` and ``prefill_32k`` cells on both
production meshes; and each collective of comm/collectives.py over fake
groups of 2, 4 and 16 under the counter.  Beside it, one spawn of 4 gloo
ranks runs a (pod 2, data 1, model 2) step against the (2, 2) one and a
``dp_only`` step at (2, 2) against the mesh-free step on the whole
batch.

- (a) params, active params and model FLOPs of every arch x shape equal
  the JAX package's (``repro.configs.base``; the JAX dry run's 6 / 2 x
  active params x tokens), and so do the shapes and the cells
  ``shape_applicable`` skips.
- (b) every collective's wire bytes, counted at the fake group's c10d op,
  equal ``repro.launch.hlo_analysis.parse_collectives`` on a one-line HLO
  text of the same per-rank result and group size, exactly.
- (c) ``arg_bytes`` of every arch's train_4k and prefill_32k cell on the
  16 x 16 and 2 x 16 x 16 meshes equal the bytes a rank holds by JAX's
  ``param_specs`` / ``moment_specs`` / ``batch_specs`` on an
  ``AbstractMesh`` under ``parallelism_profile(cfg.dp_only)`` (params,
  both moments, the step and skip counters, the batch); so do those of
  every decode_32k and long_500k cell by ``param_specs`` /
  ``decode_state_specs`` / ``batch_specs`` (params, the decode state,
  the tokens; the position is a Python int in the port's state).
- (d) the counter on a toy: a matmul chain's FLOPs 2 m n k each, bytes
  inputs plus outputs, a ``repro_torch`` op one op with its own bytes and
  operations; each kernel op's fake output shapes and dtypes equal its
  plain version's.
- (e) every smoke cell and the full-size cell trace with no error.
- (g) the pod axis: loss within 1e-5 relative, every gradient leaf
  (gathered whole) within 1e-5 relative L2 of the (2, 2) mesh's.
- (h) ``dp_only`` over (2, 2), params FSDP over data: losses within 1e-5
  relative of the mesh-free step's and each param's distance from it
  within 5e-3 of its update (tests/test_torch_xlstm.py's bound).
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # parallel test workers share the cores
jax = pytest.importorskip("jax")

HERE = Path(__file__).resolve()
SRC = HERE.parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch.configs.base import ShapeSpec  # noqa: E402

SMOKE_SHAPES = {"train": ShapeSpec("smoke_train", 8, 64, "train"),
                "prefill": ShapeSpec("smoke_prefill", 8, 8, "prefill"),
                "decode": ShapeSpec("smoke_decode", 8, 8, "decode")}
SMOKE_MESHES = ((2, 4), (2, 2, 2))
FULL = ("granite-moe-3b-a800m", "train_4k", "single")
ARG_SHAPES = ("train_4k", "prefill_32k")
DECODE_SHAPES = ("decode_32k", "long_500k")
KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all")
GROUPS = (2, 4, 16)


# ------------------------------------------------ the dry-run subprocess --

def _smoke_cell(arch, kind, dims):
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    try:
        with dryrun.fake_world(math.prod(dims)):
            mesh = make_mesh(dims[-2], dims[-1],
                             pod=dims[0] if len(dims) == 3 else 1,
                             node_size=2)
            shape = SMOKE_SHAPES[kind]
            art = dryrun.lower_cell(arch, shape.name, mesh, shape=shape,
                                    cfg_override=get_smoke_config(arch))
        return {"ok": "dominant" in art}
    except Exception as e:  # noqa: BLE001 -- reported by the test
        return {"error": f"{type(e).__name__}: {e}"}


def _collective_cases():
    """Each raw collective over fake groups of 2, 4 and 16 of a world of
    16, counted: [(kind, g, result bytes, wire bytes)]."""
    import torch.distributed as dist
    from repro_torch.comm import collectives as c
    from repro_torch.launch import cost_analysis, dryrun
    out = []
    with dryrun.fake_world(16):
        groups = {g: dist.new_group(list(range(g))) for g in GROUPS}
        x = torch.empty(16, 48, dtype=torch.bfloat16, device="meta")
        for g, grp in groups.items():
            for kind, fn in (
                    ("all-gather", lambda: c.raw_all_gather(x, grp, 0)),
                    ("reduce-scatter",
                     lambda: c.raw_reduce_scatter(x, grp, 0)),
                    ("all-reduce", lambda: c.raw_all_reduce_sum(x, grp)),
                    ("all-to-all", lambda: c.raw_all_to_all(x, grp))):
                mode = cost_analysis.CostMode()
                with mode:
                    fn()
                assert dict(mode.coll_counts) == {kind: 1}, \
                    (kind, dict(mode.coll_counts))
                out.append((kind, g, int(mode.coll_result[kind]),
                            float(mode.coll_wire[kind])))
    return out


def _task(t):
    from repro_torch.launch import dryrun
    what, args = t
    if what == "smoke":
        return t, _smoke_cell(*args)
    if what == "collectives":
        return t, _collective_cases()
    return t, dryrun.run_cell(*args, compile_it=(what == "full"))


def _dry_main(out_path):
    import multiprocessing

    from repro_torch.configs.registry import ARCH_IDS
    tasks = [("full", FULL), ("collectives", ())]
    tasks += [("args", (a, s, m)) for m in ("single", "multi")
              for a in ARCH_IDS for s in ARG_SHAPES + DECODE_SHAPES]
    tasks += [("smoke", (a, k, d)) for d in SMOKE_MESHES for a in ARCH_IDS
              for k in SMOKE_SHAPES]
    res = {}
    with multiprocessing.get_context("spawn").Pool(4) as pool:
        for t, r in pool.imap_unordered(_task, tasks):
            res[json.dumps(t)] = r
    with open(out_path, "w") as f:
        json.dump(res, f)


def _key(t):
    return tuple(_key(x) for x in t) if isinstance(t, list) else t


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The dry-run subprocess, the gloo ranks and JAX's argument bytes,
    all at once."""
    from repro_torch.configs.registry import ARCH_IDS
    from repro_torch.launch import mesh as tmesh
    tmp = tmp_path_factory.mktemp("dry")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, str(HERE), "dry", str(tmp / "dry.json")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        tmesh.spawn_cpu_ranks(str(HERE), 4, [str(tmp / "gloo.json")],
                              store=str(tmp / "store"), env=env,
                              timeout_s=300)
        jax_bytes = {(a, s, m): _jax_arg_bytes(a, s, m == "multi")
                     for a in ARCH_IDS for s in ARG_SHAPES + DECODE_SHAPES
                     for m in ("single", "multi")}
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    dry = {(t[0],) + _key(t[1]): v for k, v in json.loads(
        (tmp / "dry.json").read_text()).items() for t in [json.loads(k)]}
    return dry, json.loads((tmp / "gloo.json").read_text()), jax_bytes


@pytest.fixture(scope="module")
def dry(runs):
    return runs[0]


@pytest.fixture(scope="module")
def gloo(runs):
    return runs[1]


def _cells(dry, what):
    return {k[1:]: v for k, v in dry.items() if k[0] == what}


# --------------------------------------------------------------- (a) --

def test_param_counts_and_model_flops_match_jax():
    from repro.configs import base as jbase
    from repro.configs import registry as jreg
    from repro_torch.configs import base as tbase
    from repro_torch.configs.registry import ARCH_IDS, get_config
    from repro_torch.launch import dryrun
    assert tuple(tbase.SHAPES) == tuple(jbase.SHAPES)
    for arch in ARCH_IDS:
        jcfg, tcfg = jreg.get_config(arch), get_config(arch)
        assert (tbase.param_count(tcfg), tbase.active_param_count(tcfg)) \
            == (jbase.param_count(jcfg), jbase.active_param_count(jcfg))
        for name, shape in jbase.SHAPES.items():
            tshape = tbase.SHAPES[name]
            assert tshape == tbase.ShapeSpec(*dataclasses.astuple(shape))
            assert tbase.shape_applicable(tcfg, tshape) == \
                jbase.shape_applicable(jcfg, shape), (arch, name)
            tokens = shape.global_batch * (1 if shape.kind == "decode"
                                           else shape.seq_len)
            want = (6.0 if shape.kind == "train" else 2.0) \
                * jbase.active_param_count(jcfg) * tokens
            assert dryrun.model_flops(tcfg, tshape) == want, (arch, name)


# --------------------------------------------------------------- (b) --

def test_collective_wire_bytes_follow_jax_formulas(dry):
    from repro.launch.hlo_analysis import parse_collectives
    from repro_torch.launch.cost_analysis import wire_bytes
    cases = dry[("collectives",)]
    assert {(k, g) for k, g, _, _ in cases} == {(k, g) for k in KINDS
                                                for g in GROUPS}
    for kind, g, result, wire in cases:
        line = (f"  %c = u8[{result}]{{0}} {kind}(u8[{result}]{{0}} %p), "
                f"replica_groups=[{16 // g},{g}]<=[16]")
        st = parse_collectives(line)
        assert st.counts == {kind: 1}
        assert st.wire_bytes[kind] == wire == wire_bytes(kind, result, g), \
            (kind, g, result, wire, st.wire_bytes)
    for kind in ("collective-permute",):
        st = parse_collectives(f"  %c = f32[8,4]{{1,0}} {kind}(f32[8,4]"
                               "{1,0} %p), source_target_pairs={{0,1},"
                               "{1,0}}, replica_groups=[1,2]<=[2]")
        assert st.wire_bytes[kind] == wire_bytes(kind, 128, 2) == 128


# --------------------------------------------------------------- (c) --

def _jax_arg_bytes(arch, shape_name, multi):
    """Bytes a rank holds of a cell's TrainState (train) or params
    (prefill, decode) and batch by the JAX package's specs on an
    AbstractMesh; a decode cell's state by ``decode_state_specs`` and
    its tokens by ``batch_specs`` (None where ``shape_applicable`` rules
    the cell out)."""
    from jax.sharding import AbstractMesh, PartitionSpec as P
    from repro.configs import base as jbase
    from repro.configs import registry as jreg
    from repro.models import model as jmodel
    from repro.runtime import params as jparams
    from repro.runtime import sharding as jsharding
    from repro.runtime import step as jstep
    cfg, shape = jreg.get_config(arch), jbase.SHAPES[shape_name]
    amesh = AbstractMesh((2, 16, 16) if multi else (16, 16),
                         ("pod", "data", "model") if multi
                         else ("data", "model"))
    opt = jbase.OptimizerConfig(moment_dtype="int8" if jbase.param_count(
        cfg) > 2e10 else "float32")

    def local(leaf, spec):
        n = leaf.dtype.itemsize
        for d, size in enumerate(leaf.shape):
            e = spec[d] if d < len(spec) else None
            e = () if e is None else (e,) if isinstance(e, str) else e
            n *= size // math.prod(amesh.shape[a] for a in e)
        return n

    def tree(leaves, specs):
        ls = jax.tree.leaves(leaves)
        ss = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
        assert len(ls) == len(ss)
        return sum(local(leaf, s) for leaf, s in zip(ls, ss))

    if not jbase.shape_applicable(cfg, shape)[0]:
        return None
    with jsharding.parallelism_profile(cfg.dp_only):
        key = jax.random.PRNGKey(0)
        if shape.kind == "decode":
            params = jax.eval_shape(lambda k: jmodel.init_params(
                k, cfg, amesh), key)
            total = tree(params, jparams.param_specs(params, amesh))
            B, L = shape.global_batch, shape.seq_len
            state = jax.eval_shape(lambda: jmodel.init_decode_state(
                cfg, B, L, amesh))
            specs = jparams.decode_state_specs(cfg, B, amesh, max_len=L)
            tok = local(jax.ShapeDtypeStruct((B, 1), np.int32),
                        jparams._divisible(jsharding.resolve(
                            amesh, "batch", None), (B, 1), amesh))
            # the position: a Python int in the port's state
            return total + tok + tree(state["entries"], specs["entries"])
        if shape.kind == "train":
            st = jax.eval_shape(lambda k: jstep.init_train_state(
                k, cfg, opt, amesh), key)
            params = st.params
            mspecs = jparams.moment_specs(params, amesh, opt.moment_dtype)
            total = tree(st.opt.m, mspecs) + tree(st.opt.v, mspecs) \
                + st.opt.step.dtype.itemsize + st.opt.grad_skips.dtype.itemsize
        else:
            params = jax.eval_shape(lambda k: jmodel.init_params(
                k, cfg, amesh), key)
            total = 0
        total += tree(params, jparams.param_specs(params, amesh))
        specs = jparams.batch_specs(cfg, shape, amesh)
        B, S = shape.global_batch, shape.seq_len
        S_tok = S - (cfg.num_patches if cfg.frontend == "patch_stub" else 0)
        batch = {"tokens": ((B, S_tok), 4)}
        if shape.kind == "train":
            batch["labels"] = ((B, S_tok), 4)
        if cfg.frontend == "patch_stub":
            batch["patch_embeds"] = ((B, cfg.num_patches, cfg.d_model), 2)
        if cfg.encoder_decoder:
            batch["frames"] = ((B, S, cfg.d_model), 2)
        for k, (shp, size) in batch.items():
            spec = jparams._divisible(specs.get(k, P()), shp, amesh)
            total += local(jax.ShapeDtypeStruct(shp, np.dtype(f"i{size}")),
                           spec)
    return total


def test_arg_bytes_equal_jax_specs(runs):
    cells, want = _cells(runs[0], "args"), runs[2]
    cells = {c: a for c, a in cells.items() if c[1] in ARG_SHAPES}
    want = {c: w for c, w in want.items() if c[1] in ARG_SHAPES}
    assert set(cells) == set(want) and len(want) == 40
    for cell, art in sorted(cells.items()):
        assert art["arg_bytes"] == want[cell], (cell, art["arg_bytes"],
                                                want[cell])


def test_decode_arg_bytes_equal_jax_specs(runs):
    """Every decode_32k and long_500k cell on 16 x 16 and 2 x 16 x 16: the
    params, the rank's block of the decode state and its tokens equal
    what JAX's ``param_specs``, ``decode_state_specs`` and
    ``batch_specs`` give a rank, and ``decode_state_bytes`` equals
    ``jax_decode_state_bytes``: xlstm-350m's too, whose mLSTM state
    splits over ``model`` on its head dimension (8 heads over 16) and
    its sLSTM state by width."""
    cells = {c: a for c, a in _cells(runs[0], "args").items()
             if c[1] in DECODE_SHAPES}
    want = {c: w for c, w in runs[2].items() if c[1] in DECODE_SHAPES}
    assert set(cells) == set(want) and len(want) == 40
    checked = 0
    for cell, art in sorted(cells.items()):
        if want[cell] is None:
            assert "skipped" in art, cell
            continue
        assert "error" not in art, (cell, art["error"])
        assert art["decode_state_bytes"] == art[
            "jax_decode_state_bytes"], (cell, art["decode_state_bytes"],
                                        art["jax_decode_state_bytes"])
        assert art["arg_bytes"] == want[cell], (cell, art["arg_bytes"],
                                                want[cell])
        checked += 1
    assert checked == 24


# --------------------------------------------------------------- (d) --

def test_counter_on_a_toy():
    """On meta tensors, as the dry run counts."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import scatter_gather
    from repro_torch.launch import cost_analysis
    a = torch.empty(8, 16, device="meta")
    b = torch.empty(16, 32, device="meta")
    c = torch.empty(32, 4, device="meta")
    mode = cost_analysis.CostMode()
    with mode:
        y = (a @ b) @ c
        y.t()                                   # a view moves no bytes
    assert mode.flops == mode.aten_flops == 2 * 8 * 16 * 32 + 2 * 8 * 32 * 4
    with FlopCounterMode(display=False) as fc:
        (a @ b) @ c
    assert fc.get_total_flops() == mode.aten_flops
    assert mode.bytes == 4 * ((8 * 16 + 16 * 32 + 8 * 32)
                              + (8 * 32 + 32 * 4 + 8 * 4))
    ids = torch.empty(10, dtype=torch.int32, device="meta")
    pos = torch.empty(10, dtype=torch.int32, device="meta")
    src = torch.empty(10, 24, dtype=torch.bfloat16, device="meta")
    mode = cost_analysis.CostMode()
    with mode:
        buf = scatter_gather.dispatch_scatter(ids, pos, src, 3, 5)
    assert tuple(buf.shape) == (3, 5, 24) and buf.dtype == torch.float32
    assert mode.kernels["dispatch_scatter"].calls == 1
    assert mode.bytes == mode.kernels["dispatch_scatter"].bytes == \
        10 * 4 + 10 * 4 + 10 * 24 * 2 + 3 * 5 * 24 * 4
    assert mode.flops == 10 * 24 and not mode.coll_counts
    assert mode.peak == cost_analysis.rounded(3 * 5 * 24 * 4)


def _kernel_calls():
    """One call of each kernel op on small CPU tensors."""
    from repro_torch.kernels import (fused_wire, lsh_hash, residual_apply,
                                     scatter_gather, segment_centroid,
                                     token_position, wire_quant)
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(-1, 5, (12,), generator=g, dtype=torch.int32)
    pos = torch.randint(0, 4, (12,), generator=g, dtype=torch.int32)
    src = torch.randn(12, 16, generator=g).to(torch.bfloat16)
    buf = torch.randn(4, 3, 16, generator=g)
    w = torch.rand(12, generator=g)
    slots = torch.randint(-1, 3, (2, 5), generator=g, dtype=torch.int32)
    x = torch.randn(2, 5, 16, generator=g)
    eo = torch.randn(2, 3, 16, generator=g)
    q, s = wire_quant.wire_quantize(eo, "fp8")
    qb, sb = wire_quant.wire_quantize(buf, "int8")
    rot = torch.randn(3, 16, 4, generator=g)
    return {
        "positions_in_expert": (token_position.positions_in_expert,
                                (ids, 4)),
        "dispatch_scatter": (scatter_gather.dispatch_scatter,
                             (ids, pos, src, 4, 3)),
        "combine_gather": (scatter_gather.combine_gather,
                           (ids, pos, buf, w)),
        "lsh_hash": (lsh_hash.lsh_hash, (src, rot.to(torch.bfloat16))),
        "segment_centroid": (segment_centroid.segment_centroid,
                             (slots, x, 3)),
        "residual_apply": (residual_apply.residual_apply, (slots, eo, x)),
        "wire_quantize": (wire_quant.wire_quantize, (eo, "fp8")),
        "wire_dequantize": (wire_quant.wire_dequantize, (q, s)),
        "dispatch_scatter_quantize": (fused_wire.dispatch_scatter_quantize,
                                      (ids, pos, src, 4, 3, "int8")),
        "dequantize_combine_gather": (fused_wire.dequantize_combine_gather,
                                      (ids, pos, qb, sb, w)),
        "dequantize_residual_apply": (fused_wire.dequantize_residual_apply,
                                      (slots, q, s, x, eo)),
    }


def test_kernel_ops_fake_shapes_equal_plain_versions():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.build import NAMESPACE
    from repro_torch.launch.cost_analysis import KERNEL_OPS
    calls = _kernel_calls()
    assert set(calls) == set(KERNEL_OPS)
    for name, (fn, args) in calls.items():
        want = fn(*args)                      # the CPU implementation
        want = want if isinstance(want, tuple) else (want,)
        mode = FakeTensorMode()
        fargs = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                 for a in args]
        with mode:
            got = fn(*fargs)
        got = got if isinstance(got, tuple) else (got,)
        assert [(tuple(t.shape), t.dtype) for t in got] == \
            [(tuple(t.shape), t.dtype) for t in want], name
        assert hasattr(getattr(torch.ops, NAMESPACE), name)


# --------------------------------------------------------------- (e) --

def test_every_smoke_cell_and_a_full_cell_trace(dry):
    from repro_torch.configs.registry import ARCH_IDS
    smoke = _cells(dry, "smoke")
    assert len(smoke) == len(ARCH_IDS) * 3 * len(SMOKE_MESHES)
    bad = {k: v for k, v in smoke.items() if not v.get("ok")}
    assert not bad, bad
    full = dry[("full",) + FULL]
    assert "error" not in full, full.get("error")
    keys = {"flops_per_device", "bytes_per_device", "wire_bytes_per_device",
            "collectives", "collective_counts", "arg_bytes", "temp_bytes",
            "output_bytes", "compute_s", "memory_s", "collective_s",
            "dominant", "hlo_flops_global", "model_flops_global",
            "model_flops_ratio", "roofline_fraction", "params",
            "active_params", "use_lsh", "mesh", "mesh_name", "n_devices",
            "lower_s", "compile_s", "xla_flops"}
    assert keys <= set(full), keys - set(full)
    assert full["mesh"] == "16x16" and full["n_devices"] == 256
    assert full["collective_counts"]["all-to-all"] > 0
    assert full["kernels"]["lsh_hash"]["calls"] > 0
    assert 0 < full["roofline_fraction"] < 1


# ------------------------------------------------------ (g), (h): gloo --

def _gloo_main(rank, world, args):
    from repro_torch.configs import base as tbase
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.convert import gather_params, shard_params
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import model as tmodel
    from repro_torch.optim.adam import _map, adamw_init, leaves
    from repro_torch.runtime import params as tparams
    from repro_torch.runtime import step as tstep
    cpu = torch.device("cpu")
    m22 = tmesh.make_mesh(2, 2)
    mpod = tmesh.make_mesh(1, 2, pod=2)
    out = {}
    # (g): the gradient half of the step over (2, 2) and (pod 2, 1, 2)
    cfg = get_smoke_config("granite-moe-3b-a800m").replace(dtype="float32")
    whole = tmodel.init_params(cfg, seed=1, device=cpu)
    batch = tstep.batch_to_device(SyntheticLMDataset(
        cfg.vocab_size, 16, 4).batch_at(0), cpu)
    for tag, mesh in (("22", m22), ("pod", mpod)):
        specs = tparams.model_specs(cfg, mesh)
        params = shard_params(whole, mesh, specs)
        loss, _, grads = tstep.make_accum_grad_fn(cfg, mesh=mesh)(params,
                                                                  batch)
        it = iter(grads)
        full = gather_params(_map(lambda p: next(it), params), mesh, specs)
        out[f"{tag}/loss"] = float(loss)
        out[f"{tag}/g"] = [g.tolist() for g in leaves(full)
                           if g is not None]
    # (h): dp_only at (2, 2), 2 steps, against the mesh-free step
    cfg = get_smoke_config("smollm-360m").replace(dtype="float32")
    opt = tbase.OptimizerConfig(lr=1e-3, warmup_steps=0)
    whole = tmodel.init_params(cfg, seed=2, device=cpu)
    ds = SyntheticLMDataset(cfg.vocab_size, 16, 8)
    for tag, mesh in (("dp", m22), ("free", None)):
        specs = None if mesh is None else tparams.model_specs(cfg, mesh)
        params = _map(torch.clone, whole) if mesh is None \
            else _map(torch.clone, shard_params(whole, mesh, specs))
        state = tstep.TrainState(params, adamw_init(params, opt))
        step = tstep.make_train_step(cfg, opt, mesh=mesh)
        for s in range(2):
            state, m = step(state, tstep.batch_to_device(ds.batch_at(s), cpu))
            out[f"{tag}/loss{s}"] = float(m["loss"])
        p = state.params if mesh is None else gather_params(state.params,
                                                            mesh, specs)
        out[f"{tag}/p"] = [t.tolist() for t in leaves(p)]
    out["start"] = [t.tolist() for t in leaves(whole)]
    if rank == 0:
        with open(args[0], "w") as f:
            json.dump(out, f)
    return 0


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_pod_axis_step_matches_the_data_axis(gloo):
    assert abs(gloo["pod/loss"] - gloo["22/loss"]) <= 1e-5 * abs(
        gloo["22/loss"])
    assert len(gloo["pod/g"]) == len(gloo["22/g"]) > 20
    worst = max(_rel(a, b) for a, b in zip(gloo["pod/g"], gloo["22/g"]))
    print(f"pod (2, 1, 2) against (2, 2): worst gradient rel L2 {worst:.3g}")
    assert worst <= 1e-5


def test_dp_only_fsdp_step_matches_the_whole_batch_step(gloo):
    for s in range(2):
        assert abs(gloo[f"dp/loss{s}"] - gloo[f"free/loss{s}"]) <= \
            1e-5 * abs(gloo[f"free/loss{s}"])
    worst = max(
        np.linalg.norm(np.asarray(a) - np.asarray(b))
        / max(np.linalg.norm(np.asarray(b) - np.asarray(s0)), 1e-30)
        for a, b, s0 in zip(gloo["dp/p"], gloo["free/p"], gloo["start"]))
    print(f"dp_only (2, 2): worst param difference over its update "
          f"{worst:.3g}")
    assert worst < 5e-3


if __name__ == "__main__":
    if sys.argv[1] == "dry":
        _dry_main(sys.argv[2])
    else:                                   # RANK WORLD STORE args...
        from repro_torch.launch import mesh as _tmesh
        sys.exit(_tmesh.run_cpu_rank(sys.argv[1:], _gloo_main))
