"""The dry run (counterpart of ``repro/launch/dryrun.py``): every (arch x
shape x mesh) cell of the paper's scale, traced on meta tensors over a
fake process group, with its roofline terms.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \\
      granite-moe-3b-a800m --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out artifacts/dryrun.json

No card and no memory are needed.  A cell's process starts a fake default
group (``torch.testing._internal.distributed.fake_pg``) of 256 ranks (the
16 x 16 (data, model) mesh) or 512 (2 x 16 x 16, (pod, data, model);
launch/mesh.make_production_mesh, 8 ranks a node as on an HGX H100
host), plays its rank 0, and runs the port's own entry points on
``meta`` tensors (shapes and dtypes, no data): ``runtime.step.
make_train_step`` (train, with the config's ``train_microbatch``, remat
policy and profile), ``models.model.prefill`` or
``models.model.decode_step``.  Every op the card would run is
dispatched, the eleven kernels as their ``repro_torch`` ops' fake
implementations (kernels/build.register_op: the Meta kernel), every
collective as the fake group's c10d op, and launch/cost_analysis.py
counts them.

Meta tensors, not ``FakeTensorMode``'s fake ``cuda`` ones: a CPU build of
torch cannot index a fake ``cuda`` tensor (its device guard needs the
CUDA runtime), a fake tensor on this build lies on ``meta`` anyway, and
the fake mode's per-op cache took about three times as long a cell (the
full granite-moe-3b-a800m / train_4k cell: 43.5 s against 15.3 s, the
same counts).  Nothing on the step's path chooses by device but the
kernel ops.  The state is built from ``models.model.logical_params``' shapes
and the specs (runtime/params.py), as JAX's ``eval_shape`` gives it; the
moments are int8 where the params exceed 2e10 (JAX's ``_opt_cfg``).  The
batch is the global one (a meta tensor holds nothing), and its argument
bytes are the rank's block by ``params.batch_specs``.

A cell's record has JAX's keys (``flops_per_device``, ...,
``roofline_fraction``, ``mesh_name``); ``lower_s`` is the seconds taken
to build the state and batch and ``compile_s`` those of the traced step,
``xla_flops`` the FLOPs of the aten ops alone (``FlopCounterMode``'s
count; tests/test_torch_dryrun.py holds them equal).  Decode cells
build the rank's block of the state by JAX's ``decode_state_specs``
(``models.model.init_decode_state(mesh=)``: the caches' sequence over
``model``, or over (dp axes, model) at batch 1, the Mamba and mLSTM
states by heads, or the mLSTM's by head dimension, the sLSTM's by
width), and the rank's rows of the tokens; their ``decode_state_bytes``
(the port's) stand beside ``jax_decode_state_bytes``, JAX's specs
applied to every leaf, its check.  A cell that fails is recorded with its
``error`` and the run exits 1; a cell ``shape_applicable`` rules out is
``skipped``.  ``--workers`` cells run at once, each in a process of its
own.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import multiprocessing
import os
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import (SHAPES, OptimizerConfig,
                                      active_param_count, param_count,
                                      shape_applicable)
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch import cost_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers
from repro_torch.models import model as model_lib
from repro_torch.optim.adam import adamw_init
from repro_torch.runtime import params as params_lib
from repro_torch.runtime import sharding
from repro_torch.runtime import step as step_lib

FAKE_DEVICE = "meta"


def batch_shapes(cfg, shape) -> Dict[str, tuple]:
    """{name: (shape, dtype)} of every model input of a cell (the JAX
    ``_batch_structs``)."""
    B, S = shape.global_batch, shape.seq_len
    i32, dt = torch.int32, model_lib.torch_dtype(cfg.dtype)
    if shape.kind == "decode":
        return {"tokens": ((B, 1), i32)}
    S_tok = S - (cfg.num_patches if cfg.frontend == "patch_stub" else 0)
    out = {"tokens": ((B, S_tok), i32)}
    if shape.kind == "train":
        out["labels"] = ((B, S_tok), i32)
    if cfg.frontend == "patch_stub":
        out["patch_embeds"] = ((B, cfg.num_patches, cfg.d_model), dt)
    if cfg.encoder_decoder:
        out["frames"] = ((B, S, cfg.d_model), dt)
    return out


def batch_arg_bytes(cfg, shape, mesh) -> Dict[str, int]:
    """{name: the bytes a rank holds of it} of a cell's batch by
    ``params.batch_specs`` (a dimension that does not divide stays
    whole)."""
    specs = params_lib.batch_specs(cfg, mesh)
    out = {}
    for k, (shp, dtype) in batch_shapes(cfg, shape).items():
        spec = params_lib._divisible(specs.get(k, ((),) * len(shp)), shp,
                                     mesh)
        out[k] = math.prod(params_lib.local_shape(shp, spec, mesh)) \
            * torch.empty((), dtype=dtype).element_size()
    return out


def model_flops(cfg, shape) -> float:
    """The JAX dry run's model FLOPs of a cell: 6 (train) or 2 x the
    active params x the tokens (a decode step's tokens: its batch)."""
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    return (6.0 if shape.kind == "train" else 2.0) \
        * active_param_count(cfg) * tokens


def opt_cfg_for(cfg) -> OptimizerConfig:
    """int8 moments above 2e10 params, as the JAX dry run's ``_opt_cfg``."""
    return OptimizerConfig(
        moment_dtype="int8" if param_count(cfg) > 2e10 else "float32")


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake default process group of ``world_size`` ranks, this process
    its rank 0; destroyed on exit.  Raises if a default group is already
    started."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake default group; "
                           "one is already started")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=FAKE_DEVICE)


def fake_params(cfg, mesh):
    """The rank's shard of every param, as meta tensors of the local
    shapes of ``params.model_specs`` (the whole params without a
    mesh)."""
    whole = model_lib.logical_params(cfg, mesh)
    if mesh is None:
        return params_lib._walk(whole, lambda n, t: _fake(t.shape, t.dtype))
    return params_lib.map_specs(
        lambda t, s: _fake(params_lib.local_shape(t.shape, s, mesh),
                           t.dtype), whole, params_lib.model_specs(cfg, mesh))


def jax_decode_state_bytes(cfg, batch: int, max_len: int, mesh) -> int:
    """The bytes a rank would hold of the decode state laid out by JAX's
    ``decode_state_specs`` (the port's per-layer state shapes, every
    leaf by its spec): the check of the port's own layout
    (``init_decode_state(mesh=)``)."""
    specs = params_lib.decode_state_specs(cfg, batch, mesh, max_len)
    state = model_lib.init_decode_state(cfg, batch, max_len,
                                        device=FAKE_DEVICE)
    total = 0
    for i, layer in enumerate(state["layers"]):
        spec = specs["entries"][i % len(cfg.layout)]
        for k, t in layer.items():
            total += math.prod(params_lib.local_shape(
                t.shape, params_lib._divisible(spec[k], t.shape, mesh),
                mesh)) * t.element_size()
    return total


def _train(cfg, shape, mesh, use_lsh):
    opt_cfg = opt_cfg_for(cfg)
    params = fake_params(cfg, mesh)
    opt = adamw_init(params, opt_cfg, step_lib._int8_splits(
        params, opt_cfg, mesh, step_lib.mesh_specs(cfg, mesh),
        step_lib.moment_specs(cfg, opt_cfg, mesh)))
    state = step_lib.TrainState(params, opt)
    batch = {k: _fake(s, d) for k, (s, d) in batch_shapes(cfg, shape).items()}
    fn = step_lib.make_train_step(cfg, opt_cfg, use_lsh=use_lsh,
                                  microbatch=cfg.train_microbatch, mesh=mesh)
    return (state, batch), lambda: fn(state, batch)


def _prefill(cfg, shape, mesh, use_lsh):
    params = fake_params(cfg, mesh)
    batch = {k: _fake(s, d) for k, (s, d) in batch_shapes(cfg, shape).items()}
    return (params, batch), \
        lambda: model_lib.prefill(params, cfg, batch, mesh=mesh)


def _decode(cfg, shape, mesh, use_lsh):
    params = fake_params(cfg, mesh)
    state = model_lib.init_decode_state(cfg, shape.global_batch,
                                        shape.seq_len, device=FAKE_DEVICE,
                                        mesh=mesh)
    rows = shape.global_batch if mesh is None else state["layout"]["rows"][1]
    tokens = _fake((rows, 1), torch.int32)
    return (params, state, tokens), \
        lambda: model_lib.decode_step(params, cfg, state, tokens, mesh=mesh)


_KINDS = {"train": _train, "prefill": _prefill, "decode": _decode}


def lower_cell(arch: str, shape_name: str, mesh, *, use_lsh=None,
               compile_it: bool = True, cfg_override=None,
               shape=None) -> Dict:
    """Trace one cell on meta tensors over ``mesh`` (a mesh of the
    started fake group, or None: one card, no group) and return its
    record; ``compile_it`` False
    builds the arguments only (``arg_bytes``, no roofline).  ``shape``
    (a ``ShapeSpec``) replaces ``SHAPES[shape_name]``."""
    cfg = cfg_override or get_config(arch)
    shape = shape or SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}
    layers.clear_sinusoid_tables()
    with sharding.parallelism_profile(cfg.dp_only):
        t0 = time.time()
        args, run = _KINDS[shape.kind](cfg, shape, mesh, use_lsh)
        flops = model_flops(cfg, shape)
        # the state (train) or params, and the rank's block of the batch;
        # "arg_alloc_bytes": those on the device, each rounded up to the
        # caching allocator's blocks (what torch.cuda.memory_allocated
        # counts)
        if shape.kind == "decode":
            held, batch = args, {}
        else:
            held, batch = args[0], batch_arg_bytes(cfg, shape, mesh)
        arg_bytes = cost_analysis.tree_bytes(held) + sum(batch.values())
        n = sharding.num_ranks(mesh)
        art = {"arch": arch, "shape": shape_name,
               "mesh": "x".join(str(s) for s in mesh.shape.values())
               if mesh is not None else "1",
               "n_devices": n, "params": param_count(cfg),
               "active_params": active_param_count(cfg),
               "model_flops_global": flops,
               "use_lsh": use_lsh if use_lsh is not None
               else (cfg.moe.lsh.enabled and cfg.has_moe()),
               "arg_bytes": arg_bytes,
               "arg_alloc_bytes": cost_analysis.tree_bytes(
                   held, alloc=True, device=FAKE_DEVICE) + sum(
                   cost_analysis.rounded(b) for b in batch.values()),
               "lower_s": round(time.time() - t0, 2)}
        if shape.kind == "decode":
            art["decode_state_bytes"] = cost_analysis.tree_bytes(args[1])
            art["jax_decode_state_bytes"] = jax_decode_state_bytes(
                cfg, shape.global_batch, shape.seq_len, mesh)
        if not compile_it:
            return art
        t0 = time.time()
        mode = cost_analysis.CostMode(
            node_size=getattr(mesh, "node_size", 0) or 8)
        with mode:
            out = run()
        art["compile_s"] = round(time.time() - t0, 2)
        if shape.kind == "train":
            out = out[1]                  # the state is updated in place
        roof = cost_analysis.roofline(
            mode, arg_bytes=arg_bytes,
            output_bytes=cost_analysis.tree_bytes(out))
        del out, mode
    layers.clear_sinusoid_tables()
    art.update(roof.to_dict())
    art["hlo_flops_global"] = roof.flops_per_device * n
    art["model_flops_ratio"] = (flops / art["hlo_flops_global"]
                                if art["hlo_flops_global"] else 0.0)
    art["roofline_fraction"] = ((flops / n / cost_analysis.PEAK_FLOPS)
                                / roof.bound_s if roof.bound_s else 0.0)
    return art


def _check_autotune(mesh) -> None:
    """``--autotune``: the planner ranks transports from the tuning cache
    (``$REPRO_TUNE`` = cache); a fake group cannot probe, so a mesh with
    no entry raises."""
    from repro_torch.comm.topology import build_topology
    from repro_torch.tune import runtime as tune_runtime
    os.environ.setdefault(tune_runtime.ENV_TUNE, "cache")
    topo = build_topology(mesh, node_size=mesh.node_size)
    if tune_runtime.calibration_for(mesh, topo) is None:
        raise RuntimeError(
            f"--autotune: no tuning-cache entry for {mesh!r} (the dry run's "
            "fake group cannot probe; run `python -m repro_torch.tune` on "
            "the mesh first)")


def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             use_lsh=None, pipe: int = 1, autotune: bool = False,
             compile_it: bool = True) -> Dict:
    """One cell in this process, in a fake group of its own; a failure
    is recorded as ``error``."""
    multi = mesh_name == "multi"
    try:
        with fake_world((2 if multi else 1) * 256):
            mesh = make_production_mesh(multi_pod=multi, pipe=pipe)
            if autotune:
                _check_autotune(mesh)
            art = lower_cell(arch, shape_name, mesh, use_lsh=use_lsh,
                             compile_it=compile_it)
    except Exception as e:  # noqa: BLE001 -- record and continue
        art = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "error": f"{type(e).__name__}: {e}"}
    art["mesh_name"] = mesh_name
    gc.collect()
    return art


def _run_cell_args(a):
    return run_cell(*a[:3], **a[3])


def _indexed(ia):
    return ia[0], _run_cell_args(ia[1])


_LONG_ARCHS = ("xlstm-350m", "jamba-1.5-large-398b")


def _line(tag: str, art: Dict) -> str:
    if "skipped" in art:
        return f"SKIP {tag}: {art['skipped']}"
    if "error" in art:
        return f"FAIL {tag}: {art['error'][:300]}"
    return (f"OK   {tag}: trace={art['compile_s']}s dom={art['dominant']} "
            f"comp={art['compute_s']:.4f}s mem={art['memory_s']:.4f}s "
            f"coll={art['collective_s']:.4f}s "
            f"args/dev={art['arg_bytes'] / 2**30:.2f}GiB "
            f"temp/dev={art['temp_bytes'] / 2**30:.2f}GiB")


def run_cells(arch_list, shape_list, meshes, *, use_lsh=None,
              out: Optional[str] = None, autotune: bool = False,
              pipe: int = 1, workers: int = 1):
    """Every cell, in ``workers`` processes (1: this one); the records, in
    the order mesh, arch, shape, are written to ``out`` as they come."""
    cells = [(a, s, m, dict(use_lsh=use_lsh, pipe=pipe, autotune=autotune))
             for m in meshes for a in arch_list for s in shape_list]
    results: Dict[int, Dict] = {}
    with contextlib.ExitStack() as stack:
        if workers > 1:
            # the longest traces first: the per-step recurrences (sLSTM,
            # the Mamba chunks) over a long sequence, and training
            order = sorted(range(len(cells)), key=lambda i: (
                cells[i][0] not in _LONG_ARCHS,
                SHAPES[cells[i][1]].kind == "decode",
                SHAPES[cells[i][1]].kind == "prefill"))
            pool = stack.enter_context(multiprocessing.get_context(
                "spawn").Pool(workers, maxtasksperchild=1))
            arts = pool.imap_unordered(
                _indexed, [(i, cells[i]) for i in order])
        else:
            arts = ((i, _run_cell_args(c)) for i, c in enumerate(cells))
        for i, art in arts:
            print(_line("/".join(cells[i][:3]), art), flush=True)
            results[i] = art
            if out:
                os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
                with open(out, "w") as f:
                    json.dump([results[k] for k in sorted(results)], f,
                              indent=1)
    return [results[k] for k in sorted(results)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=ARCH_IDS)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=("single", "multi", "both"))
    ap.add_argument("--mesh-pipe", type=int, default=1,
                    help="carve a pipe axis of this extent out of the data "
                         "dimension of each mesh")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--lsh", default=None, choices=("on", "off"))
    ap.add_argument("--autotune", action="store_true",
                    help="plan from the tuning cache's entry for each mesh "
                         "(raises where there is none)")
    ap.add_argument("--workers", type=int,
                    default=max(1, min(7, (os.cpu_count() or 2) - 1)),
                    help="cells traced at once, a process each")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    use_lsh = None if args.lsh is None else (args.lsh == "on")
    archs = list(ARCH_IDS) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    t0 = time.time()
    results = run_cells(archs, shapes, meshes, use_lsh=use_lsh,
                        out=args.out, autotune=args.autotune,
                        pipe=args.mesh_pipe,
                        workers=min(args.workers,
                                    len(archs) * len(shapes) * len(meshes)))
    n_ok = sum(1 for r in results if "dominant" in r)
    n_skip = sum(1 for r in results if "skipped" in r)
    n_fail = sum(1 for r in results if "error" in r)
    print(f"\n== dry-run: {n_ok} ok, {n_skip} skipped, {n_fail} failed "
          f"in {time.time() - t0:.1f} s ==")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
