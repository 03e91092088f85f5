"""The training step (counterpart of ``repro/runtime/step.py``).

  train_step(state, batch) -> (state, metrics)

forward + loss (models/model.py), gradients by autograd, then the shared
optimizer tail ``apply_gradients``: the warm-up-cosine learning rate, the
non-finite-loss skip and AdamW.  The state's params and moments are
updated in place (optim/adam.py); the returned state holds the same
tensors.

Over a (data, model) mesh (launch/mesh.py) every rank is handed the same
global batch and keeps its [B / data, S / model] part, and holds its
shard of every param (runtime/params.py).  Its loss is its share of the
global loss.  After autograd a gradient is complete over the axes its
leaf splits over: the FSDP gathers' reduce-scatters summed it over
``data``, and a leaf split over ``model`` read the whole sequence (or,
an expert, got the other model ranks' tokens through the all-to-all's
backward).  Over the axes it does not split over it holds the terms of
the rank's own tokens, so it is summed over those (``reduce_grads``: one
all-reduce a bucket for each set of axes); on a (data, pipe, model)
mesh the axes are those of the rank's pipe index, whose pipe indices
compute the same thing.  The clip norm is the logical gradient's
(``adam.global_norm``).
A ``pod`` axis is data parallelism as ``data`` is: every param is whole
over it, so every gradient is summed over it too.
``cfg.dp_only`` is the pure data-parallel profile (the JAX
``_DP_ONLY_RULES``): the batch over every rank, params and moments FSDP
over ``data`` only (``params.model_specs`` under the profile); each rank
gathers every leaf whole over ``data``, runs the mesh-free loss on its
rows, and the gradients are averaged over all ranks, reduce-scattered
over ``data`` to the rank's shards.

``microbatch=k`` accumulates gradients over the global batch's rows
[b * k, (b + 1) * k) in turn (cut over the mesh by ``shard_batch``), as
the JAX ``lax.scan``: each microbatch's loss / n and gradient / n added
in f32 in microbatch order, the metrics those of the last microbatch;
the replicated params' gradients are then summed over the ranks once.
``dp_only`` ignores it, as in JAX.  With ``ObsConfig`` on, the metrics
carry the in-graph ``obs_*`` scalars (models/model.py), the last
microbatch's under accumulation.  The fault-injection loss scale
(``CHAOS_LOSS_SCALE_KEY``, resilience/faults.py) multiplies the loss the
non-finite skip reads.

A mesh with a pipe axis runs the 1F1B staged step
(runtime/pipeline_schedule.py), which gives the bits of the accumulation
over ``cfg.pipeline_microbatches`` microbatches; ``dp_only`` and a pipe
axis are exclusive, as in JAX.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import DeviceLike
from repro_torch.comm import collectives
from repro_torch.configs.base import ModelConfig, OptimizerConfig
from repro_torch.convert import gather_params
from repro_torch.data.pipeline import place as batch_to_device  # noqa: F401
from repro_torch.models import model as model_lib
from repro_torch.optim.adam import (OptState, adamw_init, adamw_update,
                                    global_norm, leaves)
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime import params as params_lib
from repro_torch.runtime import sharding


class TrainState(NamedTuple):
    params: Any
    opt: OptState


# Fault injection (resilience/faults.py): a chaos run attaches this scalar
# to the batch; the step multiplies the loss by it before the non-finite
# skip, so an injected NaN takes the real skip path.  1.0 is an IEEE
# identity, and without the key the step runs the ops it runs without
# the hook (tests/test_torch_resilience.py pins both).
CHAOS_LOSS_SCALE_KEY = "_chaos_loss_scale"


def split_chaos_scale(batch: Dict) -> Tuple[Dict, Optional[Any]]:
    """Pop the loss scale off the batch (None, and the same batch object,
    when chaos is off)."""
    if CHAOS_LOSS_SCALE_KEY not in batch:
        return batch, None
    batch = dict(batch)
    return batch, batch.pop(CHAOS_LOSS_SCALE_KEY)


def apply_chaos_scale(loss: torch.Tensor, scale) -> torch.Tensor:
    """Scale the loss the skip reads; the gradients are left alone (the
    only scales injected are 1.0 and NaN, which discards them)."""
    if scale is None:
        return loss
    return loss * torch.as_tensor(scale, dtype=loss.dtype,
                                  device=loss.device).reshape(loss.shape)


def init_train_state(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                     seed: int = 0, device: DeviceLike = None,
                     mesh=None) -> TrainState:
    """With a mesh: this rank's shard of every param (``init_params``,
    runtime/params.py, by ``cfg.dp_only``'s profile) and of its
    moments."""
    params = model_lib.init_params(cfg, seed=seed, device=device, mesh=mesh)
    return TrainState(params, adamw_init(params, opt_cfg, _int8_splits(
        params, opt_cfg, mesh, mesh_specs(cfg, mesh),
        moment_specs(cfg, opt_cfg, mesh))))


def _int8_splits(params, opt_cfg: OptimizerConfig, mesh, specs, mspecs):
    """``params.int8_splits`` where the moments are int8 and the params
    split over a mesh, else None."""
    if opt_cfg.moment_dtype != "int8" or specs is None \
            or sharding.num_ranks(mesh) == 1:
        return None
    if mspecs is None:
        raise ValueError("int8 moments over a mesh need their specs "
                         "(moment_specs)")
    return params_lib.int8_splits(params, specs, mspecs, mesh)


def apply_gradients(state: TrainState, opt_cfg: OptimizerConfig,
                    loss: torch.Tensor, metrics: Dict, grads, *,
                    mesh=None, specs=None, mspecs=None
                    ) -> Tuple[TrainState, Dict]:
    """Shared optimizer tail of the whole-batch, accumulated and 1F1B
    steps: lr schedule, non-finite skip, AdamW; the metrics gain the clip
    norm ``grad_norm``.  With a mesh, ``loss`` is the global loss and the
    norm counts every rank's shard of a split leaf once (``specs``: the
    params' specs, ``mesh_specs`` of the config; None when nothing is
    split); int8 moments need theirs too (``mspecs``,
    ``moment_specs``)."""
    if specs is None and sharding.num_ranks(mesh) > 1:
        raise ValueError("apply_gradients over a mesh needs the params' "
                         "specs (mesh_specs) for the clip norm")
    lr = warmup_cosine(state.opt.step, opt_cfg.lr, opt_cfg.warmup_steps,
                       opt_cfg.total_steps)
    skip = ~torch.isfinite(loss)
    split = None if specs is None else [
        params_lib.split_axes(s, mesh)
        for s in params_lib.spec_leaves(state.params, specs)]
    gn = global_norm(grads, split, mesh)
    new_opt = adamw_update(state.params, grads, state.opt, opt_cfg, lr,
                           skip=skip, grad_norm=gn, splits=_int8_splits(
                               state.params, opt_cfg, mesh, specs, mspecs))
    metrics = dict(metrics, lr=lr, grad_norm=gn,
                   grad_skips=new_opt.grad_skips)
    return TrainState(state.params, new_opt), metrics


def mesh_specs(cfg: ModelConfig, mesh):
    """The params' specs over ``mesh`` (None without a mesh)."""
    if mesh is None:
        return None
    return params_lib.model_specs(cfg, mesh)


def moment_specs(cfg: ModelConfig, opt_cfg: OptimizerConfig, mesh):
    """The moments' specs over ``mesh`` (``params.model_moment_specs``;
    None without a mesh)."""
    if mesh is None:
        return None
    return params_lib.model_moment_specs(cfg, mesh, opt_cfg.moment_dtype)


def reduce_grads(grads, params, specs, mesh) -> None:
    """Sum each gradient (one a leaf of ``params``), IN PLACE, over the
    (data, model) axes its leaf does not split over (``params.sum_axes``;
    module docstring), one bucketed all-reduce for each set of axes."""
    if specs is None:
        return
    by_axes: Dict[Tuple[str, ...], list] = {}
    for g, s in zip(grads, params_lib.spec_leaves(params, specs)):
        axes = params_lib.sum_axes(s, mesh)
        if g is not None and axes:
            by_axes.setdefault(axes, []).append(g)
    for axes, gs in by_axes.items():
        collectives.all_reduce_sum_(gs, mesh.group(axes))


def _grads(params, loss: torch.Tensor):
    """One gradient per leaf of ``params``: autograd's for a floating leaf
    (zeros where it has none: the detached hash rotations, as JAX gives
    them), None for an integer leaf."""
    ps = leaves(params)
    trainable = [p for p in ps if p.is_floating_point()]
    got = iter(torch.autograd.grad(loss, trainable, allow_unused=True))
    grads = []
    for p in ps:
        g = next(got) if p.is_floating_point() else None
        if g is None and p.is_floating_point():
            g = torch.zeros_like(p)
        grads.append(g)
    return grads


def _loss_and_grads(params, cfg: ModelConfig, batch: Dict,
                    use_lsh: Optional[bool], mesh):
    for p in leaves(params):
        if p.is_floating_point():
            p.requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = model_lib.loss_fn(params, cfg, batch,
                                          use_lsh=use_lsh, mesh=mesh)
        grads = _grads(params, loss)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_accum_grad_fn(cfg: ModelConfig, *, use_lsh: Optional[bool] = None,
                       microbatch: int = 0, mesh=None):
    """accum_grads(params, batch) -> (loss, metrics, grads): the global
    loss, the metrics, and one gradient per leaf of ``params`` (None for
    an integer leaf), the replicated params' summed over the ranks.
    ``microbatch`` k > 0 accumulates over the batch in rows of k (the
    gradients then come in f32)."""
    specs = mesh_specs(cfg, mesh)

    def one(params, rows: Dict):
        local = sharding.shard_batch(rows, mesh)
        _, metrics, grads = _loss_and_grads(params, cfg, local, use_lsh,
                                            mesh)
        return metrics["loss"], metrics, grads

    def accum_grads(params, batch: Dict):
        if not microbatch:
            loss, metrics, grads = one(params, batch)
        else:
            B = batch["tokens"].shape[0]
            if B % microbatch:
                raise ValueError(f"a batch of {B} rows does not split into "
                                 f"microbatches of {microbatch}")
            n = B // microbatch
            loss = grads = None
            for b in range(n):
                rows = {k: v[b * microbatch:(b + 1) * microbatch]
                        for k, v in batch.items()}
                l, metrics, g = one(params, rows)
                if grads is None:
                    loss = torch.zeros((), dtype=torch.float32,
                                       device=l.device)
                    grads = [None if x is None else torch.zeros_like(
                        x, dtype=torch.float32) for x in g]
                loss = loss + l / n
                for a, x in zip(grads, g):
                    if x is not None:
                        a.add_(x.to(torch.float32) / n)
                del g         # free them before the next backward's
        reduce_grads(grads, params, specs, mesh)
        return loss, metrics, grads

    return accum_grads


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                    use_lsh: Optional[bool] = None, microbatch: int = 0,
                    mesh=None):
    """Returns train_step(state, batch) -> (state, metrics); batch holds
    "tokens" and "labels" [B, S] integer tensors on the params' device
    (and "patch_embeds" [B, P, H] or "frames" [B, S_enc, H] where the
    config takes them: every split cuts them with the rows), the global
    batch (the same on every rank) when there is a mesh, and
    the chaos loss scale when a fault plan injects one.  A mesh with a
    pipe axis takes the 1F1B step (``microbatch`` is then
    ``cfg.pipeline_microbatches``' business)."""
    if mesh is not None and sharding.axis_size(mesh, "pipe") > 1:
        if cfg.dp_only:
            raise NotImplementedError(
                "dp_only and a pipe axis are mutually exclusive profiles")
        from repro_torch.runtime.pipeline_schedule import \
            make_pipeline_train_step
        return make_pipeline_train_step(cfg, opt_cfg, mesh, use_lsh=use_lsh)
    if cfg.dp_only and sharding.num_ranks(mesh) > 1:
        return _make_dp_only_train_step(cfg, opt_cfg, mesh, use_lsh=use_lsh)
    accum_grads = make_accum_grad_fn(cfg, use_lsh=use_lsh,
                                     microbatch=microbatch, mesh=mesh)
    specs = mesh_specs(cfg, mesh)
    mspecs = moment_specs(cfg, opt_cfg, mesh)

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        batch, chaos_scale = split_chaos_scale(batch)
        loss, metrics, grads = accum_grads(state.params, batch)
        loss = apply_chaos_scale(loss, chaos_scale)
        return apply_gradients(state, opt_cfg, loss, metrics, grads,
                               mesh=mesh, specs=specs, mspecs=mspecs)

    return train_step


def _dp_only_grads(grads, specs, mesh, n: int) -> list:
    """Whole gradients -> the rank's shards of their mean over every rank:
    a leaf split over ``data`` reduce-scattered over it, then summed over
    the other axes; a whole leaf summed over every rank (one bucketed
    all-reduce a set of axes)."""
    world = sharding.all_group(mesh)
    rest = tuple(a for a in mesh.axis_names if a not in ("data", "pipe"))
    out, by_group = [], {}
    for g, spec in zip(grads, specs):
        dims = [d for d, axes in enumerate(spec) if "data" in axes]
        if g is not None and dims:
            g = collectives.raw_reduce_scatter(
                g, sharding.group(mesh, "data"), dims[0])
            by_group.setdefault(rest, []).append(g)
        elif g is not None:
            by_group.setdefault(None, []).append(g)
        out.append(g)
    for axes, gs in by_group.items():
        collectives.all_reduce_sum_(
            gs, world if axes is None else sharding.group(mesh, axes))
    return [None if g is None else g / n for g in out]


def _make_dp_only_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                             mesh, *, use_lsh: Optional[bool]):
    """The JAX ``_make_dp_only_train_step``: each rank gathers its params
    whole over ``data``, runs the mesh-free loss on its rows of the batch
    (over as many axes as divide it, ``sharding.dp_only_batch_slice``),
    then the gradients (to the rank's shards, ``_dp_only_grads``), the
    loss and the metrics are averaged over every rank."""
    world = sharding.all_group(mesh)
    n = collectives.group_size(world)
    specs = mesh_specs(cfg, mesh)
    mspecs = moment_specs(cfg, opt_cfg, mesh)

    def mean(t: torch.Tensor) -> torch.Tensor:
        return collectives.all_reduce_sum(t, world) / n

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        batch, chaos_scale = split_chaos_scale(batch)
        rows = sharding.dp_only_batch_slice(mesh, batch["tokens"].shape[0])
        local = {k: v[rows] for k, v in batch.items()}
        whole = gather_params(state.params, mesh, specs)
        loss, metrics, grads = _loss_and_grads(whole, cfg, local, use_lsh,
                                               None)
        del whole
        grads = _dp_only_grads(grads, params_lib.spec_leaves(
            state.params, specs), mesh, n)
        metrics = {k: mean(v) for k, v in metrics.items()}
        loss = apply_chaos_scale(mean(loss), chaos_scale)
        return apply_gradients(state, opt_cfg, loss, metrics, grads,
                               mesh=mesh, specs=specs, mspecs=mspecs)

    return train_step


def make_prefill_step(cfg: ModelConfig, mesh=None):
    def prefill_step(params, batch: Dict):
        return model_lib.prefill(params, cfg, batch, mesh=mesh)
    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None):
    def decode_step(params, state: Dict, tokens: torch.Tensor):
        return model_lib.decode_step(params, cfg, state, tokens, mesh=mesh)
    return decode_step
