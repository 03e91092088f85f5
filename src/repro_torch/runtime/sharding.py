"""Mesh axes and the port's layout of tensors over them (counterpart of
``repro/runtime/sharding.py``).

The JAX package maps logical axes to mesh axes by rules (``RULES``,
``resolve``) and lets GSPMD place every tensor.  The port places them
itself, by the same rules:

  tokens         batch over the dp axes (pod, data), sequence over
                 ``model``: rank (d, m) holds [B / n_dp, S / model] (the
                 JAX residual stream's ("batch", "seq") sharding); with a
                 patch prefix the combined P + S sequence splits
                 (``shard_batch``);
  params         every leaf by its spec (runtime/params.py): FSDP over
                 ``data`` and heads / FFN hidden / vocabulary / experts
                 over ``model`` where the dimension divides, whole where
                 the rules say so or it does not divide; the same on
                 every pipe index.

A ``pod`` axis (the 512-rank production mesh, launch/mesh.py) carries
data parallelism as ``data`` does: the batch splits over (pod, data),
and the params are whole over it (the rules name it for "batch" only),
so every gradient is summed over it.

``parallelism_profile(True)`` switches ``resolve`` to the pure
data-parallel rules (``_DP_ONLY_RULES``, the JAX package's): the batch
over every axis, heads / FFN / vocabulary / experts whole, and the params
and moments still FSDP over ``data``.  ``params.model_specs`` takes the
profile from ``cfg.dp_only``.

A pipe axis (the 1F1B schedule, runtime/pipeline_schedule.py) partitions
the schedule, not the placement: every pipe index holds the same params
and the same rows (the batch shards over the dp axes only), so its ranks
compute the same thing.  A step's reductions (the gradient sums, the loss
and metrics, the MoE stats, the clip norm) therefore run over the
(data, model) slice of the rank's pipe index, ``all_group``; without a
pipe axis that is the whole mesh.

``mesh`` None is one card: every size is 1 and every group None.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Dict, List, Optional, Tuple

RULES = {
    "batch": ("pod", "data"),
    "seq": ("model",),
    "heads": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "fsdp": ("data",),
    "kv_seq": ("data",),
    None: (),
}

# Pure data parallelism: the batch over every axis, the weights whole
# over ``model``, params and moments still FSDP over ``data``.
_DP_ONLY_RULES = {
    "batch": ("pod", "data", "model"),
    "seq": (), "heads": (), "mlp": (), "vocab": (), "experts": (),
    "fsdp": ("data",),
    "kv_seq": ("data",),
    None: (),
}

_dp_only_var: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_dp_only", default=False)


def dp_only_active() -> bool:
    return _dp_only_var.get()


@contextlib.contextmanager
def parallelism_profile(dp_only: bool):
    """Switch ``resolve`` between ``RULES`` and ``_DP_ONLY_RULES``."""
    tok = _dp_only_var.set(bool(dp_only))
    try:
        yield
    finally:
        _dp_only_var.reset(tok)


def resolve(mesh, *logical) -> Tuple[Tuple[str, ...], ...]:
    """Logical axis names (a name, a tuple of names or None a dimension)
    -> one tuple of the mesh's axes a dimension, by the active profile's
    rules."""
    names = () if mesh is None else tuple(mesh.axis_names)
    rules = _DP_ONLY_RULES if dp_only_active() else RULES
    out = []
    for name in logical:
        phys: List[str] = []
        for n in ((name,) if name is None or isinstance(name, str)
                  else name):
            for ax in rules.get(n, ()):
                if ax in names and ax not in phys:
                    phys.append(ax)
        out.append(tuple(phys))
    return tuple(out)


def dp_axes(mesh) -> Tuple[str, ...]:
    """Axes carrying pure data parallelism: ("pod", "data") where the
    mesh has a pod axis, else ("data",)."""
    if mesh is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_size(mesh) -> int:
    return math.prod(axis_size(mesh, a) for a in dp_axes(mesh))


def dp_index(mesh) -> int:
    """This rank's row-major index over the dp axes."""
    idx = 0
    for a in dp_axes(mesh):
        idx = idx * axis_size(mesh, a) + axis_index(mesh, a)
    return idx


def axis_size(mesh, name: str) -> int:
    return 1 if mesh is None else mesh.axis_size(name)


def axis_index(mesh, name: str) -> int:
    return 0 if mesh is None else mesh.axis_index(name)


def num_ranks(mesh) -> int:
    return 1 if mesh is None else mesh.size


def group(mesh, axes) -> Optional[object]:
    """The process group over ``axes`` (a name or a tuple) holding this
    rank; None on one card or when the axes hold one rank."""
    return None if mesh is None else mesh.group(axes)


def model_group(mesh):
    return group(mesh, "model")


def dp_group(mesh):
    return group(mesh, dp_axes(mesh))


def all_group(mesh):
    """Every rank that shares this rank's work: the (pod, data, model)
    slice of its pipe index (the whole mesh when there is no pipe
    axis)."""
    return group(mesh, () if mesh is None else tuple(
        a for a in mesh.axis_names if a != "pipe"))


def world_group(mesh):
    """Every rank of the mesh, pipe indices included: for the agreements
    (stop, save) that every rank must make together."""
    return group(mesh, () if mesh is None else mesh.axis_names)


def pipe_group(mesh):
    return group(mesh, "pipe")


def token_slices(mesh, batch: int, seq: int) -> Tuple[slice, slice]:
    """Rank (d, m)'s (batch, sequence) slices of a [batch, seq] array (d
    the rank's index over the dp axes)."""
    n_dp = dp_size(mesh)
    mr = axis_size(mesh, "model")
    if batch % n_dp or seq % mr:
        raise ValueError(f"a [{batch}, {seq}] batch does not split over "
                         f"{n_dp} data ranks x {mr} model ranks (batch over "
                         "the dp axes, sequence over model)")
    d, m = dp_index(mesh), axis_index(mesh, "model")
    bl, sl = batch // n_dp, seq // mr
    return slice(d * bl, (d + 1) * bl), slice(m * sl, (m + 1) * sl)


def shard_batch(batch: Dict, mesh) -> Dict:
    """The rank's part of a global batch (numpy arrays or tensors), by the
    JAX package's ``batch_specs``: "tokens" and "labels" [B, S] by batch
    over the dp axes and by sequence over ``model``; "frames" [B, S_enc,
    H] by batch and its own sequence.  With "patch_embeds" [B, P, H] the
    residual stream is the combined P + S sequence, and that is what
    splits over ``model``: rank m holds its positions [m L, (m + 1) L), L
    = (P + S) / model, so the patch prefix lies on the first ranks (a rank
    past it holds its 0 patches) and the rank's tokens and labels are the
    token positions of its slice."""
    if mesh is None:
        return batch
    B, S = batch["tokens"].shape[:2]
    P = batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0
    bs, cs = token_slices(mesh, B, P + S)
    patches = slice(min(cs.start, P), min(cs.stop, P))
    tokens = slice(max(cs.start - P, 0), max(cs.stop - P, 0))
    out = {}
    for k, v in batch.items():
        if k == "patch_embeds":
            out[k] = v[bs, patches]
        elif k == "frames":
            out[k] = v[bs, token_slices(mesh, B, v.shape[1])[1]]
        else:
            out[k] = v[bs, tokens]
    return out


def dp_only_batch_axes(mesh, batch: int) -> Tuple[str, ...]:
    """The axes a batch of ``batch`` rows splits over under the pure
    data-parallel profile: as many mesh axes as divide it, trimmed from
    the right (the JAX package's ``bspec_for``)."""
    axes = list(mesh.axis_names)
    while axes and batch % math.prod(mesh.axis_size(a) for a in axes):
        axes.pop()
    return tuple(axes)


def dp_only_batch_slice(mesh, batch: int) -> slice:
    """The rank's rows under the pure data-parallel profile, over
    ``dp_only_batch_axes``; ranks past them hold a replica."""
    axes = dp_only_batch_axes(mesh, batch)
    n = math.prod(mesh.axis_size(a) for a in axes) if axes else 1
    idx = 0
    for a in axes:
        idx = idx * mesh.axis_size(a) + mesh.axis_index(a)
    rows = batch // n
    return slice(idx * rows, (idx + 1) * rows)
