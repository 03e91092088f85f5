"""Where every param and moment leaf lies over the mesh (counterpart of
``repro/runtime/params.py``).

Each leaf's path maps to logical axes (``_MATRIX_RULES``,
``_VECTOR_RULES``, ``_REPLICATED``, ``_leaf_logical``), which
runtime/sharding.py's table resolves to mesh axes; a dimension that does
not divide over its axes stays whole (``_divisible``).  So, over a
(data, model) mesh:

  attention / Mamba / mLSTM / sLSTM input projections  [H / data, D / model]
  their output projections                           [D / model, H / data]
  the dense FFN                  w_up, w_gate [H / data, F / model],
                                 w_down [F / model, H / data]
  the experts                    [E_pad / model, X / data, Y]
  the embedding table            [V / model, H]
  the untied head                [H / data, V / model]
  the Mamba head vectors         [nh / model], conv_w [W, d_inner / model]
  norms' scales, the router, the hash rotations, the placement: whole.

A spec is a plain tuple with one entry a dimension: the tuple of mesh
axes that dimension splits over (``()``: whole).  The JAX package stacks
the blocks [num_super_blocks, ...] under ``blocks`` and prepends a None
for that dimension; the port's ``layers[i]`` is one block, so its specs
are the JAX ones without it (the encoder's ``layers`` likewise).

``param_specs`` reads the leaves' logical (whole) shapes: pass the full
params, or ``model_specs(cfg, mesh)``, which builds them on the meta
device.  The AdamW moments lie by ``moment_specs``, the JAX package's
rule: a float moment as its param; an int8 moment's ``q`` (the param's
shape, the last dimension padded to a multiple of 128) by the param's
rule on that padded dimension, and its ``scale`` [..., blocks] whole
along the last dimension.  Its blocks of 128 run along the logical last
dimension, so where that dimension splits they cross the ranks' shards:
``int8_splits`` tells optim/adam.py which leaves' moments it quantizes
over the split (``model_moment_specs``, ``train_state_specs``).

``shard`` cuts a whole leaf to this rank's block; ``gather`` (with a
gradient where asked) puts the blocks together again, over ``data`` then
``model``, so that it inverts ``shard`` (a tree at a time:
``convert.shard_params`` / ``gather_params``).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.comm import collectives
from repro_torch.runtime import sharding

Spec = Tuple[Tuple[str, ...], ...]

_MATRIX_RULES = {
    "wq": ("fsdp", "heads"), "wk": ("fsdp", "heads"), "wv": ("fsdp", "heads"),
    "wo": ("heads", "fsdp"),
    "w_z": ("fsdp", "heads"), "w_x": ("fsdp", "heads"),
    "w_dt": ("fsdp", "heads"), "w_b": ("fsdp", None), "w_c": ("fsdp", None),
    "w_out": ("heads", "fsdp"),
    "w_q": ("fsdp", "heads"), "w_k": ("fsdp", "heads"), "w_v": ("fsdp", "heads"),
    "w_if": ("fsdp", "heads"),
    "w_gates": ("fsdp", "heads"), "r_gates": ("fsdp", "heads"),
    "conv_w": (None, "heads"),
}
_VECTOR_RULES = {
    "dt_bias": ("heads",), "a_log": ("heads",), "d_skip": ("heads",),
    "b_if": ("heads",), "b_gates": ("heads",),
}
_REPLICATED = {"router_w", "lsh_rot", "placement", "scale"}

# an int8 moment's block along the last dimension (optim/adam.py)
_QBLOCK = 128


def _leaf_logical(names, ndim: int) -> tuple:
    """The logical axes of a per-layer (unstacked) leaf of ``ndim``
    dimensions at the path ``names``."""
    last = names[-1]
    if last == "table":                           # embedding [V, H]
        base = ("vocab", None)
    elif last == "w" and "head" in names:         # lm head [H, V]
        base = ("fsdp", "vocab")
    elif last in _REPLICATED:
        base = (None,) * ndim
    elif last in ("w_up", "w_gate", "w_down"):
        if ndim == 3:                             # MoE experts [E, ., .]
            base = ("experts", "fsdp", None)
        else:                                     # dense [H, F] / [F, H]
            base = ("fsdp", "mlp") if last != "w_down" else ("mlp", "fsdp")
    elif last in _MATRIX_RULES:
        base = _MATRIX_RULES[last]
    elif last in _VECTOR_RULES:
        base = _VECTOR_RULES[last]
    else:
        base = (None,) * ndim
    if len(base) != ndim:                         # replicate on a mismatch
        base = (None,) * ndim
    return base


def _divisible(spec: Spec, shape, mesh) -> Spec:
    """Each entry's axes, trimmed from the right until their product
    divides the dimension (the JAX rule: arguments must split evenly)."""
    out = []
    for i, axes in enumerate(spec):
        axes = list(axes)
        while axes and shape[i] % math.prod(sharding.axis_size(mesh, a)
                                            for a in axes):
            axes.pop()
        out.append(tuple(axes))
    return tuple(out)


def leaf_spec(names, shape, mesh) -> Spec:
    """The spec of a leaf of logical ``shape`` at the path ``names``."""
    return _divisible(sharding.resolve(mesh, *_leaf_logical(
        names, len(shape))), tuple(shape), mesh)


def _walk(tree: Any, fn, names: Tuple = ()):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _walk(v, fn, names + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, fn, names + (f"#{i}",)) for i, v in enumerate(tree)]
    return fn(names, tree)


def param_specs(params: Any, mesh, prefix: Tuple[str, ...] = ()) -> Any:
    """One spec a leaf of ``params`` (tensors of their logical shapes; a
    MoE layer's experts padded to the model axis), same structure;
    ``prefix`` is the path of ``params`` in the whole tree (the head's
    ``("head",)``)."""
    return _walk(params, lambda n, t: leaf_spec(n, t.shape, mesh),
                 tuple(prefix))


def moment_specs(params: Any, mesh, moment_dtype: str) -> Any:
    """The JAX package's specs of the AdamW moments of ``params``: the
    param's for a float moment, ``{"q", "scale"}`` for an int8 one, None
    for an integer leaf (no moment)."""
    def one(names, t):
        if not t.is_floating_point():
            return None
        spec = leaf_spec(names, t.shape, mesh)
        if moment_dtype != "int8":
            return spec
        q_shape = tuple(t.shape[:-1]) + (-(-t.shape[-1] // _QBLOCK)
                                         * _QBLOCK,)
        q = _divisible(sharding.resolve(mesh, *_leaf_logical(
            names, t.dim())), q_shape, mesh)
        scale = q[:-1] + ((),) if q else ()
        return {"q": q, "scale": scale}
    return _walk(params, one)


def train_state_specs(cfg, mesh, moment_dtype: str):
    """The spec tree of ``cfg``'s ``TrainState`` over ``mesh``: the
    params' ``model_specs``, each moment's ``model_moment_specs``, the
    step and skip count whole (``dp_only``: the pure data-parallel
    profile's specs, FSDP over ``data``).  None without a mesh."""
    from repro_torch.optim.adam import OptState
    from repro_torch.runtime.step import TrainState
    if mesh is None:
        return None
    m = model_moment_specs(cfg, mesh, moment_dtype)
    return TrainState(model_specs(cfg, mesh), OptState((), m, m, ()))


def _meta_params(cfg, mesh):
    from repro_torch.models import model as model_lib
    return model_lib.logical_params(cfg, mesh)


def _shape_mesh(shape: Tuple[Tuple[str, int], ...]):
    from repro_torch.launch.mesh import Mesh
    return Mesh(tuple(s for _, s in shape), axes=tuple(a for a, _ in shape))


@functools.lru_cache(maxsize=32)
def _model_specs(cfg, shape: Tuple[Tuple[str, int], ...]):
    mesh = _shape_mesh(shape)
    with sharding.parallelism_profile(cfg.dp_only):
        return param_specs(_meta_params(cfg, mesh), mesh)


def model_specs(cfg, mesh) -> Any:
    """``param_specs`` of ``cfg``'s params over ``mesh``, from their
    shapes on the meta device, under the profile of ``cfg.dp_only``;
    cached."""
    return _model_specs(cfg, tuple(mesh.shape.items()))


@functools.lru_cache(maxsize=32)
def _model_moment_specs(cfg, shape: Tuple[Tuple[str, int], ...],
                        moment_dtype: str):
    mesh = _shape_mesh(shape)
    with sharding.parallelism_profile(cfg.dp_only):
        return moment_specs(_meta_params(cfg, mesh), mesh, moment_dtype)


def model_moment_specs(cfg, mesh, moment_dtype: str) -> Any:
    """``moment_specs`` of ``cfg``'s params over ``mesh``; cached."""
    return _model_moment_specs(cfg, tuple(mesh.shape.items()), moment_dtype)


class Int8Split(NamedTuple):
    """An int8 moment whose logical last dimension (``size`` entries)
    splits over the mesh, for its param (``p``) or its ``q`` (``q``):
    each spec keeps the split of the last dimension only."""
    mesh: Any
    p: Spec
    q: Spec
    size: int

    @property
    def aligned(self) -> bool:
        """The rank's q holds its param's elements, no more: both split
        alike and no padding."""
        return self.p == self.q and self.size % _QBLOCK == 0


def int8_splits(params: Any, specs: Any, mspecs: Any, mesh) -> list:
    """For each leaf of ``params`` (the rank's shards, placed by
    ``specs``; ``mspecs`` the int8 ``moment_specs``), in
    ``optim.adam.leaves`` order: its ``Int8Split`` where its param or its
    ``q`` splits the last dimension over more than one rank, else None
    (the rank then quantizes its own rows whole, as one card does)."""
    out: list = []

    def last(spec: Spec) -> Spec:
        return ((),) * (len(spec) - 1) + (spec[-1],)

    def one(t, spec, mspec):
        split = None
        if t.is_floating_point():
            p, q = last(spec), last(mspec["q"])
            if split_axes(p, mesh) or split_axes(q, mesh):
                split = Int8Split(mesh, p, q,
                                  logical_shape(t.shape, spec, mesh)[-1])
        out.append(split)
    _zip_specs(one, params, specs, mspecs)
    return out


# ------------------------------------------------ cutting and gathering --

def _split_dims(spec: Spec):
    """(dim, axis) of every split, dims in order and a dim's axes in
    order: the order ``shard`` cuts in."""
    return [(d, a) for d, axes in enumerate(spec) for a in axes]


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    out = list(shape)
    for d, a in _split_dims(spec):
        out[d] //= sharding.axis_size(mesh, a)
    return tuple(out)


def logical_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    out = list(shape)
    for d, a in _split_dims(spec):
        out[d] *= sharding.axis_size(mesh, a)
    return tuple(out)


def block(axes: Tuple[str, ...], mesh, n: int) -> Tuple[int, int]:
    """(start, size) of this rank's block of a dimension of ``n``
    entries split over ``axes``: block ``i`` of the axes' row-major
    index."""
    k = math.prod(sharding.axis_size(mesh, a) for a in axes)
    idx = 0
    for a in axes:
        idx = idx * sharding.axis_size(mesh, a) + sharding.axis_index(mesh, a)
    return idx * (n // k), n // k


def shard(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the whole leaf ``t`` (a view) along each
    split dimension (``block``)."""
    for d, axes in enumerate(spec):
        if axes:
            t = t.narrow(d, *block(axes, mesh, t.shape[d]))
    return t


def gather(t: torch.Tensor, spec: Spec, mesh,
           grad: bool = False) -> torch.Tensor:
    """The whole leaf from this rank's block, the inverse of ``shard``: a
    collective over each dimension's axes (all of them at once), the
    dimensions split over ``data`` first.  ``grad``: each
    all-gather's backward is its reduce-scatter, so the leaf's gradient
    comes back summed over those axes."""
    order = [(d, axes) for d, axes in enumerate(spec) if axes]
    for d, axes in sorted(order, key=lambda da: "data" not in da[1]):
        if math.prod(sharding.axis_size(mesh, a) for a in axes) > 1:
            # one gather over all of the dimension's axes: the group's
            # rank order is their row-major index, ``block``'s
            group = sharding.group(mesh, axes)
            t = collectives.AllGather.apply(t, group, d) if grad else \
                collectives.raw_all_gather(t, group, d)
    return t


def _zip_specs(fn, tree: Any, *specs: Any) -> Any:
    """``fn(leaf, *its specs)`` over the leaves of ``tree``, each spec
    tree matched to it by key (None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _zip_specs(fn, v, *(s[k] for s in specs))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zip_specs(fn, v, *s) for v, *s in zip(tree, *specs)]
    return fn(tree, *specs)


def map_specs(fn, tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over the leaves of ``tree`` (None stays None)."""
    return _zip_specs(fn, tree, specs)


def spec_leaves(params: Any, specs: Any) -> list:
    """The spec of every leaf of ``params``, in ``optim.adam.leaves``
    order: matched by key, so a tree whose dicts hold their keys in
    another order (``params_from_jax``'s, sorted as JAX keeps them) reads
    its own leaves' specs."""
    out: list = []
    map_specs(lambda t, s: out.append(s), params, specs)
    return out


def flat_specs(specs: Any, prefix: str = "") -> Dict[str, Spec]:
    """{key: spec} of a spec tree, keyed as the checkpoint keys its
    leaves (dict key, ``#i`` of a list entry, a NamedTuple's field
    name); a spec tuple is a leaf."""
    if specs is None:
        return {}
    if hasattr(specs, "_fields"):
        items = [(f, getattr(specs, f)) for f in specs._fields]
    elif isinstance(specs, dict):
        items = list(specs.items())
    elif isinstance(specs, list):
        items = [(f"#{i}", v) for i, v in enumerate(specs)]
    else:
        return {prefix[:-1]: specs}
    out: Dict[str, Spec] = {}
    for k, v in items:
        out.update(flat_specs(v, f"{prefix}{k}/"))
    return out


_STEP_AXES = ("pod", "data", "model")


def sum_axes(spec: Spec, mesh) -> Tuple[str, ...]:
    """The (pod, data, model) axes a gradient of ``spec`` is still summed
    over after autograd: those it does not split over (over the ones it
    splits over, the gathers' reduce-scatters summed it)."""
    split = {a for axes in spec for a in axes}
    return tuple(a for a in _STEP_AXES
                 if a not in split and sharding.axis_size(mesh, a) > 1)


def split_axes(spec: Spec, mesh) -> Tuple[str, ...]:
    """The axes of more than one rank that ``spec`` splits over."""
    split = {a for axes in spec for a in axes}
    return tuple(a for a in _STEP_AXES
                 if a in split and sharding.axis_size(mesh, a) > 1)


def local_bytes(params: Any, specs: Any, mesh) -> int:
    """The bytes a rank holds of ``params`` (whole leaves, on any device,
    the meta device included) placed by ``specs``."""
    total = 0

    def add(t, spec):
        nonlocal total
        total += math.prod(local_shape(t.shape, spec, mesh)) \
            * t.element_size()
        return None
    map_specs(add, params, specs)
    return total


# ---------------------------------------------- batches and decode state --

def batch_specs(cfg, mesh) -> Dict[str, Spec]:
    """The JAX package's ``batch_specs``: "tokens" and "labels" [B, S] by
    batch, "frames" [B, S_enc, H] by batch and sequence, "patch_embeds"
    [B, P, H] by batch, under the active profile's rules (a dimension
    that does not divide stays whole: ``_divisible`` on the shapes)."""
    tok = sharding.resolve(mesh, "batch", None)
    out = {"tokens": tok, "labels": tok}
    if cfg.encoder_decoder:
        out["frames"] = sharding.resolve(mesh, "batch", "seq", None)
    if cfg.frontend == "patch_stub":
        out["patch_embeds"] = sharding.resolve(mesh, "batch", None, None)
    return out


def decode_state_specs(cfg, batch: int, mesh, max_len: int = 0) -> Dict:
    """The JAX package's ``decode_state_specs``: how it lays out the
    decode state, one dict of specs a layout entry (a layer's state,
    without JAX's stacked leading dimension) and the position.  Big-batch
    decode (the batch divides over the dp axes): batch over them, the
    cache's sequence over ``model``; batch 1: the sequence over (dp axes,
    model).  The port's decode state lies by it (``decode_layout``)."""
    dp = sharding.dp_axes(mesh)
    n_dp = sharding.dp_size(mesh)
    n_model = sharding.axis_size(mesh, "model")

    def ok(n, size):
        return size > 0 and n > 0 and size % n == 0

    big_batch = ok(n_dp, batch)
    bspec = dp if big_batch else ()
    if big_batch:
        seq = ("model",) if ok(n_model, max_len) else ()
    elif ok(n_dp * n_model, max_len):
        seq = dp + ("model",)
    elif ok(n_dp, max_len):
        seq = dp
    else:
        seq = ()

    def maybe(dim):
        return ("model",) if ok(n_model, dim) else ()

    dh = cfg.resolved_head_dim
    d_inner = cfg.ssm.expand * cfg.d_model
    nh_m = d_inner // cfg.ssm.head_dim
    d_in_x = int(cfg.xlstm.mlstm_proj_factor * cfg.d_model)
    d_in_x -= d_in_x % dh
    nh_x = d_in_x // dh
    entries = []
    for mixer, _ in cfg.layout:
        if mixer == "attn":
            if "model" in seq:
                head, dhs = (), ()          # model already on the sequence
            else:
                head = maybe(cfg.num_kv_heads)
                dhs = () if head else maybe(dh)
            kv = (bspec, seq, head, dhs)
            st = {"k": kv, "v": kv}
            if cfg.encoder_decoder:
                st.update(cross_k=kv, cross_v=kv)
        elif mixer == "mamba":
            st = {"h": (bspec, maybe(nh_m), (), ()),
                  "conv": (bspec, (), maybe(d_inner))}
        elif mixer == "mlstm":
            hs = maybe(nh_x)
            ds = () if hs else maybe(dh)
            st = {"C": (bspec, hs, ds, ()), "n": (bspec, hs, ds),
                  "m": (bspec, hs)}
        elif mixer == "slstm":
            st = {n: (bspec, maybe(cfg.d_model)) for n in ("c", "n", "h",
                                                          "m")}
        else:
            st = {}
        entries.append(st)
    return {"entries": entries, "position": ()}


def decode_layout(cfg, batch: int, mesh, max_len: int, shapes) -> Dict:
    """This rank's block of the decode state laid out by
    ``decode_state_specs(cfg, batch, mesh, max_len)``, as plain Python
    values (models/model.init_decode_state keeps it in the state).
    ``shapes``: each layer's {leaf: whole shape} (the port's per-layer
    state; layer i is layout entry i % len(cfg.layout)).

      "specs", "shapes"  each layer's {leaf: spec} and {leaf: local
                         shape};
      "rows"             (start, count) of the rank's batch rows;
      "seq_axes"         the attention caches' sequence axes: ("model",),
                         dp axes + ("model",), dp axes or ();
      "seq_blocks", "seq_offset"  their rank count, and the global index
                         of the rank's first cache row: block i of the
                         axes' row-major (pod, data, model) index, so the
                         sequence group's rank r holds JAX's shard r;
      "kv_axes", "dh_axes"  the axes of the caches' kv heads or head
                         dimension (``model`` where it is not on the
                         sequence and the width divides);
      "mamba_axes"       the axes of the Mamba heads of ``h`` and the
                         channels of ``conv``;
      "mlstm_axes", "mlstm_split"  the axes of the mLSTM state's split
                         and what they split: "heads" (``C``, ``n``,
                         ``m`` by heads), "dh" (``C`` and ``n`` on their
                         first head-dimension index, ``m`` whole) or "";
      "slstm_axes"       the axes of the sLSTM state's width.
    """
    specs = decode_state_specs(cfg, batch, mesh, max_len)
    out: Dict[str, Any] = {"specs": [], "shapes": [], "rows": (0, batch),
                           "seq_axes": (), "kv_axes": (), "dh_axes": (),
                           "mamba_axes": (), "mlstm_axes": (),
                           "mlstm_split": "", "slstm_axes": ()}
    for i, leaves in enumerate(shapes):
        mixer = cfg.layout[i % len(cfg.layout)][0]
        entry = specs["entries"][i % len(cfg.layout)]
        lspecs = {k: _divisible(entry[k], tuple(shape), mesh)
                  for k, shape in leaves.items()}
        if mixer == "attn":
            rows, seq, kv, dh = lspecs["k"]
            out.update(seq_axes=seq, kv_axes=kv, dh_axes=dh)
        elif mixer == "mamba":
            rows = lspecs["h"][0]
            if lspecs["h"][1] != lspecs["conv"][2]:
                raise ValueError(
                    f"Mamba decode state: {cfg.ssm.expand * cfg.d_model} "
                    f"channels split over {lspecs['conv'][2]}, their heads "
                    f"over {lspecs['h'][1]}")
            out["mamba_axes"] = lspecs["h"][1]
        elif mixer == "mlstm":
            rows, heads, dhs = lspecs["C"][:3]
            out.update(mlstm_axes=heads or dhs, mlstm_split="heads" if heads
                       else "dh" if dhs else "")
        else:
            rows, out["slstm_axes"] = lspecs["h"]
        out["rows"] = block(rows, mesh, batch)
        out["specs"].append(lspecs)
        out["shapes"].append({k: local_shape(s, lspecs[k], mesh)
                              for k, s in leaves.items()})
    start, size = block(out["seq_axes"], mesh, max_len)
    out.update(seq_blocks=max_len // size, seq_offset=start)
    return out
