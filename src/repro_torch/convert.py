"""JAX param pytree -> the port's params, and the port's params over a
mesh.

The caller hands over the JAX package's params with numpy leaves (for
example ``jax.tree.map(np.asarray, params)``); this module imports neither
JAX nor ``repro``.  bfloat16 leaves arrive as ``ml_dtypes.bfloat16`` arrays,
which ``torch.from_numpy`` rejects, so they travel as their uint16 bits and
are viewed as ``torch.bfloat16`` again.

JAX stores ``blocks`` as one entry per layout position, each stacked
[num_super_blocks, ...]; the port's ``layers`` list is super-block major with
the layout interleaved inside (models/model.py), the order the JAX scan runs
the blocks in.

``shard_params`` cuts full params to a rank's part, every leaf by its
spec (the JAX package's ``param_specs``: runtime/params.py), and
``gather_params`` puts the ranks' parts together again.

``state_from_jax`` carries a whole JAX ``TrainState`` (params and the
AdamW state, int8 moments included), and ``load_jax_checkpoint``
restores a checkpoint directory the JAX package wrote (zlib shards, keys
like ``params/blocks/#0/...`` stacked over super-blocks) into the port's
``TrainState``, so a run moved off the TPU resumes here.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.runtime import params as params_lib


def tensor_from_numpy(a: Any, device: torch.device) -> torch.Tensor:
    if a is None:
        return None
    a = np.array(a, order="C")          # a copy; a 0-d array stays 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _map(tree: Any, fn) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _index(tree: Any, i: int) -> Any:
    return _map(tree, lambda a: np.asarray(a)[i])


def _layers(blocks) -> List[Dict]:
    """JAX ``blocks`` (one entry per layout position, stacked over
    super-blocks) -> the port's ``layers``, super-block major."""
    blocks = list(blocks)
    n_super = np.asarray(next(_leaves(blocks[0]))).shape[0] if blocks else 0
    return [_index(blocks[i], sb) for sb in range(n_super)
            for i in range(len(blocks))]


def params_from_jax(tree: Dict, *, device: DeviceLike = None) -> Dict:
    """The JAX ``init_params`` pytree (numpy leaves) -> port params on
    ``device`` (the CUDA device unless "cpu" is asked for).  An
    encoder-decoder's ``encoder`` {"blocks", "final_norm"} becomes
    {"layers", "final_norm"} the same way; the decoder layers' ``cross`` /
    ``cross_norm`` leaves come along with the rest of each layer."""
    dev = resolve_device(device)
    out = {k: v for k, v in tree.items() if k != "blocks"}
    out["layers"] = _layers(tree["blocks"])
    if "encoder" in out:
        enc = dict(out["encoder"])
        enc["layers"] = _layers(enc.pop("blocks"))
        out["encoder"] = enc
    return _map(out, lambda a: tensor_from_numpy(a, dev))


def state_from_jax(state: Any, *, device: DeviceLike = None):
    """A JAX ``TrainState(params, OptState(step, m, v, grad_skips))`` with
    numpy leaves -> the port's ``TrainState``: params and moments as
    ``params_from_jax`` lays them out (an int8 moment stays a {"q",
    "scale"} dict, the integer leaves' moments None), the step on the
    host as the port keeps it, the skip count on ``device``."""
    from repro_torch.optim.adam import OptState
    from repro_torch.runtime.step import TrainState
    dev = resolve_device(device)
    params, opt = state
    return TrainState(
        params_from_jax(params, device=dev),
        OptState(tensor_from_numpy(np.asarray(opt.step, np.int32),
                                   torch.device("cpu")),
                 params_from_jax(opt.m, device=dev),
                 params_from_jax(opt.v, device=dev),
                 tensor_from_numpy(np.asarray(opt.grad_skips, np.int32),
                                   dev)))


_BLOCK_KEY = re.compile(r"^(.*?)blocks/#(\d+)/(.*)$")


def jax_checkpoint_layout(arrays: Dict) -> Dict:
    """A JAX checkpoint's {key: (array, dtype)} in the port's keys: each
    ``pre/blocks/#i/rest`` entry, stacked [num_super_blocks, ...], becomes
    ``pre/layers/#(sb * n + i)/rest`` = its row sb (a view), n the number
    of entries under that prefix: the decoder's layout length under
    ``params/`` and ``opt/m/``, 1 under ``params/encoder/``."""
    n_layout: Dict[str, int] = {}
    for m in filter(None, map(_BLOCK_KEY.match, arrays)):
        n_layout[m.group(1)] = max(n_layout.get(m.group(1), 0),
                                   int(m.group(2)) + 1)
    out = {}
    for key, (arr, dtype) in arrays.items():
        m = _BLOCK_KEY.match(key)
        if m is None:
            out[key] = (arr, dtype)
            continue
        pre, i, rest = m.group(1), int(m.group(2)), m.group(3)
        for sb in range(arr.shape[0]):
            out[f"{pre}layers/#{sb * n_layout[pre] + i}/{rest}"] = (
                arr[sb], dtype)
    return out


def load_jax_checkpoint(directory: str, template, *, step=None, mesh=None,
                        specs=None):
    """Restore the newest (or ``step``'s) committed checkpoint of a JAX
    run into ``template``, a port ``TrainState`` of the same config ->
    (state, step, extra); the same digests, quarantine and fallback as
    the port's own (checkpoint/checkpoint.py)."""
    from repro_torch.checkpoint.checkpoint import load_checkpoint
    return load_checkpoint(directory, template, step=step, mesh=mesh,
                           specs=specs, remap=jax_checkpoint_layout)


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def shard_params(params: Dict, mesh, specs: Any = None) -> Dict:
    """Full port params (``params_from_jax``, or ``init_params`` without
    a mesh) -> this rank's part: each leaf cut by its spec (``specs``, or
    ``param_specs`` of ``params``: a MoE layer's E_pad must split over
    the model axis, as the JAX ``init_params`` on the same mesh pads
    it), a split leaf's block a contiguous copy, a whole leaf itself."""
    if specs is None:
        specs = params_lib.param_specs(params, mesh)

    def cut(t, spec):
        s = params_lib.shard(t, spec, mesh)
        return s.contiguous() if s.shape != t.shape else s
    return params_lib.map_specs(cut, params, specs)


def gather_params(params: Dict, mesh, specs: Any, grad: bool = False
                  ) -> Dict:
    """The inverse of ``shard_params``: every split leaf gathered whole
    over ``data`` then ``model`` (a collective: every rank calls it);
    ``specs`` as the parts were cut by (``param_specs`` of the full
    params, or ``runtime.params.model_specs``); ``grad``: differentiable
    (the gradients come back reduce-scattered)."""
    return params_lib.map_specs(
        lambda t, s: params_lib.gather(t, s, mesh, grad), params, specs)
