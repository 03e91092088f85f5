"""Model assembly (counterpart of ``repro/models/model.py``):
``init_params``, the training forward and loss (``forward``,
``head_logits``, ``loss_from_logits``, ``loss_fn``), the pieces a
pipeline stage runs (``stage_bounds``, ``stage_blocks``,
``_embed_inputs``, ``_stack_forward`` with a stats carry,
runtime/pipeline_schedule.py), inference prefill
(``prefill``: the forward without gradients, the last position's
logits) and decoding (``init_decode_state``, ``decode_step``).

The JAX package stacks block params per layout entry, [num_super_blocks,
...], and scans over super-blocks with the layout unrolled inside.  The
port keeps one param dict per layer in ``params["layers"]``, in the same
order: super-block major, layout entries interleaved inside, so layer
``sb * len(layout) + i`` is layout entry ``i`` of super-block ``sb``
(convert.py keeps that order).

Over a (data, model) mesh (launch/mesh.py) every function takes this
rank's part: the residual stream between blocks is sharded by batch over
``data`` and by sequence over ``model`` (runtime/sharding.py), and every
param is the rank's shard (runtime/params.py; ``init_params`` places
them).  Norms and the MoE layer run on the rank's [B / data, S / model]
tokens; attention, the dense FFN and Mamba go through runtime/tp.py's
gather-project / project-scatter pair with their weights FSDP-gathered
over ``data`` inside; the embedding reads a vocabulary split over
``model`` (layers.embed), the head gives the model group's whole
sequence on the rank's vocabulary columns, and the loss reduces over
that split.  Each rank's loss is its share of the global loss; a
gradient comes back summed over the axes its leaf splits over, and the
step sums it over the others (runtime/step.py).  Decode reads each
layer's weights gathered whole just before it; its state
(``init_decode_state(mesh=)``) is the rank's block by JAX's
``decode_state_specs``: rows over the dp axes, the caches' sequence over
``model`` (over the dp axes and ``model`` at batch 1), where attention
combines the ranks' partial softmax, and the Mamba state by heads.

Supported: every architecture of the JAX package.  Attention, Mamba-2
(models/ssm.py) and the xLSTM mixers (models/xlstm.py), over a mesh
with their heads split over ``model`` (runtime/tp.py; the sLSTM, and
heads that do not split, replicated over it; under ``dp_only`` the
xLSTM mixers over their weights gathered whole), mixed in one layout,
with MoE, dense or no FFN; RoPE, no position embedding, or the fixed
sinusoid (``pos_emb="learned"``, the JAX name: a table, no parameter,
models/layers.sinusoidal); the patch
frontend (``patch_embeds`` [B, P, H] prepended to the token embeddings,
the loss over the token positions only; over a mesh the combined P + S
sequence is what splits over ``model``, runtime/sharding.shard_batch);
and the encoder-decoder stack (whisper): ``params["encoder"] =
{"layers", "final_norm"}``, a bidirectional (attention, dense) stack over
``frames`` [B, S_enc, H], and in every decoder attention layer a
cross-attention (``cross_norm``, ``cross``) over its output; over a
mesh ``frames`` splits by its own sequence over ``model``, and the
cross-attention gathers the encoder's output (``tp_in_project``).  Its
pipeline staging raises (runtime/pipeline_schedule.py), as in JAX.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import DeviceLike, resolve_device
from repro_torch.comm import collectives
from repro_torch.configs.base import (ATTN, DENSE, MAMBA, MLSTM, MOE, NONE,
                                      SLSTM, ModelConfig)
from repro_torch.convert import gather_params, shard_params
from repro_torch.core.lsh_moe import lsh_moe_apply, lsh_moe_init
from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import (DECODE_TABLE, activation, embed,
                                       embedding_init, fanin_init, mlp_apply,
                                       mlp_init, rmsnorm, rmsnorm_init,
                                       sinusoid_rows, unembed)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.runtime import params as params_lib
from repro_torch.runtime import sharding, tp

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a layout or position embedding the port does not know."""
    for mixer, ffn in cfg.layout:
        if mixer not in (ATTN, MAMBA, MLSTM, SLSTM):
            raise NotImplementedError(
                f"mixer {mixer!r} is not ported (ROADMAP Queue 1 item 7)")
        if ffn not in (DENSE, MOE, NONE):
            raise ValueError(f"unknown ffn kind {ffn!r}")
    if cfg.pos_emb not in ("rope", "none", "learned"):
        raise ValueError(f"unknown pos_emb {cfg.pos_emb!r}")


def layer_kinds(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """(mixer, ffn) of every layer, in params["layers"] order."""
    return list(cfg.layout) * cfg.num_super_blocks


def _mixer_init(gen, cfg: ModelConfig, mixer: str, dtype, device) -> Dict:
    if mixer == MAMBA:
        return ssm_lib.mamba_init(gen, cfg.d_model, cfg.ssm, dtype, device)
    if mixer == MLSTM:
        return xlstm_lib.mlstm_init(gen, cfg.d_model, cfg.resolved_head_dim,
                                    cfg.xlstm.mlstm_proj_factor, dtype,
                                    device)
    if mixer == SLSTM:
        return xlstm_lib.slstm_init(gen, cfg.d_model,
                                    cfg.xlstm.slstm_proj_factor, dtype,
                                    device)
    return attn_lib.attention_init(gen, cfg.d_model, cfg.num_heads,
                                   cfg.num_kv_heads, cfg.resolved_head_dim,
                                   dtype, device)


def _layer_init(gen, cfg: ModelConfig, mixer: str, ffn: str, dtype, device,
                mesh, cross: bool = False, place: bool = True) -> Dict:
    """One layer's params; with a mesh and ``place``, the rank's shard of
    each (the MoE layer cuts its own, core/lsh_moe.py)."""
    h = cfg.d_model
    p: Dict = {"norm1": rmsnorm_init(h, dtype, device),
               "mixer": _mixer_init(gen, cfg, mixer, dtype, device)}
    if cross and mixer == ATTN:
        p["cross_norm"] = rmsnorm_init(h, dtype, device)
        p["cross"] = attn_lib.attention_init(
            gen, h, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
            dtype, device)
    if ffn == DENSE:
        p["norm2"] = rmsnorm_init(h, dtype, device)
        p["ffn"] = mlp_init(gen, h, cfg.d_ff, cfg.mlp_act, dtype, device)
    elif ffn == MOE:
        p["norm2"] = rmsnorm_init(h, dtype, device)
        p["ffn"] = lsh_moe_init(gen, h, cfg.moe, mlp_act=cfg.mlp_act,
                                dtype=dtype, device=device, mesh=mesh,
                                place=place)
    if mesh is None or not place:
        return p
    return {k: v if k == "ffn" and ffn == MOE else _place(v, mesh)
            for k, v in p.items()}


def _place(tree, mesh, prefix=()):
    """The rank's shard of every leaf of ``tree`` (whole shapes), by the
    spec of its path, ``tree`` lying at ``prefix``."""
    return shard_params(tree, mesh, params_lib.param_specs(tree, mesh,
                                                           prefix))


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: DeviceLike = None, mesh=None) -> Dict:
    """Random params from a ``torch.Generator`` seeded with ``seed``, made
    on ``device`` (the CUDA device unless "cpu" is asked for).  The
    distributions are the JAX package's; the numbers are not (the tests
    share params through convert.params_from_jax).  With a mesh every
    rank draws the same params and keeps its shard of each leaf
    (runtime/params.py), a layer at a time; the experts pad to a multiple
    of the model axis.  An encoder-decoder config gets the decoder
    layers' ``cross_norm`` / ``cross`` and ``params["encoder"] =
    {"layers": num_encoder_super_blocks (attention, dense) layers,
    "final_norm"}``."""
    check_supported(cfg)
    with sharding.parallelism_profile(cfg.dp_only):
        return _init(cfg, seed, resolve_device(device), mesh, True)


def logical_params(cfg: ModelConfig, mesh=None) -> Dict:
    """The whole params of ``cfg`` on the meta device (shapes and dtypes,
    no numbers), the experts padded to ``mesh``'s model axis: what
    runtime/params.py reads the specs from."""
    check_supported(cfg)
    return _init(cfg, 0, torch.device("meta"), mesh, False)


def _init(cfg: ModelConfig, seed: int, dev: torch.device, mesh,
          place: bool) -> Dict:
    dtype = torch_dtype(cfg.dtype)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev
                          ).manual_seed(seed)
    cut = (lambda tree, *pre: _place(tree, mesh, pre)) \
        if mesh is not None and place else (lambda tree, *pre: tree)
    params: Dict = {
        "embed": cut(embedding_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                    dev), "embed"),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = cut({"w": fanin_init(
            gen, (cfg.d_model, cfg.vocab_size), dtype, dev)}, "head")
    params["layers"] = [_layer_init(gen, cfg, mixer, ffn, dtype, dev, mesh,
                                    cross=cfg.encoder_decoder, place=place)
                        for mixer, ffn in layer_kinds(cfg)]
    if cfg.encoder_decoder:
        params["encoder"] = {
            "layers": [_layer_init(gen, cfg, ATTN, DENSE, dtype, dev, mesh,
                                   place=place)
                       for _ in range(cfg.num_encoder_super_blocks)],
            "final_norm": rmsnorm_init(cfg.d_model, dtype, dev)}
    return params


def _apply_mixer(p: Dict, h: torch.Tensor, cfg: ModelConfig, mixer: str,
                 mesh, causal: bool = True,
                 enc_states: Optional[torch.Tensor] = None,
                 specs: Optional[Dict] = None) -> torch.Tensor:
    """The mixer over the normed input h (over a mesh, ``specs`` are the
    layer's, runtime/params.py); an attention layer with
    ``cross`` params and ``enc_states`` adds its cross-attention over them,
    whose input is ``rmsnorm(cross_norm, h + y)``: h the block's normed
    input, as in the JAX forward (its decode step norms x + y instead;
    ``decode_step`` mirrors that)."""
    if mixer == MAMBA:
        return ssm_lib.mamba_apply(p["mixer"], h, cfg.ssm, cfg.norm_eps,
                                   mesh=mesh, specs=_sub(specs, "mixer"))
    if mixer in (MLSTM, SLSTM):
        mp, mspecs = p["mixer"], _sub(specs, "mixer")
        if mesh is not None and cfg.dp_only:
            # the mixer runs as on one card on the rank's rows, over its
            # weights gathered whole (their gradients reduce-scattered back)
            mp = gather_params(mp, mesh, mspecs, grad=True)
            mesh = mspecs = None
        if mixer == MLSTM:
            return xlstm_lib.mlstm_apply(mp, h, cfg.resolved_head_dim,
                                         cfg.xlstm.chunk_size, cfg.norm_eps,
                                         mesh=mesh, specs=mspecs)
        return xlstm_lib.slstm_apply(mp, h, cfg.norm_eps, mesh=mesh,
                                     specs=mspecs)
    heads = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                 head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                 kv_chunk=cfg.kv_chunk, mesh=mesh)
    y = attn_lib.attention_apply(p["mixer"], h, causal=causal,
                                 use_rope=(cfg.pos_emb == "rope"),
                                 specs=_sub(specs, "mixer"), **heads)
    if enc_states is not None and "cross" in p:
        hc = rmsnorm(p["cross_norm"], h + y, cfg.norm_eps)
        y = y + attn_lib.attention_apply(p["cross"], hc, causal=False,
                                         use_rope=False, kv_x=enc_states,
                                         specs=_sub(specs, "cross"), **heads)
    return y


def _sub(specs: Optional[Dict], key: str) -> Optional[Dict]:
    return None if specs is None else specs[key]


def entry_specs(cfg: ModelConfig, mesh, encoder: bool = False
                ) -> List[Optional[Dict]]:
    """The specs of the layers of each layout entry (of the encoder's
    one), which are alike (runtime/params.py); None an entry without a
    mesh."""
    n = 1 if encoder else len(cfg.layout)
    if mesh is None:
        return [None] * n
    specs = params_lib.model_specs(cfg, mesh)
    return (specs["encoder"] if encoder else specs)["layers"][:n]


def vocab_split(cfg: ModelConfig, mesh) -> bool:
    """Whether the vocabulary splits over a ``model`` axis of more than
    one rank: the table's rows, or the untied head's columns, by their
    specs."""
    if sharding.axis_size(mesh, "model") == 1:
        return False
    specs = params_lib.model_specs(cfg, mesh)
    return "model" in (specs["embed"]["table"][0] if cfg.tie_embeddings
                       else specs["head"]["w"][1])


def _dense_ffn(p: Dict, h: torch.Tensor, cfg: ModelConfig,
               mesh, specs: Optional[Dict] = None) -> torch.Tensor:
    """The dense FFN over the normed h; over a mesh the JAX package's:
    w_up (and w_gate) through ``tp_in_project``, the activation on the
    rank's hidden columns, w_down through ``tp_project`` (``specs``: the
    FFN's)."""
    if mesh is None:
        return mlp_apply(p, h, cfg.mlp_act)
    names = ["w_up"] + (["w_gate"] if cfg.mlp_act == "swiglu" else [])
    hs = tp.tp_in_project(h, [p[k] for k in names], mesh,
                          [specs[k] for k in names])
    hh = activation(hs[0], hs[1] if len(hs) > 1 else None, cfg.mlp_act)
    return tp.tp_project(hh, p["w_down"], mesh, specs["w_down"])


def _block(p: Dict, x: torch.Tensor, cfg: ModelConfig, mixer: str, ffn: str,
           *, use_lsh: Optional[bool], mesh, moe_mode: str = "train",
           causal: bool = True, enc_states: Optional[torch.Tensor] = None,
           specs: Optional[Dict] = None):
    """One (mixer, ffn) block of the training forward -> (x, aux, z,
    load, comm); aux / z / load are None without a MoE FFN, comm the MoE
    layer's MetricBag (None unless ``ObsConfig.in_graph_metrics``).
    ``specs``: the layer's, over a mesh."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    x = x + _apply_mixer(p, h, cfg, mixer, mesh, causal, enc_states, specs)
    aux = z = load = comm = None
    if ffn == DENSE:
        x = x + _dense_ffn(p["ffn"], rmsnorm(p["norm2"], x, cfg.norm_eps),
                           cfg, mesh, _sub(specs, "ffn"))
    elif ffn == MOE:
        y, stats = lsh_moe_apply(p["ffn"], rmsnorm(p["norm2"], x,
                                                   cfg.norm_eps),
                                 cfg.moe, mlp_act=cfg.mlp_act,
                                 mode=moe_mode, use_lsh=use_lsh, mesh=mesh)
        x = x + y
        aux, z, load = (stats["aux_loss"], stats["z_loss"],
                        stats["expert_load"])
        comm = stats.get("comm")
    return x, aux, z, load, comm


def head_logits(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                mesh=None) -> torch.Tensor:
    """Final norm + (tied) unembedding -> f32 logits.  ``params`` needs
    "final_norm" and "embed" / "head" only: the last pipeline stage
    passes its own slice.  Over a mesh whose ``model`` axis splits the
    vocabulary (runtime/params.py), the logits are the model group's
    whole sequence on the rank's columns, [B, S, V / model] (the JAX
    package's vocab-sharded logits; ``tp_in_project`` gathers the
    sequence, and a head split over ``data`` is gathered over it); with a
    vocabulary that does not split, the rank's sequence slice on the
    whole vocabulary, [B, S / model, V]."""
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if mesh is None:
        return unembed(params["embed"], x) if cfg.tie_embeddings \
            else (x @ params["head"]["w"]).to(torch.float32)
    specs = params_lib.model_specs(cfg, mesh)
    if cfg.tie_embeddings:
        w = params["embed"]["table"].T
        spec = tuple(reversed(specs["embed"]["table"]))
    else:
        w, spec = params["head"]["w"], specs["head"]["w"]
    if "model" in spec[1]:
        (logits,) = tp.tp_in_project(x, [w.to(x.dtype)], mesh, [spec],
                                     whole=False)
        return logits.to(torch.float32)
    if cfg.tie_embeddings:
        return unembed(params["embed"], x)
    return (x @ tp.fsdp_gather(w, spec, mesh, 0)).to(torch.float32)


def stage_bounds(num_super_blocks: int,
                 stages: int) -> Tuple[Tuple[int, int], ...]:
    """Even partition of the super-blocks into pipeline stages, as
    [start, stop) super-block ranges.  Cut at super-block granularity, so
    every stage keeps a whole layout repeat and with it its MoE blocks;
    the earlier stages take the remainder, so the last stage (which also
    holds the head) is never the widest."""
    if stages < 1:
        raise ValueError(f"stages={stages} must be >= 1")
    if stages > num_super_blocks:
        raise ValueError(
            f"stages={stages} > num_super_blocks={num_super_blocks}: every "
            f"stage needs >= 1 super-block (one full layout repeat)")
    base, rem = divmod(num_super_blocks, stages)
    bounds, start = [], 0
    for s in range(stages):
        width = base + (1 if s < rem else 0)
        bounds.append((start, start + width))
        start += width
    return tuple(bounds)


def stage_blocks(layers: List[Dict], start: int, stop: int,
                 layout_len: int) -> List[Dict]:
    """The layers of super-blocks [start, stop): a slice of
    ``params["layers"]``, whose ``layout_len`` layers a super-block are
    stored super-block major.  The same param dicts, not copies."""
    return layers[start * layout_len:stop * layout_len]


def _positions(x: torch.Tensor, mesh) -> torch.Tensor:
    """x plus its rows of the sinusoid table, cast to x's dtype; over a
    mesh the rank's sequence slice starts at its global offset."""
    S = x.shape[1]
    rows = sinusoid_rows(sharding.axis_index(mesh, "model") * S, S,
                         x.shape[-1], x.device)
    return x + rows.to(x.dtype)[None]


def _embed_inputs(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                  patch_embeds: Optional[torch.Tensor] = None,
                  mesh=None) -> torch.Tensor:
    """Token embeddings, after the patch embeddings (cast to the model
    dtype) when the config has the patch frontend and they are given, then
    the sinusoid for ``pos_emb="learned"``.  RoPE positions then count the
    patch prefix.  Over a mesh whose vocabulary splits, the rank's tokens
    go to the lookup behind its patch positions (as -1, which count
    zero), so every rank hands ``layers.embed`` its whole slice."""
    patches = cfg.frontend == "patch_stub" and patch_embeds is not None
    npatch = patch_embeds.shape[1] if patches else 0
    split = vocab_split(cfg, mesh)
    if npatch and split:
        tokens = torch.cat([torch.full((tokens.shape[0], npatch), -1,
                                       dtype=tokens.dtype,
                                       device=tokens.device), tokens], 1)
    x = embed(params["embed"], tokens, mesh, None if mesh is None else
              params_lib.model_specs(cfg, mesh)["embed"]["table"])
    if npatch and split:
        x = x[:, npatch:]
    if patches:
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    if cfg.pos_emb == "learned":
        x = _positions(x, mesh)
    return x


def _encode(params: Dict, cfg: ModelConfig, frames: torch.Tensor,
            mesh=None) -> torch.Tensor:
    """The whisper-style encoder over frame embeddings [B, S_enc, H]:
    cast to the model dtype, plus the sinusoid, the bidirectional
    (attention, dense) stack with the decoder's heads and remat policy,
    the encoder's final norm."""
    x = _positions(frames.to(torch_dtype(cfg.dtype)), mesh)
    enc = params["encoder"]
    x, _ = _stack_forward(enc["layers"], x, cfg, use_lsh=None, mesh=mesh,
                          layout=((ATTN, DENSE),), causal=False,
                          specs=entry_specs(cfg, mesh, encoder=True))
    return rmsnorm(enc["final_norm"], x, cfg.norm_eps)


def _stack_forward(layers: List[Dict], x: torch.Tensor, cfg: ModelConfig, *,
                   use_lsh: Optional[bool], mesh, moe_mode: str = "train",
                   init_stats: Optional[Tuple] = None, layout=None,
                   causal: bool = True,
                   enc_states: Optional[torch.Tensor] = None,
                   specs: Optional[List] = None
                   ) -> Tuple[torch.Tensor, Dict]:
    """The blocks of ``layers`` (whole super-blocks of ``layout``,
    ``cfg.layout`` unless given, in params["layers"] order) over x ->
    (x, stats); ``causal`` False for the encoder, ``enc_states`` the
    encoder's output for the decoder's cross-attention; ``specs`` the
    layout entries' (``entry_specs``, the decoder's unless given).
    ``init_stats``
    is the (aux, z, load, comm) carry of the stack before
    (``stats_carry``) when the stack is cut into pipeline stages; None starts it as the whole stack does
    (aux and z zero, load and comm empty until the first MoE layer).
    Each block is recomputed in the backward pass
    (``torch.utils.checkpoint``, which runs its collectives again, in the
    same order on every rank) when ``remat_policy`` is "nothing" or
    "dots", and kept when it is "full": the JAX rule, at block
    granularity (without gradients nothing is kept to recompute)."""
    remat = cfg.remat_policy in ("nothing", "dots") \
        and torch.is_grad_enabled()
    dev = x.device
    if init_stats is None:
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        z = torch.zeros((), dtype=torch.float32, device=dev)
        load, comm = None, initial_comm_stat(cfg)
    else:
        aux, z, load, comm = init_stats
    layout = cfg.layout if layout is None else layout
    specs = entry_specs(cfg, mesh) if specs is None else specs
    reps = len(layers) // max(1, len(layout))
    for (mixer, ffn), spec, p in zip(list(layout) * reps, specs * reps,
                                     layers):
        fn = partial(_block, p, cfg=cfg, mixer=mixer, ffn=ffn,
                     use_lsh=use_lsh, mesh=mesh, moe_mode=moe_mode,
                     causal=causal, enc_states=enc_states, specs=spec)
        if remat:
            x, a, zz, ld, cm = checkpoint(fn, x, use_reentrant=False)
        else:
            x, a, zz, ld, cm = fn(x)
        if ld is not None:
            aux, z = aux + a, z + zz
            load = ld if load is None else load + ld
            comm = obs_metrics.merge_stat(comm, cm)
    return x, {"aux_loss": aux, "z_loss": z, "expert_load": load,
               "comm": comm}


def stats_carry(stats: Dict) -> Tuple:
    """stats -> the (aux, z, load, comm) carry that threads a stack cut
    into pipeline stages across their boundaries."""
    return (stats["aux_loss"], stats["z_loss"], stats["expert_load"],
            stats["comm"])


def initial_comm_stat(cfg: ModelConfig):
    """The comm slot of the first stage's carry: empty.  The first MoE
    layer's MetricBag (or nothing, with in-graph metrics off) takes its
    place, as in the whole stack, so a staged forward adds no op."""
    return None


def _final_stats(stats: Dict, device) -> Dict:
    """The stack's stats as ``forward`` returns them: a load of zeros
    [1] without a MoE layer, no comm entry without in-graph metrics."""
    out = {"aux_loss": stats["aux_loss"], "z_loss": stats["z_loss"],
           "expert_load": stats["expert_load"]}
    if out["expert_load"] is None:
        out["expert_load"] = torch.zeros((1,), dtype=torch.float32,
                                         device=device)
    if stats["comm"] is not None:
        out["comm"] = stats["comm"]
    return out


def forward(params: Dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            use_lsh: Optional[bool] = None, mesh=None,
            moe_mode: str = "train",
            patch_embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """tokens [B, S] (with a mesh, this rank's [B / data, S / model]) ->
    (logits [B, P + S, V] f32, stats with "aux_loss", "z_loss" summed over
    the MoE layers and "expert_load" summed per expert, each over every
    rank, and with in-graph metrics on, "comm": the MetricBag merged over
    the layers, obs/metrics.py): ``_encode`` (an encoder-decoder config,
    over ``frames``), ``_embed_inputs`` (P patch positions first when
    ``patch_embeds`` are given), ``_stack_forward`` over every layer,
    ``head_logits``."""
    check_supported(cfg)
    enc_states = None
    if cfg.encoder_decoder:
        if frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder model: its "
                             "forward needs frames [B, S_enc, d_model]")
        enc_states = _encode(params, cfg, frames, mesh)
    x = _embed_inputs(params, cfg, tokens, patch_embeds, mesh)
    x, stats = _stack_forward(params["layers"], x, cfg, use_lsh=use_lsh,
                              mesh=mesh, moe_mode=moe_mode,
                              enc_states=enc_states)
    return head_logits(params, cfg, x, mesh), _final_stats(stats, x.device)


def patch_count(cfg: ModelConfig, batch: Dict) -> Optional[int]:
    """The patch positions this (rank's) batch puts before its tokens:
    None when it carries no ``patch_embeds`` (or the config has no patch
    frontend), else their count, which a rank past the prefix holds as
    0."""
    if cfg.frontend != "patch_stub" or "patch_embeds" not in batch:
        return None
    return int(batch["patch_embeds"].shape[1])


def _inputs(cfg: ModelConfig, batch: Dict) -> Dict:
    """forward's keyword inputs from a batch dict."""
    return {"patch_embeds": batch.get("patch_embeds")
            if cfg.frontend == "patch_stub" else None,
            "frames": batch.get("frames")}


def loss_from_logits(cfg: ModelConfig, logits: torch.Tensor, stats: Dict,
                     labels: torch.Tensor, mesh=None,
                     npatch: Optional[int] = None
                     ) -> Tuple[torch.Tensor, Dict]:
    """CE over labels >= 0, + z-loss on the logits' log-sum-exp + the MoE
    aux and router-z losses.  The label log-prob is a gather, which picks
    the same value as JAX's mask-and-reduce.  ``npatch`` (``patch_count``)
    drops the logits' first npatch positions, the patch prefix, so that
    the CE and the z-loss's mean run over the token positions only.
    Vocab-split logits (``head_logits`` over a mesh whose ``model`` axis
    splits the vocabulary, ``vocab_split``) reduce over the split
    (``_split_vocab_terms``) to the terms of the rank's own positions;
    whole-vocabulary logits are the rank's positions already.

    Over n ranks the objective returned is this rank's share of the
    global loss: its CE terms over the global label count, its z-loss
    terms over the global token count, and the (already global) MoE terms
    / n, so that the ranks' objectives sum to the global loss.  The
    metrics are global (summed over the ranks, no gradient)."""
    world = sharding.all_group(mesh)
    n = collectives.group_size(world)
    if vocab_split(cfg, mesh):
        lse, ll = _split_vocab_terms(logits, labels, mesh, npatch or 0)
    else:
        if npatch:
            logits = logits[:, npatch:]
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1,
                          labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    count = collectives.all_reduce_sum(mask.sum(), world)
    ce = torch.sum((lse - ll) * mask) / torch.clamp(count, min=1.0)
    moe_aux = (cfg.moe.router_aux_weight * stats["aux_loss"]
               + cfg.moe.router_z_weight * stats["z_loss"])
    if n > 1 and npatch is not None:
        # the patch prefix lies on the first ranks, so the ranks hold
        # different numbers of token positions: over the global count
        tokens = collectives.all_reduce_sum(torch.tensor(
            float(lse.numel()), device=lse.device), world)
        zl = cfg.z_loss_weight * torch.sum(torch.square(lse)) / tokens
        moe_aux = moe_aux / n
    else:
        zl = cfg.z_loss_weight * torch.mean(torch.square(lse))
        if n > 1:         # every rank holds the same number of tokens
            zl, moe_aux = zl / n, moe_aux / n
    total = ce + zl + moe_aux
    metrics = {"ce": ce, "z_loss": zl, "loss": total}
    metrics = {k: collectives.all_reduce_sum(v.detach(), world)
               for k, v in metrics.items()}
    metrics.update(moe_aux=stats["aux_loss"],
                   expert_load=stats["expert_load"])
    comm = stats.get("comm")
    if obs_metrics.is_bag(comm):
        # the in-graph metrics (already global): the obs_* scalars, the
        # live Eq. 5 compression rate and the comm_* names of the plan
        metrics.update(comm.as_metrics())
        metrics["obs_compression_rate"] = (
            comm.get("wire_bytes")
            / torch.clamp(comm.get("raw_bytes"), min=1.0))
        metrics.update(
            comm_algorithm=comm.get("comm_algorithm"),
            comm_degraded=comm.get("comm_degraded"),
            comm_calibrated=comm.get("comm_calibrated"),
            comm_wire_format=comm.get("comm_wire_format"))
    return total, metrics


def _split_vocab_terms(logits: torch.Tensor, labels: torch.Tensor, mesh,
                       npatch: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The log-sum-exp and the label's logit of the rank's own positions
    from vocab-split logits [B, g L, V / g] (``head_logits``: the model
    group's whole sequence, the rank's columns): the max over the
    vocabulary all-reduced over ``model``, the sums of exponentials and
    the label's logit (JAX's mask-and-reduce: the rank that holds the
    label gives it, the others zero) reduce-scattered to the rank's slice
    of L positions (backward: the all-gather of their cotangents, so
    each rank's columns get every position's gradient), then the slice's
    first ``npatch`` (patch) positions dropped: [B, L - npatch] each, so
    that each token's terms are taken once across the ranks."""
    group = mesh.tp_group()
    n, B = logits.shape[-1], logits.shape[0]
    if npatch:
        labels = torch.cat([torch.full((B, npatch), -1, dtype=labels.dtype,
                                       device=labels.device), labels], 1)
    ids = collectives.raw_all_gather(labels.contiguous(), group, 1) \
        - sharding.axis_index(mesh, "model") * n
    mx = collectives.raw_all_reduce_max(logits.detach().amax(-1), group)
    se = torch.sum(torch.exp(logits - mx[..., None]), dim=-1)
    mine = (ids >= 0) & (ids < n)
    ll = torch.where(mine, torch.gather(
        logits, -1, ids.clamp(0, n - 1).long()[..., None])[..., 0], 0.0)
    se = collectives.ReduceScatter.apply(se, group, 1)
    ll = collectives.ReduceScatter.apply(ll, group, 1)
    L = se.shape[1]
    m = sharding.axis_index(mesh, "model")
    lse = mx[:, m * L:(m + 1) * L] + torch.log(se)
    return lse[:, npatch:], ll[:, npatch:]


def loss_fn(params: Dict, cfg: ModelConfig, batch: Dict, *,
            use_lsh: Optional[bool] = None,
            mesh=None) -> Tuple[torch.Tensor, Dict]:
    """batch {"tokens", "labels"}: [B, S] int, and "patch_embeds" [B, P,
    H] or "frames" [B, S_enc, H] where the config takes them (with a mesh,
    this rank's part: runtime.sharding.shard_batch) -> (loss, metrics);
    over a mesh the loss is this rank's share (``loss_from_logits``)."""
    logits, stats = forward(params, cfg, batch["tokens"], use_lsh=use_lsh,
                            mesh=mesh, **_inputs(cfg, batch))
    return loss_from_logits(cfg, logits, stats, batch["labels"], mesh,
                            patch_count(cfg, batch))


@torch.no_grad()
def prefill(params: Dict, cfg: ModelConfig, batch: Dict,
            mesh=None) -> Tuple[torch.Tensor, Dict]:
    """Inference prefill (the JAX ``prefill``): the forward over
    batch["tokens"] [B, S] (and its "patch_embeds" or "frames") through
    the expert-parallel MoE path (LSH as configured), without gradients
    -> (the last position's logits [B, 1, V] f32, {"position": S}).
    With a mesh the batch is the global one, the params the rank's
    shards, and every rank returns the global logits (gathered over
    ``model``, which holds the vocabulary columns, or the sequence where
    the vocabulary does not split, and the dp axes).  Under
    ``cfg.dp_only`` every rank gathers the params whole and runs the
    mesh-free forward on its rows of the batch
    (``sharding.dp_only_batch_axes``), and the logits are gathered over
    those axes.  The serve loop keeps its teacher-forced prefill, as the
    JAX launcher does."""
    tokens = batch["tokens"]
    if cfg.dp_only and sharding.num_ranks(mesh) > 1:
        axes = sharding.dp_only_batch_axes(mesh, tokens.shape[0])
        rows = sharding.dp_only_batch_slice(mesh, tokens.shape[0])
        local = {k: v[rows] for k, v in batch.items() if k != "labels"}
        whole = gather_params(params, mesh,
                              params_lib.model_specs(cfg, mesh))
        logits, _ = forward(whole, cfg, local["tokens"], moe_mode="prefill",
                            **_inputs(cfg, local))
        last = logits[:, -1:, :].contiguous()
        if axes:
            last = collectives.raw_all_gather(last, sharding.group(mesh,
                                                                   axes), 0)
        return last, {"position": int(tokens.shape[1])}
    local = sharding.shard_batch({k: v for k, v in batch.items()
                                  if k != "labels"}, mesh)
    logits, _ = forward(params, cfg, local["tokens"], mesh=mesh,
                        moe_mode="prefill", **_inputs(cfg, local))
    last = logits[:, -1:, :]
    if sharding.axis_size(mesh, "model") > 1:
        split = vocab_split(cfg, mesh)
        last = collectives.raw_all_gather(
            last.contiguous(), sharding.model_group(mesh), 2 if split else 1)
        last = last if split else last[:, -1:, :]
    if sharding.dp_size(mesh) > 1:
        last = collectives.raw_all_gather(last.contiguous(),
                                          sharding.dp_group(mesh), 0)
    return last, {"position": int(tokens.shape[1])}


def _mixer_state(cfg: ModelConfig, mixer: str, batch: int, max_len: int,
                 dtype, device) -> Dict:
    if mixer == MAMBA:
        return ssm_lib.init_mamba_state(batch, cfg.d_model, cfg.ssm, dtype,
                                        device)
    if mixer == MLSTM:
        dh = cfg.resolved_head_dim
        d_in = xlstm_lib.mlstm_width(cfg.d_model, dh,
                                     cfg.xlstm.mlstm_proj_factor)
        return xlstm_lib.init_mlstm_state(batch, d_in // dh, dh, device)
    if mixer == SLSTM:
        return xlstm_lib.init_slstm_state(batch, cfg.d_model, device)
    cache = attn_lib.init_kv_cache(batch, max_len, cfg.num_kv_heads,
                                   cfg.resolved_head_dim, dtype, device)
    if cfg.encoder_decoder:
        # the encoder keys and values the cross-attention reads; zeros,
        # as the JAX state holds them (its decode never fills them)
        cross = attn_lib.init_kv_cache(batch, max_len, cfg.num_kv_heads,
                                       cfg.resolved_head_dim, dtype, device)
        cache.update(cross_k=cross["k"], cross_v=cross["v"])
    return cache


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device: DeviceLike = None, mesh=None) -> Dict:
    """One state per layer, by its mixer: a KV cache {"k", "v"} for an
    attention layer (and {"cross_k", "cross_v"} of zeros [B, max_len, nkv,
    dh] in an encoder-decoder model's), {"h": f32 [B, nh, dh, N],
    "conv": [B, W - 1, d_inner]} for a Mamba layer, {"C", "n", "m"} (f32) for an mLSTM and
    {"c", "n", "h", "m"} (f32 [B, H]) for an sLSTM (the JAX state's keys);
    and the decode position.

    ``mesh``: ``batch`` is the global batch, and each leaf is this rank's
    block of it by JAX's ``decode_state_specs``
    (runtime/params.decode_layout): big-batch decode splits the rows
    over the dp axes and the caches' sequence over ``model``, batch 1
    the sequence over (dp axes, model), the Mamba state by heads over
    ``model``, the mLSTM state by heads (or by its first head-dimension
    index) and the sLSTM state by width.  The layout goes
    into the state as plain values under "layout", where
    ``decode_step`` reads it.  ``device`` "meta" builds the shapes only
    (the dry run)."""
    check_supported(cfg)
    dev = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    kinds = layer_kinds(cfg)
    if mesh is None:
        caches = [_mixer_state(cfg, mixer, batch, max_len, dtype, dev)
                  for mixer, _ in kinds]
        return {"layers": caches, "position": 0}
    whole = [_mixer_state(cfg, mixer, batch, max_len, dtype,
                          torch.device("meta")) for mixer, _ in kinds]
    layout = params_lib.decode_layout(cfg, batch, mesh, max_len, [
        {k: tuple(t.shape) for k, t in w.items()} for w in whole])
    caches = [{k: torch.zeros(shapes[k], dtype=t.dtype, device=dev)
               for k, t in w.items()}
              for w, shapes in zip(whole, layout["shapes"])]
    return {"layers": caches, "position": 0, "layout": layout}


def cache_split(mesh, layout: Dict) -> attn_lib.CacheSplit:
    """The ``CacheSplit`` of the attention caches of ``layout``
    (runtime/params.decode_layout) on this rank of ``mesh``."""
    n = layout["seq_blocks"]
    feature, axes = ("heads", layout["kv_axes"]) if layout["kv_axes"] \
        else ("dh", layout["dh_axes"]) if layout["dh_axes"] else ("", ())
    parts = sharding.axis_size(mesh, "model") if feature else 1
    return attn_lib.CacheSplit(
        blocks=n, offset=layout["seq_offset"],
        group=sharding.group(mesh, layout["seq_axes"]) if n > 1 else None,
        feature=feature if parts > 1 else "", parts=parts,
        index=params_lib.block(axes, mesh, parts)[0] if parts > 1 else 0,
        fgroup=sharding.model_group(mesh) if parts > 1 else None)


@torch.no_grad()
def decode_step(params: Dict, cfg: ModelConfig, state: Dict,
                tokens: torch.Tensor, mesh=None) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  tokens: [B, 1] -> (logits [B, 1, V] f32, state).
    Every layer's state in ``state`` (KV cache, Mamba or xLSTM state) is
    updated in place; the returned state holds the same tensors, the
    next position and the state's layout.  With a mesh, tokens are this
    rank's rows (the same on every rank that holds them) and each
    layer's weights other than the experts, and the embedding, head and
    final norm, are gathered whole (over ``data`` then ``model``) just
    before they are read and freed after; the MoE exchange runs over
    the model axis on the rank's experts (``moe_dense_dispatch``).  A
    state of ``init_decode_state(mesh=)`` is the rank's block by JAX's
    ``decode_state_specs`` (its "layout"): attention combines its
    partial softmax over the sequence split (``attention.CacheSplit``),
    and the Mamba and xLSTM layers step the rank's block of their state
    (its heads or width).  A state without a
    layout holds the rank's rows with the whole sequence and every head,
    and the step computes what one card computes on them
    (tests/test_torch_hybrid.py holds a (1, 2) mesh to that within
    1e-5)."""
    pos = int(state["position"])
    layout = state.get("layout")
    if layout is not None and mesh is None:
        raise ValueError("a decode state laid out over a mesh needs the "
                         "mesh")
    specs = None if mesh is None else params_lib.model_specs(cfg, mesh)
    split = None if layout is None else cache_split(mesh, layout)
    ssm_mesh = mesh if layout is not None and layout["mamba_axes"] else None
    mlstm_split = "" if layout is None else layout["mlstm_split"]
    slstm_mesh = mesh if layout is not None and layout["slstm_axes"] \
        else None

    def whole(*path):
        """params at ``path``, gathered whole over the mesh."""
        tree, spec = params, specs
        for k in path:
            tree, spec = tree[k], None if spec is None else spec[k]
        return tree if mesh is None else gather_params(tree, mesh, spec)

    x = embed(whole("embed"), tokens)
    if cfg.pos_emb == "learned":
        x = x + sinusoid_rows(pos % DECODE_TABLE, 1, cfg.d_model,
                              x.device).to(x.dtype)[None]
    dh = cfg.resolved_head_dim
    for i, ((mixer, ffn), cache) in enumerate(zip(layer_kinds(cfg),
                                                  state["layers"])):
        p = {k: params["layers"][i][k] if k == "ffn" and ffn == MOE
             else whole("layers", i, k) for k in params["layers"][i]}
        h = rmsnorm(p["norm1"], x, cfg.norm_eps)
        if mixer == ATTN:
            y, _ = attn_lib.decode_attention(
                p["mixer"], h, cache, pos, num_heads=cfg.num_heads,
                num_kv_heads=cfg.num_kv_heads, head_dim=dh,
                rope_theta=cfg.rope_theta, use_rope=(cfg.pos_emb == "rope"),
                split=split)
            if "cross" in p:
                # the JAX decode norms the residual stream x + y here
                # (its forward: the normed input h + y)
                hc = rmsnorm(p["cross_norm"], x + y, cfg.norm_eps)
                y2, _ = attn_lib.decode_attention(
                    p["cross"], hc, {"k": cache["cross_k"],
                                     "v": cache["cross_v"]}, pos,
                    num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                    head_dim=dh, rope_theta=cfg.rope_theta, use_rope=False,
                    cross=True, split=split)
                y = y + y2
        else:
            if mixer == MAMBA:
                y, new = ssm_lib.mamba_decode(p["mixer"], h, cache, cfg.ssm,
                                              cfg.norm_eps, mesh=ssm_mesh)
            elif mixer == MLSTM:
                y, new = xlstm_lib.mlstm_decode(
                    p["mixer"], h, cache, dh, cfg.norm_eps,
                    mesh=mesh if mlstm_split else None, split=mlstm_split)
            else:
                y, new = xlstm_lib.slstm_decode(p["mixer"], h, cache,
                                                cfg.norm_eps,
                                                mesh=slstm_mesh)
            for k, v in new.items():    # the serve loop keeps the tensors
                cache[k].copy_(v)
        x = x + y
        if ffn == DENSE:
            x = x + mlp_apply(p["ffn"], rmsnorm(p["norm2"], x, cfg.norm_eps),
                              cfg.mlp_act)
        elif ffn == MOE:
            x = x + lsh_moe_apply(p["ffn"], rmsnorm(p["norm2"], x,
                                                    cfg.norm_eps),
                                  cfg.moe, mlp_act=cfg.mlp_act,
                                  mode="decode", mesh=mesh)
        del p
    top = {k: whole(k) for k in ("final_norm", "embed" if cfg.tie_embeddings
                                 else "head")}
    out = {"layers": state["layers"], "position": pos + 1}
    if layout is not None:
        out["layout"] = layout
    return head_logits(top, cfg, x), out
