"""The 1F1B pipeline schedule over the ``pipe`` mesh axis (counterpart of
``repro/runtime/pipeline_schedule.py``).

The layers are cut into stages at super-block granularity
(``models/model.stage_bounds``: every stage keeps whole layout repeats
and with them its MoE blocks), and the training step runs as the classic
one-forward-one-backward tick program: warm-up forwards, steady B / F
alternation, cool-down backwards.  ``build_1f1b`` simulates the policy
tick by tick and gives the exact per-stage grid; ``Schedule.a2a_slot`` is
the tick whose slot hides microbatch k's MoE exchange (the tick before
F(stage, k): a bubble or another microbatch's unit), which the planner's
bubble variant stands for (comm/planner.py).

Each stage's forward is an autograd graph of its own, cut at its input:
the activation and the stats carry (aux loss, z loss, load, in-graph
metrics: ``models/model.stats_carry``) it receives are detached and made
to require grad.  Its backward is ``torch.autograd.grad`` from its
outputs with the cotangents the next stage's backward computed for them
(from the loss on the last stage), which frees the graph as it runs.

Numerics: the staged step gives bit for bit the loss, metrics and
gradients of ``runtime/step.make_accum_grad_fn(microbatch=rows / n_mb)``.
Each stage runs the same ops as the whole stack; the autograd engine runs
a stage's backward nodes in the order it runs them in the whole graph
(every node of a later stage before any of an earlier one, by sequence
number), so each cotangent is the same sum in the same order; and the
accumulators mirror ``make_accum_grad_fn`` term for term: ``acc +
g.f32 / n`` in increasing microbatch order.  A stage's params belong to
it alone, and 1F1B retires each stage's backwards in increasing
microbatch order, so each stage folds its gradients in at once; the tied
embedding's two uses (the first and the last stage) are summed in the
param dtype first, as autograd sums a leaf used twice, and folded when
stage 0's backward retires, with the loss.

Placement: as in the JAX package, the pipe axis partitions the schedule,
not the placement.  Every pipe index holds every stage's params (their
shards over (data, model), runtime/params.py, the same on every pipe
index) and the same rows, and runs the whole
grid, so the stage hand-off ``stage_transfer`` is the identity, inside
the ``stage_transfer`` phase range; the planner records and prices it
(``planner.plan_stage_transfers``).  The reductions of a step run over
the rank's (data, model) slice (runtime/sharding.py).  Without a mesh
the stage count is an argument, so one card runs the staged program.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.comm import planner as comm_planner
from repro_torch.configs.base import ModelConfig, OptimizerConfig
from repro_torch.models import model as model_lib
from repro_torch.obs import tracing as obs_tracing
from repro_torch.obs.tracing import phase_scope
from repro_torch.optim.adam import leaves
from repro_torch.runtime import sharding
from repro_torch.runtime.step import mesh_specs, reduce_grads

F, B = "F", "B"


# ------------------------------------------------------------- schedule ---

@dataclass(frozen=True)
class Schedule:
    """A 1F1B timetable: ``grid[stage][tick]`` is ("F" | "B", microbatch)
    or None (a bubble).  A forward or a backward unit takes one tick."""
    stages: int
    microbatches: int
    grid: Tuple[Tuple[Optional[Tuple[str, int]], ...], ...]

    @property
    def ticks(self) -> int:
        return len(self.grid[0])

    def tick_of(self, stage: int, phase: str, mb: int) -> int:
        return self.grid[stage].index((phase, mb))

    def bubbles(self, stage: int) -> Tuple[int, ...]:
        return tuple(t for t, u in enumerate(self.grid[stage]) if u is None)

    def bubble_fraction(self) -> float:
        """Idle share of the stage x tick grid: (S - 1) / (M + S - 1) for
        the canonical 1F1B timetable, 0 for one stage."""
        idle = sum(len(self.bubbles(s)) for s in range(self.stages))
        return idle / float(self.stages * self.ticks)

    def a2a_slot(self, stage: int, mb: int) -> int:
        """The tick whose slot hides microbatch ``mb``'s MoE exchange on
        ``stage``: the tick before F(stage, mb), by construction a bubble
        or another microbatch's unit; -1 for the pipeline's first unit
        (stage 0, microbatch 0), which has nothing to hide behind."""
        return self.tick_of(stage, F, mb) - 1


def build_1f1b(stages: int, microbatches: int) -> Schedule:
    """Simulate the 1F1B policy tick by tick.  A stage issues a forward
    while the in-flight bound (stages - stage) allows and the upstream
    activation has arrived; otherwise a backward once the downstream
    cotangent has arrived; otherwise it idles (a bubble)."""
    S, M = int(stages), int(microbatches)
    if S < 1 or M < 1:
        raise ValueError(f"stages={stages}, microbatches={microbatches} "
                         f"must both be >= 1")
    INF = 1 << 30
    done_f: Dict[Tuple[int, int], int] = {}
    done_b: Dict[Tuple[int, int], int] = {}
    nf, nb = [0] * S, [0] * S
    rows: List[List[Optional[Tuple[str, int]]]] = [[] for _ in range(S)]
    t = 0
    while sum(nb) < S * M:
        if t > 2 * (M + S) + 4:
            raise RuntimeError("1F1B simulator did not converge")
        acts = []
        for s in range(S):
            f_ready = (nf[s] < M and nf[s] - nb[s] < S - s
                       and (s == 0 or done_f.get((s - 1, nf[s]), INF) < t))
            b_ready = nb[s] < nf[s] and (
                done_b.get((s + 1, nb[s]), INF) < t if s < S - 1
                else done_f.get((s, nb[s]), INF) < t)
            acts.append((F, nf[s]) if f_ready
                        else (B, nb[s]) if b_ready else None)
        for s, act in enumerate(acts):
            rows[s].append(act)
            if act is None:
                continue
            ph, mb = act
            if ph == F:
                done_f[(s, mb)] = t
                nf[s] += 1
            else:
                done_b[(s, mb)] = t
                nb[s] += 1
        t += 1
    return Schedule(S, M, tuple(tuple(r) for r in rows))


def bubble_fraction(stages: int, microbatches: int) -> float:
    """The closed form for the canonical 1F1B timetable."""
    if stages <= 1:
        return 0.0
    return (stages - 1) / float(microbatches + stages - 1)


# ------------------------------------------------------ staged train step --

def stage_transfer(x: torch.Tensor) -> torch.Tensor:
    """The stage-boundary activation hand-off.  The stages are replicated
    over ``pipe``, so it moves nothing: the identity, inside the
    ``stage_transfer`` phase range."""
    with phase_scope(obs_tracing.PH_STAGE):
        return x


def _stage_params(params: Dict, cfg: ModelConfig, bounds, s: int,
                  stages: int) -> Dict:
    """The params stage ``s`` runs: its layers, the embedding on stage 0,
    and the final norm and head on the last stage (the tied embedding on
    both)."""
    start, stop = bounds[s]
    sp: Dict = {"layers": model_lib.stage_blocks(
        params["layers"], start, stop, len(cfg.layout))}
    if s == 0:
        sp["embed"] = params["embed"]
    if s == stages - 1:
        sp["final_norm"] = params["final_norm"]
        if cfg.tie_embeddings:
            sp["embed"] = params["embed"]
        elif "head" in params:
            sp["head"] = params["head"]
    return sp


def _cut(t):
    """A tensor crossing a stage boundary -> (the receiving stage's leaf,
    whether the sender's graph wants its cotangent)."""
    if isinstance(t, torch.Tensor) and t.requires_grad:
        return t.detach().requires_grad_(True), True
    return t, False


def _resolve_stages(mesh, stages: Optional[int]) -> int:
    """The stage count: the mesh's pipe axis when it has one, else
    ``stages`` (the mesh-free path)."""
    if mesh is not None and "pipe" in mesh.axis_names:
        pipe = int(mesh.axis_size("pipe"))
        if stages is not None and int(stages) != pipe:
            raise ValueError(f"stages={stages} on a mesh whose pipe axis "
                             f"has {pipe} ranks")
        return pipe
    if stages is None:
        raise ValueError("make_pipeline_grad_fn needs a mesh with a 'pipe' "
                         "axis (launch/mesh.make_mesh(pipe=...)) or, "
                         "without a mesh, a stage count")
    return int(stages)


def make_pipeline_grad_fn(cfg: ModelConfig, mesh=None, *,
                          use_lsh: Optional[bool] = None,
                          stages: Optional[int] = None):
    """grad_fn(params, batch) -> (loss, metrics, grads): the 1F1B staged
    counterpart of ``runtime/step.make_accum_grad_fn`` with microbatches
    of rows / ``cfg.pipeline_microbatches`` (the stage count when 0),
    bit for bit: the same loss, the last microbatch's metrics, one f32
    gradient per floating leaf (None for an integer leaf), each summed
    over the axes of the rank's (data, model) slice its leaf does not
    split over (``step.reduce_grads``)."""
    model_lib.check_supported(cfg)
    if cfg.encoder_decoder:
        raise NotImplementedError(
            "pipeline staging of encoder-decoder stacks (the encoder is not "
            "part of the staged decoder stack), as in the JAX package "
            "(ROADMAP Queue 1 item 7)")
    stages = _resolve_stages(mesh, stages)
    bounds = model_lib.stage_bounds(cfg.num_super_blocks, stages)
    n_mb = int(cfg.pipeline_microbatches) or stages
    sched = build_1f1b(stages, n_mb)
    last = stages - 1
    specs = mesh_specs(cfg, mesh)

    def _run(params: Dict, batch: Dict):
        rows = batch["tokens"].shape[0]
        if rows % n_mb:
            raise ValueError(f"batch rows {rows} not divisible by "
                             f"pipeline microbatches {n_mb}")
        per = rows // n_mb
        mbs = [sharding.shard_batch({k: v[m * per:(m + 1) * per]
                                     for k, v in batch.items()}, mesh)
               for m in range(n_mb)]
        ps = leaves(params)
        for p in ps:
            if p.is_floating_point():
                p.requires_grad_(True)
        index = {id(p): i for i, p in enumerate(ps)}
        sps = [_stage_params(params, cfg, bounds, s, stages)
               for s in range(stages)]
        # each stage's floating leaves, as indices into ps
        trainable = [[index[id(p)] for p in leaves(sp)
                      if p.is_floating_point()] for sp in sps]
        tied = index[id(params["embed"]["table"])] \
            if cfg.tie_embeddings and stages > 1 else None

        acc: List[Optional[torch.Tensor]] = [None] * len(ps)
        acc_l = None
        sent: Dict = {}         # (s, mb) -> what stage s hands on
        roots: Dict = {}        # (s, mb) -> stage s's x, aux, z, load
        recv: Dict = {}         # (s, mb) -> the leaves stage s received
        down: Dict = {}         # (s, mb) -> cotangents of recv[(s, mb)]
        tied_last: Dict = {}    # mb -> the last stage's embedding grad
        loss_t: Dict = {}       # mb -> the last stage's loss
        loss_v: Dict = {}       # mb -> its global value, the metric
        metrics: Dict = {}      # the last microbatch's

        def emit_f(s: int, mb: int) -> None:
            b, sp = mbs[mb], sps[s]
            with torch.enable_grad():
                if s == 0:
                    x = model_lib._embed_inputs(
                        sp, cfg, b["tokens"], b.get("patch_embeds"), mesh)
                    init, got = None, []
                else:
                    x_in, *carry = sent.pop((s - 1, mb))
                    cut = [_cut(t) for t in (x_in, *carry[:3])]
                    x = cut[0][0]
                    init = (*(c[0] for c in cut[1:]), carry[3])
                    got = [c[0] if c[1] else None for c in cut]
                recv[(s, mb)] = got
                x, stats = model_lib._stack_forward(
                    sp["layers"], x, cfg, use_lsh=use_lsh, mesh=mesh,
                    moe_mode="train", init_stats=init)
                if s == last:
                    logits = model_lib.head_logits(sp, cfg, x, mesh)
                    loss_t[mb], m = model_lib.loss_from_logits(
                        cfg, logits, model_lib._final_stats(stats, x.device),
                        b["labels"], mesh, model_lib.patch_count(cfg, b))
                    metrics.clear()
                    metrics.update((k, v.detach()) for k, v in m.items())
                    loss_v[mb] = metrics["loss"]
                    return
                out = (stage_transfer(x), *model_lib.stats_carry(stats))
            sent[(s, mb)] = out
            roots[(s, mb)] = out[:4]

        def fold(i: int, g: Optional[torch.Tensor]) -> None:
            if acc[i] is None:
                acc[i] = torch.zeros_like(ps[i], dtype=torch.float32)
            acc[i].add_(g.to(torch.float32) / n_mb)

        def emit_b(s: int, mb: int) -> None:
            nonlocal acc_l
            if s == last:
                outs, cts = [loss_t.pop(mb)], None
            else:
                outs, cts = [], []
                for t, ct in zip(roots.pop((s, mb)), down.pop((s + 1, mb))):
                    if ct is not None:
                        outs.append(t)
                        cts.append(ct)
            got = recv.pop((s, mb))
            inputs = [ps[i] for i in trainable[s]] + [g for g in got
                                                      if g is not None]
            grads = torch.autograd.grad(outs, inputs, cts, allow_unused=True)
            del outs, cts
            n_p = len(trainable[s])
            it = iter(grads[n_p:])
            down[(s, mb)] = [None if g is None else next(it) for g in got]
            for i, g in zip(trainable[s], grads[:n_p]):
                if g is None:       # the detached hash rotations
                    g = torch.zeros_like(ps[i])
                if i == tied:
                    if s == last:
                        tied_last[mb] = g
                        continue
                    g = g + tied_last.pop(mb)
                fold(i, g)
            if s == 0:
                # stage 0's backwards retire in increasing microbatch
                # order: the loss as make_accum_grad_fn adds it
                l = loss_v.pop(mb)
                if acc_l is None:
                    acc_l = torch.zeros((), dtype=torch.float32,
                                        device=l.device)
                acc_l = acc_l + l / n_mb
                down.pop((s, mb))

        for t in range(sched.ticks):
            for s in range(stages):
                unit = sched.grid[s][t]
                if unit is not None:
                    (emit_f if unit[0] == F else emit_b)(s, unit[1])

        grads = [None if not p.is_floating_point() else acc[i]
                 for i, p in enumerate(ps)]
        reduce_grads(grads, params, specs, mesh)
        return acc_l, metrics, grads

    def grad_fn(params: Dict, batch: Dict):
        tokens = batch["tokens"]
        itemsize = torch.empty((), dtype=model_lib.torch_dtype(
            cfg.dtype)).element_size()
        act_bytes = (tokens.shape[0] // n_mb * tokens.shape[1]
                     * cfg.d_model * itemsize)
        comm_planner.plan_stage_transfers(mesh, cfg.moe.comm,
                                          msg_bytes=act_bytes)
        with comm_planner.pipeline_context(stages, n_mb,
                                           sched.bubble_fraction()), \
                obs_tracing.activate(cfg.moe.obs.phase_tracing):
            return _run(params, batch)

    return grad_fn


def make_pipeline_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                             mesh=None, *, use_lsh: Optional[bool] = None,
                             stages: Optional[int] = None):
    """The 1F1B train_step(state, batch) -> (state, metrics); the
    optimizer tail is ``runtime/step.apply_gradients``."""
    from repro_torch.runtime.step import (apply_chaos_scale, apply_gradients,
                                          moment_specs, split_chaos_scale)
    grad_fn = make_pipeline_grad_fn(cfg, mesh, use_lsh=use_lsh,
                                    stages=stages)

    def train_step(state, batch: Dict):
        batch, chaos_scale = split_chaos_scale(batch)
        loss, metrics, grads = grad_fn(state.params, batch)
        loss = apply_chaos_scale(loss, chaos_scale)
        return apply_gradients(state, opt_cfg, loss, metrics, grads,
                               mesh=mesh, specs=mesh_specs(cfg, mesh),
                               mspecs=moment_specs(cfg, opt_cfg, mesh))

    return train_step
