"""The port's collectives (comm/collectives.py) over 2 and 4 CPU ranks
(gloo), the planner's resolutions (comm/planner.py), the clip norm over
sharded gradients (optim/adam.py), ``shard_params`` / ``gather_params``
(convert.py) and the vocab-split loss (models/model.py).

Each rank's inputs come from numpy with a seed of its own.  The forward
of ``all_to_all`` must be bitwise the numpy block transpose of the ranks'
inputs, ``all_gather`` their concatenation, ``reduce_scatter`` the block
of their sum taken in f32 in rank order and cast back; the backward of
each (autograd for f32, bf16 and fp8; the ``autograd.Function``'s own
backward for int8, which autograd does not differentiate) must be
bitwise the transposed collective of the cotangents.  bf16 and fp8 move
as bytes (gloo rejects fp8 and int16); int8 and fp8 values are small
integers whose sums the format holds exactly.
"""
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # parallel test workers share the cores

HERE = Path(__file__).resolve()
SRC = HERE.parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch.comm import planner as tplanner  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8,
          "fp8": torch.float8_e4m3fn}
BITS = {"f32": torch.int32, "bf16": torch.int16, "int8": torch.int8,
        "fp8": torch.uint8}
OPS = ("all_to_all", "all_gather", "reduce_scatter")
WORLDS = (2, 4)


def _data(name, world, rank, op, what):
    """This rank's input ("x") or cotangent ("ct") of ``op`` as a torch
    tensor of dtype ``name``: [R, 3, 5] for the all-to-all, [2, 3, 4]
    into the gather, [2, 3R, 4] into the reduce-scatter (and the
    matching cotangent shapes)."""
    shape = {("all_to_all", "x"): (world, 3, 5),
             ("all_to_all", "ct"): (world, 3, 5),
             ("all_gather", "x"): (2, 3, 4),
             ("all_gather", "ct"): (2, 3 * world, 4),
             ("reduce_scatter", "x"): (2, 3 * world, 4),
             ("reduce_scatter", "ct"): (2, 3, 4)}[(op, what)]
    seed = [world, rank, OPS.index(op), ("x", "ct").index(what),
            list(DTYPES).index(name)]
    rng = np.random.default_rng(seed)
    if name in ("int8", "fp8"):
        a = rng.integers(-3, 4, size=shape).astype(np.float32)
    else:
        a = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(DTYPES[name])


def _bits(t):
    return t.contiguous().view(BITS[[k for k, v in DTYPES.items()
                                     if v == t.dtype][0]]).numpy()


def _sum_in_order(parts, dtype):
    acc = parts[0].to(torch.float32)
    for p in parts[1:]:
        acc = acc + p.to(torch.float32)
    return acc.to(dtype)


def _expected(name, world, rank, op):
    """(forward, backward) this rank should see, from every rank's data."""
    xs = [_data(name, world, r, op, "x") for r in range(world)]
    cts = [_data(name, world, r, op, "ct") for r in range(world)]
    if op == "all_to_all":
        return (torch.stack([x[rank] for x in xs]),
                torch.stack([c[rank] for c in cts]))
    if op == "all_gather":
        blk = slice(3 * rank, 3 * rank + 3)
        return (torch.cat(xs, dim=1),
                _sum_in_order([c[:, blk] for c in cts], DTYPES[name]))
    blk = slice(3 * rank, 3 * rank + 3)
    return (_sum_in_order([x[:, blk] for x in xs], DTYPES[name]),
            torch.cat(cts, dim=1))


# ------------------------------------------------- the port's ranks --

def _port_main(rank, world, args):
    (out_path,) = args
    from repro_torch.comm import collectives as coll
    from repro_torch.convert import gather_params, shard_params
    from repro_torch.optim.adam import global_norm
    from repro_torch.runtime import sharding

    mesh = tmesh.make_mesh(world // 2, 2) if world == 4 \
        else tmesh.make_mesh(1, world)
    group = sharding.all_group(mesh)
    fns = {"all_to_all": (coll.AllToAll, lambda x: coll.all_to_all(x, group),
                          {}),
           "all_gather": (coll.AllGather,
                          lambda x: coll.all_gather(x, group, 1),
                          {"axis": 1}),
           "reduce_scatter": (coll.ReduceScatter,
                              lambda x: coll.reduce_scatter(x, group, 1),
                              {"axis": 1})}
    out = {}
    for name in DTYPES:
        for op, (cls, fn, kw) in fns.items():
            x = _data(name, world, rank, op, "x")
            ct = _data(name, world, rank, op, "ct")
            if name == "int8":
                y = fn(x)
                dx = cls.backward(SimpleNamespace(group=group, **kw), ct)[0]
            else:
                x = x.requires_grad_(True)
                y = fn(x)
                (dx,) = torch.autograd.grad(y, x, grad_outputs=ct)
            out[f"{name}/{op}/fwd"] = _bits(y.detach())
            out[f"{name}/{op}/bwd"] = _bits(dx)

    # the mean over ranks and its backward (the mean of the cotangents)
    x = torch.tensor([float(rank + 1)], requires_grad=True)
    y = coll.all_reduce_mean(x, group)
    (dx,) = torch.autograd.grad(y, x, torch.tensor([2.0 * (rank + 1)]))
    out["mean/fwd"], out["mean/bwd"] = y.detach().numpy(), dx.numpy()

    if world == 4:
        # the clip norm of sharded grads = the norm of the gathered
        from repro_torch.runtime import params as tparams
        rng = np.random.default_rng(5)
        full = {"router_w": torch.from_numpy(
                    rng.standard_normal((4, 6)).astype(np.float32)),
                "w_up": torch.from_numpy(
                    rng.standard_normal((6, 4, 5)).astype(np.float32)),
                "w_down": torch.from_numpy(
                    rng.standard_normal((6, 4, 4)).astype(np.float32))}
        specs = tparams.param_specs(full, mesh)
        mine = shard_params(full, mesh)
        leaves = [mine["router_w"], mine["w_up"], mine["w_down"]]
        out["norm"] = global_norm(
            leaves, [tparams.split_axes(specs[k], mesh) for k in
                     ("router_w", "w_up", "w_down")], mesh).numpy()
        back = gather_params(mine, mesh, specs)
        for k in full:
            out[f"roundtrip/{k}"] = np.asarray(torch.equal(back[k], full[k]))
        out["shard/w_up"] = mine["w_up"].numpy()
        for shape in ((2, 2), (1, 4)):
            m2 = mesh if shape == (2, 2) else tmesh.make_mesh(*shape)
            key = "x".join(map(str, shape))
            out.update({f"{key}/{k}": v
                        for k, v in _placed_round_trip(m2).items()})
            out.update({f"{key}/{k}": v
                        for k, v in _vocab_split_loss(m2).items()})
            out.update({f"{key}/{k}": v
                        for k, v in _int8_moments(m2).items()})
        out.update(_xlstm_over_data(tmesh.make_mesh(4, 1)))
    if world == 4:
        # the (data, pipe, model) layouts: each group's ranks, by gathering
        # the rank numbers over it (a group of one rank: this rank)
        for shape in ((1, 2, 2), (2, 2, 1)):
            m3 = tmesh.make_mesh(shape[0], shape[2], pipe=shape[1])
            key = "x".join(map(str, shape))
            out[f"mesh{key}/coords"] = np.asarray(
                [m3.axis_index(a) for a in ("data", "pipe", "model")])
            me = torch.tensor([rank], dtype=torch.int32)
            for g, grp in (("data", sharding.group(m3, "data")),
                           ("pipe", sharding.pipe_group(m3)),
                           ("model", sharding.model_group(m3)),
                           ("slice", sharding.all_group(m3)),
                           ("world", sharding.world_group(m3))):
                out[f"mesh{key}/{g}"] = coll.raw_all_gather(
                    me, grp, 0).numpy() if coll.group_size(grp) > 1 \
                    else me.numpy()
    np.savez(out_path.format(rank=rank), **out)
    return 0


ROUND_TRIP_ARCHS = ("granite-8b", "granite-moe-3b-a800m",
                    "jamba-1.5-large-398b")


def _placed_round_trip(mesh):
    """The smoke configs' params cut by their specs and gathered again
    (bit for bit), and the clip norm of the shards of a gradient-shaped
    tree (the params themselves) against the norm of the whole tree."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.convert import gather_params, shard_params
    from repro_torch.models import model as tm
    from repro_torch.optim.adam import global_norm, leaves
    from repro_torch.runtime import params as tparams
    out = {}
    for arch in ROUND_TRIP_ARCHS:
        cfg = get_smoke_config(arch)
        full = tm._init(cfg, 3, torch.device("cpu"), mesh, False)
        specs = tparams.model_specs(cfg, mesh)
        mine = shard_params(full, mesh, specs)
        assert tparams.param_specs(full, mesh) == specs
        back = gather_params(mine, mesh, specs)
        out[f"{arch}/round_trip"] = np.asarray(all(
            torch.equal(a, b) for a, b in zip(leaves(back), leaves(full))))
        out[f"{arch}/split"] = np.asarray(sum(
            a.numel() != b.numel() for a, b in zip(leaves(mine),
                                                   leaves(full))))
        fl = [t for t in leaves(full) if t.is_floating_point()]
        ml = [t for t in leaves(mine) if t.is_floating_point()]
        sl = [tparams.split_axes(s, mesh) for s, t in zip(
            leaves(specs, spec=True), leaves(full)) if t.is_floating_point()]
        out[f"{arch}/norm"] = global_norm(ml, sl, mesh).numpy()
        out[f"{arch}/norm_whole"] = global_norm(fl).numpy()
    return out


def _vocab_logits(P, S, B=4, V=32):
    """Logits [B, P + S, V] f32 and labels [B, S]: a label on each rank's
    columns, the max of position 0 on another rank's columns than its
    label, labels of -1."""
    rng = np.random.default_rng(11)
    logits = (3.0 * rng.standard_normal((B, P + S, V))).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int64)
    labels[:, :4] = np.arange(4) * (V // 4) + 1      # each quarter
    labels[0, 5] = labels[1, 7] = -1
    logits[:, P, V - 2] = 25.0                       # max on the last rank
    labels[:, 0] = 0
    return logits, labels


def _vocab_split_loss(mesh):
    """loss_from_logits of vocab-split logits over ``mesh`` (each rank:
    its rows, the whole sequence, its vocabulary columns; its labels of
    its sequence slice) and its gradient of those logits, beside the
    one-rank loss and gradient on the whole logits, with and without a
    patch prefix."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import model as tm
    from repro_torch.runtime import sharding
    cfg = get_smoke_config("granite-8b").replace(vocab_size=32,
                                                 z_loss_weight=1e-2)
    stats = {"aux_loss": torch.zeros(()), "z_loss": torch.zeros(()),
             "expert_load": torch.zeros((1,))}
    out = {}
    for P in (0, 4):
        logits, labels = _vocab_logits(P, 12)
        whole = torch.from_numpy(logits).requires_grad_(True)
        loss1, _ = tm.loss_from_logits(cfg, whole, stats,
                                       torch.from_numpy(labels), None,
                                       P if P else None)
        (g1,) = torch.autograd.grad(loss1, whole)
        B, L = logits.shape[0], logits.shape[1]
        bs, cs = sharding.token_slices(mesh, B, L)
        n = 32 // sharding.axis_size(mesh, "model")
        m = sharding.axis_index(mesh, "model")
        cols = slice(m * n, (m + 1) * n)
        mine = torch.from_numpy(np.ascontiguousarray(
            logits[bs, :, cols])).requires_grad_(True)
        toks = slice(max(cs.start - P, 0), max(cs.stop - P, 0))
        npatch = min(cs.stop, P) - min(cs.start, P) if P else None
        share, met = tm.loss_from_logits(
            cfg, mine, stats, torch.from_numpy(labels[bs, toks]), mesh,
            npatch)
        (g,) = torch.autograd.grad(share, mine)
        out[f"P{P}/loss"] = met["loss"].numpy()
        out[f"P{P}/loss1"] = loss1.detach().numpy()
        out[f"P{P}/grad"] = g.numpy()
        out[f"P{P}/grad1"] = g1.numpy()[bs, :, cols]
    return out


# leaves whose last dimension splits over the mesh: over (2, 2) and (1, 4)
# it spans whole blocks of 128 (w_up), blocks crossing the shards (wo,
# wq, head), q split where the param is whole (head, 250 over 4) and a
# vector (dt_bias); "scale" is whole
INT8_LEAVES = {"wq": (6, 200), "wo": (8, 384), "w_up": (4, 1024),
               "head": (6, 250), "dt_bias": (8,), "scale": (6,)}


def _int8_moments(mesh):
    """Two AdamW steps with int8 moments over the rank's shards of
    ``INT8_LEAVES`` (placed by the JAX rules; no clipping, so the steps
    are elementwise), beside the steps on the whole leaves: the params
    and the moments gathered by ``moment_specs``, bit for bit."""
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.convert import gather_params, shard_params
    from repro_torch.optim import adam
    from repro_torch.runtime import params as tparams
    rng = np.random.default_rng(17)

    def tree(scale):
        out = {k: torch.from_numpy((scale * rng.standard_normal(s)).astype(
            np.float32)) for k, s in INT8_LEAVES.items()}
        out["head"] = {"w": out["head"]}          # the head's rule
        return out
    whole = tree(1.0)
    grads = [tree(1e-2), tree(1e-2)]
    cfg = OptimizerConfig(lr=1e-2, clip_norm=1e9, moment_dtype="int8")
    specs = tparams.param_specs(whole, mesh)
    mspecs = tparams.moment_specs(whole, mesh, "int8")
    mine = shard_params(adam._map(torch.clone, whole), mesh, specs)
    splits = tparams.int8_splits(mine, specs, mspecs, mesh)
    st1 = adam.adamw_init(whole, cfg)
    st = adam.adamw_init(mine, cfg, splits)
    for g in grads:
        st1 = adam.adamw_update(whole, adam.leaves(g), st1, cfg,
                                torch.tensor(1e-2))
        st = adam.adamw_update(
            mine, adam.leaves(shard_params(g, mesh, specs)), st, cfg,
            torch.tensor(1e-2), grad_norm=torch.tensor(1.0), splits=splits)
    back = gather_params(mine, mesh, specs)
    same = all(torch.equal(a, b) for a, b in zip(adam.leaves(back),
                                                 adam.leaves(whole)))
    for m, m1 in ((st.m, st1.m), (st.v, st1.v)):
        got = gather_params(m, mesh, mspecs)
        same = same and all(torch.equal(a, b) for a, b in zip(
            adam.leaves(got), adam.leaves(m1)))
    return {"int8/same": np.asarray(same),
            "int8/split": np.asarray(sum(s is not None for s in splits))}


def _xlstm_over_data(mesh):
    """xlstm-350m's smoke config outside ``dp_only`` (f32) over (4, 1):
    its mixers' weights FSDP-split over data and gathered whole in the
    forward; the loss and the gathered gradients beside one rank's."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.convert import gather_params, shard_params
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.models import model as tm
    from repro_torch.optim.adam import _map, leaves
    from repro_torch.runtime import params as tparams
    from repro_torch.runtime import step as ts
    cfg = get_smoke_config("xlstm-350m").replace(dtype="float32",
                                                 dp_only=False)
    full = tm.init_params(cfg, seed=2, device="cpu")
    specs = tparams.model_specs(cfg, mesh)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLMDataset(
        cfg.vocab_size, 16, 4).batch_at(0).items()}
    l1, _, g1 = ts.make_accum_grad_fn(cfg)(full, batch)
    mine = shard_params(full, mesh, specs)
    loss, _, grads = ts.make_accum_grad_fn(cfg, mesh=mesh)(mine, batch)
    it = iter(grads)
    whole = leaves(gather_params(_map(lambda p: next(it), mine), mesh,
                                 specs))
    worst = max(float((a - b).norm() / b.norm().clamp_min(1e-30))
                for a, b in zip(whole, g1) if b is not None)
    return {"xlstm/loss": loss.numpy(), "xlstm/loss1": l1.numpy(),
            "xlstm/grad_rel": np.asarray(worst),
            "xlstm/split": np.asarray(sum(
                bool(tparams.split_axes(s, mesh))
                for s in leaves(specs, spec=True)))}


# ------------------------------------------------------------- tests --

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    out = {}
    for world in WORLDS:
        tmesh.spawn_cpu_ranks(str(HERE), world,
                              [str(tmp / f"w{world}_{{rank}}.npz")],
                              store=str(tmp / f"store{world}"), env=env,
                              timeout_s=300)
        out[world] = [dict(np.load(tmp / f"w{world}_{r}.npz"))
                      for r in range(world)]
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("op", OPS)
def test_collective_bitwise(runs, world, name, op):
    for rank, got in enumerate(runs[world]):
        fwd, bwd = _expected(name, world, rank, op)
        np.testing.assert_array_equal(got[f"{name}/{op}/fwd"], _bits(fwd),
                                      err_msg=f"rank {rank} forward")
        np.testing.assert_array_equal(got[f"{name}/{op}/bwd"], _bits(bwd),
                                      err_msg=f"rank {rank} backward")


@pytest.mark.parametrize("world", WORLDS)
def test_all_reduce_mean_and_its_transpose(runs, world):
    """Ranks hold 1..R; cotangents 2 * (1..R): the mean of each."""
    mean = (world + 1) / 2.0
    for got in runs[world]:
        np.testing.assert_allclose(got["mean/fwd"], [mean], rtol=1e-7)
        np.testing.assert_allclose(got["mean/bwd"], [2 * mean], rtol=1e-7)


def test_global_norm_over_sharded_leaves(runs):
    """On mesh (2, 2): a replicated leaf counts once and the expert shards
    of the four ranks are summed, so every rank's clip norm is the norm of
    the full tensors (within the f32 sums' order)."""
    rng = np.random.default_rng(5)
    full = [rng.standard_normal(s).astype(np.float32)
            for s in ((4, 6), (6, 4, 5), (6, 4, 4))]
    want = np.sqrt(sum(np.sum(np.square(a.astype(np.float64)))
                       for a in full))
    for got in runs[4]:
        np.testing.assert_allclose(got["norm"], want, rtol=1e-6)


@pytest.mark.parametrize("shape", ["2x2", "1x4"])
def test_placed_params_round_trip_and_norm(runs, shape):
    """Every leaf of three smoke configs cut by its spec and gathered
    back bit for bit on four ranks; some leaves really split; the clip
    norm of the shards is the norm of the whole tree (within the f32
    sums' order)."""
    for got in runs[4]:
        for arch in ROUND_TRIP_ARCHS:
            assert bool(got[f"{shape}/{arch}/round_trip"]), arch
            assert int(got[f"{shape}/{arch}/split"]) > 0, arch
            np.testing.assert_allclose(got[f"{shape}/{arch}/norm"],
                                       got[f"{shape}/{arch}/norm_whole"],
                                       rtol=1e-6)


@pytest.mark.parametrize("patches", [0, 4])
@pytest.mark.parametrize("shape", ["2x2", "1x4"])
def test_vocab_split_loss_matches_one_rank(runs, shape, patches):
    """The loss over a vocabulary split over model 2 and 4 (labels on
    each rank's columns, a max on another rank than the label's, labels
    of -1, the z-loss; with and without a patch prefix on the first
    ranks) within 1e-6 relative of the one-rank loss, and each rank's
    gradient of its logits the one-rank gradient's block."""
    for got in runs[4]:
        np.testing.assert_allclose(got[f"{shape}/P{patches}/loss"],
                                   got[f"{shape}/P{patches}/loss1"],
                                   rtol=1e-6)
        g, g1 = got[f"{shape}/P{patches}/grad"], \
            got[f"{shape}/P{patches}/grad1"]
        assert np.linalg.norm(g - g1) <= 1e-6 * np.linalg.norm(g1)


@pytest.mark.parametrize("shape", ["2x2", "1x4"])
def test_int8_moments_over_a_split_last_dimension(runs, shape):
    """Int8 moments quantized along a logical last dimension that splits
    over the mesh (blocks of 128 crossing the shards, q padded and laid
    by the JAX ``moment_specs``): two AdamW steps on four ranks give the
    one-rank params and moments bit for bit."""
    for got in runs[4]:
        assert bool(got[f"{shape}/int8/same"])
        assert int(got[f"{shape}/int8/split"]) >= 4


def test_xlstm_mixers_over_a_data_axis(runs):
    """The xLSTM mixers outside dp_only over (4, 1): their weights split
    over data and gathered in the forward; the loss within 1e-6 and
    every gradient within 1e-5 relative L2 of one rank's."""
    for got in runs[4]:
        np.testing.assert_allclose(got["xlstm/loss"], got["xlstm/loss1"],
                                   rtol=1e-6)
        assert float(got["xlstm/grad_rel"]) <= 1e-5
        assert int(got["xlstm/split"]) > 10


def test_shard_gather_params_round_trip(runs):
    """shard_params cuts [E, H, F] to [E / model, H / data, F] at rank
    (d, m); gather_params puts the four shards back bit for bit."""
    rng = np.random.default_rng(5)
    rng.standard_normal((4, 6))
    w_up = rng.standard_normal((6, 4, 5)).astype(np.float32)
    for rank, got in enumerate(runs[4]):
        d, m = divmod(rank, 2)
        np.testing.assert_array_equal(got["shard/w_up"],
                                      w_up[3 * m:3 * m + 3, 2 * d:2 * d + 2])
        for k in ("router_w", "w_up", "w_down"):
            assert bool(got[f"roundtrip/{k}"]), k


# ------------------------------------------------------------ planner --

def _plan(shape, **comm):
    return tplanner.plan_collectives(
        tmesh.Mesh(shape), tbase.CommConfig(**comm), msg_bytes=4 << 20,
        chunk_extent=208)


@pytest.mark.parametrize("comm,want", [
    (dict(a2a_impl="hierarchical", node_size=2), ("hierarchical", 2, 1)),
    (dict(a2a_impl="pipelined", overlap_chunks=4), ("pipelined", 4, 4)),
    (dict(overlap_chunks=2), ("pipelined", 4, 2)),      # auto -> pipelined
    (dict(node_size=2), ("hierarchical", 2, 1)),        # auto -> 2-hop
    (dict(tuning="cache", node_size=2), ("flat", 2, 1)),   # calibrated
], ids=["hierarchical", "pipelined", "auto-pipelined", "auto-hierarchical",
        "calibrated"])
def test_planner_raises_for_item_3b(comm, want, tmp_path, monkeypatch):
    """The transports the planner once refused now resolve: (algorithm,
    intra, chunks) as the reference's rule gives them (held against it
    over a grid in test_torch_topology.py).  The calibrated case reads a
    cache entry whose measured intra-node link is slow, which turns the
    static rule's 2-hop into flat."""
    from repro_torch.tune import cache
    from repro_torch.tune.fingerprint import fingerprint_for
    from repro_torch.tune.model import CalibratedCostModel
    monkeypatch.setenv(cache.ENV_CACHE, str(tmp_path))
    monkeypatch.delenv("REPRO_TUNE", raising=False)
    monkeypatch.delenv(tplanner.ENV_VAR, raising=False)
    topo = tplanner.build_topology(tmesh.Mesh((1, 4)), node_size=2)
    fp = fingerprint_for(tmesh.Mesh((1, 4)), topo)
    cache.store(fp, CalibratedCostModel(
        key=fp.key(), intra_bw=1e8, inter_lat=1e-7).to_payload())
    plan = _plan((1, 4), **comm)
    assert (plan.algorithm, plan.intra, plan.chunks) == want
    assert plan.calibrated == ("tuning" in comm)
    assert not plan.degraded


def test_planner_raises_for_bubble_in_a_pipeline():
    """Inside a 1F1B pipeline the auto rule picks the bubble variant, as
    the reference's does: the same base transport (flat below
    min_hierarchical_bytes or where the axis does not factor, the 2-hop
    where it does) and the same reason; outside one an explicit bubble
    degrades to flat, as in the reference."""
    pytest.importorskip("jax")
    from repro.comm import planner as jplanner
    from repro.comm import topology as jtopo
    from repro.configs.base import CommConfig as JCommConfig
    for node, msg in ((0, 4 << 20), (2, 4 << 20), (2, 1024)):
        with jplanner.pipeline_context(2, 4, 0.2):
            want = jplanner.plan_collectives(
                None, JCommConfig(node_size=node), msg_bytes=msg,
                chunk_extent=208, topology=jtopo.Topology(
                    axis_sizes=(("data", 1), ("model", 4))))
        with tplanner.pipeline_context(2, 4, 0.2):
            got = tplanner.plan_collectives(
                tmesh.Mesh((1, 4)), tbase.CommConfig(node_size=node),
                msg_bytes=msg, chunk_extent=208)
        assert want.algorithm == got.algorithm == "bubble"
        assert (got.base, got.transport, got.reason, got.intra) == \
            (want.base, want.transport, want.reason, want.intra)
    assert tplanner.current_pipeline_context() is None
    plan = _plan((1, 4), a2a_impl="bubble")
    assert plan.algorithm == "flat" and plan.degraded


@pytest.mark.parametrize("shape,comm", [
    ((1, 4), {}),                                            # the default
    ((1, 4), dict(a2a_impl="flat")),
    ((1, 1), dict(a2a_impl="hierarchical", node_size=2)),    # size-1 axis
    ((1, 4), dict(a2a_impl="hierarchical")),                 # no node size
    ((1, 4), dict(a2a_impl="pipelined", overlap_chunks=3)),  # 3 !| 208
    ((2, 2), dict(node_size=4)),                             # one node
], ids=["default", "flat", "size-1", "no-factor", "no-chunking",
        "one-node"])
def test_planner_runs_flat_where_the_reference_does(shape, comm):
    plan = _plan(shape, **comm)
    assert plan.algorithm == "flat"
    assert plan.degraded == ("a2a_impl" in comm and comm["a2a_impl"]
                             != "flat")


def test_planner_reads_the_environment(monkeypatch):
    """$REPRO_COMM_IMPL stands where the config says "auto": on a model
    axis that factors, a message below min_hierarchical_bytes plans flat,
    and the variable asks for the 2-hop transport all the same."""
    def plan():
        return tplanner.plan_collectives(
            tmesh.Mesh((1, 4)), tbase.CommConfig(node_size=2), msg_bytes=0)
    assert plan().algorithm == "flat"
    monkeypatch.setenv(tplanner.ENV_VAR, "hierarchical")
    got = plan()
    assert (got.algorithm, got.intra) == ("hierarchical", 2)
    assert tplanner.ENV_VAR in got.reason
    monkeypatch.setenv(tplanner.ENV_VAR, "ring")
    with pytest.raises(ValueError, match="available"):
        _plan((1, 2))


def test_nccl_is_required_for_cuda():
    """A CUDA device asks for NCCL and never falls back to gloo."""
    assert tmesh.backend_for(torch.device("cpu")) == "gloo"
    if not torch.distributed.is_nccl_available():
        with pytest.raises(RuntimeError, match="NCCL"):
            tmesh.backend_for(torch.device("cuda"))
    else:
        assert tmesh.backend_for(torch.device("cuda")) == "nccl"


def test_make_mesh_rejects_a_pipe_axis(runs):
    """make_mesh with pipe > 1 on 4 gloo ranks: the (data, pipe, model)
    meshes (1, 2, 2) and (2, 2, 1) lay ranks out row-major, rank =
    (d * pipe + p) * model + m, and each group holds the ranks of its
    slice in order: an axis's, the (data, model) slice of the rank's pipe
    index (``sharding.all_group``), and the whole mesh."""
    for shape in ((1, 2, 2), (2, 2, 1)):
        D, P, M = shape
        for rank, got in enumerate(runs[4]):
            key = "x".join(map(str, shape))
            d, rest = divmod(rank, P * M)
            p, m = divmod(rest, M)
            assert list(got[f"mesh{key}/coords"]) == [d, p, m]
            want = {
                "data": [(dd * P + p) * M + m for dd in range(D)],
                "pipe": [(d * P + pp) * M + m for pp in range(P)],
                "model": [(d * P + p) * M + mm for mm in range(M)],
                "slice": [(dd * P + p) * M + mm for dd in range(D)
                          for mm in range(M)],
                "world": list(range(4))}
            for g, ranks in want.items():
                np.testing.assert_array_equal(
                    got[f"mesh{key}/{g}"], ranks if len(ranks) > 1
                    else [rank], err_msg=f"rank {rank} {shape} {g}")


if __name__ == "__main__":                  # RANK WORLD STORE args...
    sys.exit(tmesh.run_cpu_rank(sys.argv[1:], _port_main))
