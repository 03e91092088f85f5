"""The port's collectives (comm/collectives.py) over 2 and 4 CPU ranks
(gloo), the planner's resolutions (comm/planner.py), the clip norm over
sharded gradients (optim/adam.py) and ``shard_params`` /
``gather_params`` (convert.py).

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
        # the clip norm of sharded expert grads = the norm of the gathered
        rng = np.random.default_rng(5)
        full = {"router_w": torch.from_numpy(
                    rng.standard_normal((4, 6)).astype(np.float32)),
                "w_up": torch.from_numpy(
                    rng.standard_normal((6, 4, 5)).astype(np.float32)),
                "w_down": torch.from_numpy(
                    rng.standard_normal((6, 4, 4)).astype(np.float32))}
        mine = shard_params(full, mesh)
        leaves = [mine["router_w"], mine["w_up"], mine["w_down"]]
        out["norm"] = global_norm(leaves, [False, True, True],
                                  group).numpy()
        back = gather_params(mine, mesh)
        for k in full:
            out[f"roundtrip/{k}"] = np.asarray(torch.equal(back[k], full[k]))
        out["shard/w_up"] = mine["w_up"].numpy()
    np.savez(out_path.format(rank=rank), **out)
    return 0


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

def _plan(shape, pipeline=None, **comm):
    return tplanner.plan_collectives(
        tmesh.Mesh(shape), tbase.CommConfig(**comm), msg_bytes=4 << 20,
        chunk_extent=208, pipeline=pipeline)


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
    """Inside a 1F1B pipeline the reference's auto rule picks the bubble
    variant, which rides the 1F1B schedule (item 6) and so raises;
    outside one an explicit bubble degrades to flat, as in the
    reference."""
    with pytest.raises(NotImplementedError, match="item 6"):
        _plan((1, 4), pipeline=tplanner.PipelineContext(2, 4, 0.2))
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


def test_make_mesh_rejects_a_pipe_axis():
    with pytest.raises(NotImplementedError, match="item 6"):
        tmesh.make_mesh(1, 1, pipe=2)


if __name__ == "__main__":                  # RANK WORLD STORE args...
    sys.exit(tmesh.run_cpu_rank(sys.argv[1:], _port_main))
