"""The port's hierarchical (2-hop) and chunk-pipelined all-to-all
(comm/hierarchical.py, comm/pipeline.py) over four CPU ranks (gloo), at
mesh (data, model) = (1, 4) with two ranks a node.

Both move data only, so against the flat all-to-all they must be bitwise
in values and gradients, for every leaf dtype: bf16 and f32 through
autograd, an int8 payload through each function's own backward (autograd
does not differentiate integers), fp8 through autograd where the
pipelined path takes it and the 2-hop's backward otherwise.  The 2-hop
runs on the subgroups ``make_mesh`` built for its node size, and on those
``Mesh.hop_groups`` builds on first use for a mesh made without one.  The
coded pipelined leg (``wire.transfer_fn``, int8 and fp8, every chunk
encoded on its own) and the coded 2-hop leg are bitwise the coded flat
leg, values and gradients; so is the asynchronous chunked exchange with
an expert MLP between its legs against the flat exchange's forward.

Then the reference's ``test_moe_exchange_parity_end_to_end`` on the port's
layer: LSH on, bf16 wire, f32 params.  The hierarchical plan is bitwise
the flat one in y and in the w_up gradient.  The pipelined plan (4
chunks) runs the expert MLP on a quarter of the rows at a time: its y is
held bitwise where the CPU's matmul gives the same bits on fewer rows (it
does here), and its gradient within 1e-4, the reference's bound.  On the
mesh the planner's auto rule stays flat without a node size and picks
the 2-hop with one.
"""
import os
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = Path(__file__).resolve()
SRC = HERE.parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch.launch import mesh as tmesh  # noqa: E402

WORLD, NODE = 4, 2
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8,
          "fp8": torch.float8_e4m3fn}
TRANSPORTS = ("hierarchical", "hierarchical-lazy", "pipelined2",
              "pipelined4")
CODED = ("int8", "fp8")


def _data(name, rank, what, shape=(WORLD, 2, 8, 16)):
    rng = np.random.default_rng([rank, list(DTYPES).index(name),
                                 ("x", "ct").index(what)])
    if name in ("int8", "fp8"):
        a = rng.integers(-3, 4, size=shape).astype(np.float32)
    else:
        a = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(DTYPES[name])


def _bits(t):
    t = t.detach().contiguous()
    return t.view(torch.uint8).numpy() if t.element_size() == 1 \
        else t.view({2: torch.int16, 4: torch.int32}[t.element_size()]) \
        .numpy()


def _port_main(rank, world, args):
    (out_path,) = args
    from types import SimpleNamespace

    from repro_torch.comm import collectives as coll
    from repro_torch.comm import planner, wire
    from repro_torch.comm.hierarchical import (HierarchicalAllToAll,
                                               hierarchical_all_to_all)
    from repro_torch.comm.pipeline import (pipelined_all_to_all,
                                           pipelined_moe_exchange)
    from repro_torch.configs import base as tbase
    from repro_torch.core.lsh_moe import lsh_moe_apply, lsh_moe_init
    from repro_torch.runtime import sharding

    mesh = tmesh.make_mesh(1, WORLD, node_size=NODE)
    lazy = tmesh.make_mesh(1, WORLD)          # no node size: no subgroups
    group = sharding.model_group(mesh)
    lazy_groups = lazy.hop_groups(NODE)        # built here, on every rank
    fns = {"flat": lambda x: coll.all_to_all(x, group),
           "hierarchical": lambda x: hierarchical_all_to_all(
               x, mesh.hop_groups(NODE)),
           "hierarchical-lazy": lambda x: hierarchical_all_to_all(
               x, lazy_groups),
           "pipelined2": lambda x: pipelined_all_to_all(x, group, 2),
           "pipelined4": lambda x: pipelined_all_to_all(x, group, 4)}
    out = {}
    for name in DTYPES:
        x, ct = _data(name, rank, "x"), _data(name, rank, "ct")
        for t, fn in fns.items():
            if name == "int8" or (name == "fp8" and t.startswith("hier")):
                y = fn(x)
                if t == "flat":
                    dx = coll.AllToAll.backward(
                        SimpleNamespace(group=group), ct)[0]
                elif t.startswith("hier"):
                    groups = lazy_groups if t.endswith("lazy") \
                        else mesh.hop_groups(NODE)
                    dx = HierarchicalAllToAll.backward(
                        SimpleNamespace(groups=groups), ct)[0]
                else:           # self-transpose: the same chunked move
                    dx = fn(ct)
            else:
                xg = x.clone().requires_grad_(True)
                y = fn(xg)
                (dx,) = torch.autograd.grad(y, xg, grad_outputs=ct)
            out[f"{name}/{t}/fwd"] = _bits(y)
            out[f"{name}/{t}/bwd"] = _bits(dx)

    # the coded legs: flat, 2-hop and chunked, values and gradients
    x = _data("f32", rank, "x").requires_grad_(True)
    ct = _data("bf16", rank, "ct")
    for fmt in CODED:
        codec = wire.make_codec(fmt, compute_dtype=torch.float32)
        legs = {"flat": lambda v: wire.coded_transfer(
                    v, codec, *wire.flat_leaves(group)),
                "hierarchical": lambda v: wire.coded_transfer(
                    v, codec, *wire.hierarchical_leaves(
                        mesh.hop_groups(NODE))),
                "pipelined2": lambda v: pipelined_all_to_all(
                    v, group, 2, transfer=wire.transfer_fn(codec, group)),
                "pipelined4": lambda v: pipelined_all_to_all(
                    v, group, 4, transfer=wire.transfer_fn(codec, group))}
        w = torch.from_numpy(np.random.default_rng(9).standard_normal(
            (16, 16)).astype(np.float32)).requires_grad_(True)
        for t, leg in legs.items():
            y = leg(x)
            dx = torch.autograd.grad(y, x, grad_outputs=ct.float())[0]
            out[f"coded/{fmt}/{t}/fwd"] = _bits(y)
            out[f"coded/{fmt}/{t}/bwd"] = _bits(dx)
        # the exchange with an MLP between the legs, chunked and not
        for k in (1, 2, 4):
            y = pipelined_moe_exchange(
                x, lambda r: torch.tanh(r @ w), group, k,
                transfer=wire.transfer_fn(codec, group))
            gx, gw = torch.autograd.grad(y, [x, w], grad_outputs=ct.float())
            out[f"exchange/{fmt}/{k}/fwd"] = _bits(y)
            out[f"exchange/{fmt}/{k}/gx"] = gx.numpy()
            out[f"exchange/{fmt}/{k}/gw"] = gw.numpy()

    # the reference's test_moe_exchange_parity_end_to_end, on the layer
    base = tbase.MoEConfig(num_experts=8, top_k=2, expert_ffn_dim=32,
                           capacity_factor=4.0,
                           lsh=tbase.LSHConfig(enabled=True, num_hashes=4,
                                               rotation_dim=16,
                                               compression_rate=0.5))
    params = lsh_moe_init(torch.Generator().manual_seed(0), 16, base,
                          mlp_act="swiglu", dtype=torch.float32,
                          device="cpu", mesh=mesh)
    xs = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 8, 16)).astype(np.float32))
    bs, ss = sharding.token_slices(mesh, 4, 8)
    xs = xs[bs, ss].contiguous()
    import dataclasses
    for tag, comm in (("flat", tbase.CommConfig(a2a_impl="flat")),
                      ("hierarchical", tbase.CommConfig(
                          a2a_impl="hierarchical", node_size=NODE)),
                      ("pipelined", tbase.CommConfig(
                          a2a_impl="pipelined", overlap_chunks=4))):
        cfg = dataclasses.replace(base, comm=comm)
        w_up = params["w_up"].clone().requires_grad_(True)
        y, _ = lsh_moe_apply(dict(params, w_up=w_up), xs, cfg,
                             mlp_act="swiglu", mode="train", mesh=mesh)
        (g,) = torch.autograd.grad(y.sum(), w_up)
        out[f"layer/{tag}/algorithm"] = np.array(
            planner.last_plan("model").algorithm)
        out[f"layer/{tag}/y"] = y.detach().numpy()
        out[f"layer/{tag}/g"] = g.numpy()
    p = planner.plan_collectives(lazy, tbase.CommConfig(), msg_bytes=1 << 24,
                                 chunk_extent=64)
    out["auto/no-node"] = np.array(p.algorithm)
    p = planner.plan_collectives(mesh, tbase.CommConfig(), msg_bytes=1 << 24,
                                 chunk_extent=64)
    out["auto/node"] = np.array(f"{p.algorithm}/{p.intra}")
    np.savez(out_path.format(rank=rank), **out)
    return 0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("transports")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    env.pop("REPRO_COMM_IMPL", None)
    env.pop("REPRO_NODE_SIZE", None)
    tmesh.spawn_cpu_ranks(str(HERE), WORLD, [str(tmp / "r{rank}.npz")],
                          store=str(tmp / "store"), env=env, timeout_s=300)
    return [dict(np.load(tmp / f"r{r}.npz")) for r in range(WORLD)]


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("name", list(DTYPES))
def test_a2a_parity_bitwise_values_and_grads(runs, name, transport):
    """Against the flat all-to-all, and so against every rank's inputs."""
    for rank, got in enumerate(runs):
        want = np.stack([_bits(_data(name, r, "x"))[rank]
                         for r in range(WORLD)])
        np.testing.assert_array_equal(got[f"{name}/flat/fwd"], want)
        for d in ("fwd", "bwd"):
            np.testing.assert_array_equal(got[f"{name}/{transport}/{d}"],
                                          got[f"{name}/flat/{d}"],
                                          err_msg=f"rank {rank} {d}")


@pytest.mark.parametrize("transport", ("hierarchical", "pipelined2",
                                       "pipelined4"))
@pytest.mark.parametrize("fmt", CODED)
def test_coded_legs_bitwise_the_flat_coded_leg(runs, fmt, transport):
    for got in runs:
        for d in ("fwd", "bwd"):
            np.testing.assert_array_equal(
                got[f"coded/{fmt}/{transport}/{d}"],
                got[f"coded/{fmt}/flat/{d}"], err_msg=d)


@pytest.mark.parametrize("chunks", (2, 4))
@pytest.mark.parametrize("fmt", CODED)
def test_pipelined_exchange_against_unchunked(runs, fmt, chunks):
    """The asynchronous chunked exchange: y bitwise the one-chunk
    exchange's (the MLP's rows do not mix); the input's gradient bitwise
    (each chunk's rows only); the weight's, whose f32 sum over the rows
    is regrouped by chunk, within 1e-5 of its largest magnitude."""
    for got in runs:
        np.testing.assert_array_equal(got[f"exchange/{fmt}/{chunks}/fwd"],
                                      got[f"exchange/{fmt}/1/fwd"])
        np.testing.assert_array_equal(got[f"exchange/{fmt}/{chunks}/gx"],
                                      got[f"exchange/{fmt}/1/gx"])
        want = got[f"exchange/{fmt}/1/gw"]
        np.testing.assert_allclose(got[f"exchange/{fmt}/{chunks}/gw"], want,
                                   rtol=0, atol=1e-5 * np.abs(want).max())


def test_moe_exchange_parity_end_to_end(runs):
    for got in runs:
        assert str(got["layer/hierarchical/algorithm"]) == "hierarchical"
        assert str(got["layer/pipelined/algorithm"]) == "pipelined"
        np.testing.assert_array_equal(got["layer/hierarchical/y"],
                                      got["layer/flat/y"])
        np.testing.assert_array_equal(got["layer/hierarchical/g"],
                                      got["layer/flat/g"])
        np.testing.assert_array_equal(got["layer/pipelined/y"],
                                      got["layer/flat/y"])
        np.testing.assert_allclose(got["layer/pipelined/g"],
                                   got["layer/flat/g"], atol=1e-4)
        assert str(got["auto/no-node"]) == "flat"
        assert str(got["auto/node"]) == f"hierarchical/{NODE}"


@pytest.mark.parametrize("use_lsh", (True, False), ids=("lsh", "nolsh"))
@pytest.mark.parametrize("fmt", CODED)
def test_quantized_pipelined_plan_takes_the_per_chunk_path(monkeypatch, fmt,
                                                           use_lsh):
    """In one process, over a one-rank mesh: a quantized pipelined plan
    encodes each slot chunk on its own (one encode a chunk a leg) and
    never reaches the fused codec transfers; the flat plan takes them.
    The two give the same y (the fused path is bitwise the composed one,
    and the chunked MLP's rows do not mix on the CPU)."""
    import dataclasses

    from repro_torch.comm import planner, topology, wire
    from repro_torch.configs import base as tbase
    from repro_torch.core.lsh_moe import lsh_moe_apply, lsh_moe_init
    cfg = tbase.MoEConfig(num_experts=4, top_k=2, expert_ffn_dim=16,
                          capacity_factor=2.0,
                          lsh=tbase.LSHConfig(enabled=True, num_hashes=2,
                                              rotation_dim=8,
                                              compression_rate=0.5,
                                              wire_format=fmt))
    mesh = tmesh.Mesh((1, 1))
    params = lsh_moe_init(torch.Generator().manual_seed(0), 8, cfg,
                          mlp_act="swiglu", dtype=torch.float32,
                          device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 8, 8)).astype(np.float32))
    calls = {"fused": 0, "encode": []}
    for name in ("precoded_transfer", "fused_decode_residual_transfer",
                 "fused_dispatch_transfer", "fused_combine_transfer"):
        orig = getattr(wire, name)

        def spy(*a, _orig=orig, **kw):
            calls["fused"] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(wire, name, spy)
    encode = wire.WireCodec.encode

    def spy_encode(self, v):
        calls["encode"].append(tuple(v.shape))
        return encode(self, v)
    monkeypatch.setattr(wire.WireCodec, "encode", spy_encode)
    topo = topology.build_topology(mesh)
    plans = {"flat": planner.flat_plan(mesh=mesh),
             "pipelined": planner.CommPlan(
                 planner.PIPELINED, "model", intra=1, chunks=2,
                 reason="test", topology=topo, mesh=mesh)}
    ys = {}
    for tag, plan in plans.items():
        monkeypatch.setattr(planner, "plan_collectives",
                            lambda *a, plan=plan, **kw: plan)
        calls["fused"], calls["encode"] = 0, []
        ys[tag], _ = lsh_moe_apply(params, x, dataclasses.replace(cfg),
                                   mlp_act="swiglu", mode="train",
                                   use_lsh=use_lsh, mesh=mesh)
        if tag == "flat":
            assert calls["fused"] == 2, calls
        else:
            assert calls["fused"] == 0, calls
            # two legs, two chunks each, all of one shape
            shapes = calls["encode"]
            assert len(shapes) == 4 and len(set(shapes)) == 1, shapes
    np.testing.assert_array_equal(ys["pipelined"].numpy(),
                                  ys["flat"].numpy())


@pytest.mark.parametrize("chunks", (2, 4))
@pytest.mark.parametrize("fmt", CODED)
def test_chunk_encode_is_the_slice_of_the_whole(fmt, chunks):
    """Quantization is per slot row, so each slot chunk's encode is
    bitwise the chunk of the whole tensor's, payload and scales alike,
    and so is its decode."""
    from repro_torch.comm import wire
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal((4, 3, 16, 24))
                          * rng.lognormal(0, 3, (4, 3, 16, 1))).astype(
                              np.float32))
    codec = wire.make_codec(fmt, compute_dtype=torch.float32)
    q, sc = codec.encode(x)
    dq = codec.decode((q, sc))
    n = x.shape[2] // chunks
    for j in range(chunks):
        sl = slice(j * n, (j + 1) * n)
        qc, scc = codec.encode(x[:, :, sl].contiguous())
        assert np.array_equal(_bits(qc), _bits(q[:, :, sl]))
        assert np.array_equal(_bits(scc), _bits(sc[:, :, sl]))
        assert np.array_equal(
            _bits(codec.decode((qc, scc))), _bits(dq[:, :, sl]))


def test_profile_comm_on_four_cpu_ranks(tmp_path):
    """``launch/profile_comm.py`` under torchrun on four gloo ranks, cut
    to the smoke config: every check passes and every part reports."""
    import json
    import subprocess
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    for k in ("REPRO_TUNE", "REPRO_COMM_IMPL", "REPRO_NODE_SIZE"):
        env.pop(k, None)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.profile_comm",
         "--device", "cpu", "--smoke", "--batch", "2", "--seq", "32",
         "--slots", "16", "--reps", "2", "--ladder", "4096"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    recs = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    kinds = [r["kind"] for r in recs]
    assert kinds.count("legs") == 4 and kinds.count("coded_legs") == 2
    assert kinds.count("layer") == 2 and kinds.count("tune") == 1
    for r in recs:
        if r["kind"] in ("legs", "coded_legs"):
            assert all(r["bitwise_flat"].values()), r
        if r["kind"] == "layer":
            assert all(c["ok"] for c in r["against_flat"].values()), r
            assert r["against_flat"]["hierarchical"]["y_bitwise"]
    (tune,) = [r for r in recs if r["kind"] == "tune"]
    assert tune["stored"] and tune["plan_int8_training_shape"]["calibrated"]


if __name__ == "__main__":                  # RANK WORLD STORE args...
    sys.exit(tmesh.run_cpu_rank(sys.argv[1:], _port_main))
