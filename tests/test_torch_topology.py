"""The port's topology, cost model and planner (comm/topology.py,
comm/planner.py) against the reference's, in one process.

``repro.comm.topology`` imports no JAX, so ``factor``, ``a2a_cost`` and
``stage_transfer_cost`` are compared over a grid of axis sizes, node
sizes, message sizes, algorithms and chunk counts, with the link
constants set equal on both sides (the port's priors are an H100 node's,
the reference's another platform's): hop, messages and bytes equal,
seconds within 1e-12 relative.  The planner is compared over a grid of
(config, $REPRO_COMM_IMPL, axis size, node size, message, chunk extent,
pipeline, calibration): the resolved algorithm, intra, chunks,
calibrated flag, base transport (a bubble plan's) and reason equal the
reference's, the bubble variant included.  Then the planner cases of the
reference's tests/test_comm.py.
"""
import itertools
import logging
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # parallel test workers share the cores
pytest.importorskip("jax")

HERE = Path(__file__).resolve()
SRC = HERE.parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro.comm import planner as jplanner  # noqa: E402
from repro.comm import topology as jtopo  # noqa: E402
from repro.configs.base import CommConfig as JCommConfig  # noqa: E402
from repro.tune.model import CalibratedCostModel as JCalib  # noqa: E402
from repro.tune.model import MeasuredRow as JRow  # noqa: E402
from repro_torch.comm import planner as tplanner  # noqa: E402
from repro_torch.comm import topology as ttopo  # noqa: E402
from repro_torch.configs.base import CommConfig  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.tune.model import CalibratedCostModel as TCalib  # noqa: E402
from repro_torch.tune.model import MeasuredRow as TRow  # noqa: E402

LINKS = dict(intra_bw=3e11, inter_bw=2e10, intra_lat=2e-6, inter_lat=4e-5)
AXES = (1, 2, 4, 6, 8, 16)
NODES = (0, 1, 2, 3, 4, 8, 16)
MSGS = (0, 1 << 10, 1 << 20, 1 << 24)
ALGOS = ("flat", "hierarchical", "pipelined", "bubble")


def _topos(r, node, **links):
    sizes = (("data", 2), ("model", r), ("pipe", r))
    return (jtopo.Topology(axis_sizes=sizes, node_size=node, **links),
            ttopo.Topology(axis_sizes=sizes, node_size=node, **links))


def _same_hops(a, b):
    assert [(h.hop, h.messages) for h in a] == \
        [(h.hop, h.messages) for h in b]
    for x, y in zip(a, b):
        assert y.bytes == pytest.approx(x.bytes, rel=1e-12)
        assert y.seconds == pytest.approx(x.seconds, rel=1e-12)


@pytest.mark.parametrize("algorithm", ALGOS)
@pytest.mark.parametrize("r", AXES)
def test_cost_model_matches_the_reference(r, algorithm):
    for node, msg, chunks in itertools.product(NODES, MSGS, (1, 2, 4)):
        jt, tt = _topos(r, node, **LINKS)
        assert tt.factor("model") == jt.factor("model")
        assert tt.can_factor("model") == jt.can_factor("model")
        _same_hops(jtopo.a2a_cost(jt, "model", msg, algorithm,
                                  chunks=chunks),
                   ttopo.a2a_cost(tt, "model", msg, algorithm,
                                  chunks=chunks))
        _same_hops(jtopo.stage_transfer_cost(jt, msg),
                   ttopo.stage_transfer_cost(tt, msg))
        assert ttopo.estimate_seconds(ttopo.a2a_cost(
            tt, "model", msg, algorithm, chunks=chunks)) == pytest.approx(
            jtopo.estimate_seconds(jtopo.a2a_cost(
                jt, "model", msg, algorithm, chunks=chunks)), rel=1e-12)


def _calibs():
    """(name, reference's, port's) calibrations, all four constants
    given, so that both price alike."""
    rows = [("a2a", "pipelined", "bf16", 1 << 24, 2, 10e-6),
            ("a2a", "pipelined", "bf16", 1 << 24, 4, 4e-6),
            ("a2a", "flat", "bf16", 1 << 24, 1, 20e-6),
            ("a2a", "hierarchical", "bf16", 1 << 24, 1, 8e-6)]
    slow = dict(intra_bw=1e8, inter_bw=5e10, intra_lat=1e-6,
                inter_lat=1e-7)
    chatty = dict(LINKS, inter_lat=5e-3)
    return [("none", None, None),
            ("slow-intra", JCalib(key="a", **slow), TCalib(key="a", **slow)),
            ("chatty-inter", JCalib(key="b", **chatty),
             TCalib(key="b", **chatty)),
            ("measured", JCalib(key="c", measured=tuple(JRow(*r)
                                                       for r in rows),
                                **LINKS),
             TCalib(key="c", measured=tuple(TRow(*r) for r in rows),
                    **LINKS))]


@pytest.mark.parametrize("env", (None, "flat", "hierarchical", "pipelined"))
@pytest.mark.parametrize("impl", ("auto", "flat", "hierarchical",
                                  "pipelined", "bubble"))
def test_planner_resolves_as_the_reference(impl, env, monkeypatch, caplog):
    caplog.set_level(logging.ERROR)
    if env is None:
        monkeypatch.delenv(tplanner.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(tplanner.ENV_VAR, env)
    monkeypatch.delenv("REPRO_TUNE", raising=False)
    n = 0
    for (overlap, cfg_node, r, node, msg, extent, pipe,
         (cname, jcal, tcal)) in itertools.product(
            (1, 2, 4, 3), (0, 2), (1, 4, 8), (0, 2, 4), (1 << 10, 1 << 24),
            (0, 6, 64, 208), (False, True), _calibs()):
        kw = dict(a2a_impl=impl, overlap_chunks=overlap, node_size=cfg_node)
        jt, tt = _topos(r, node)
        args = dict(msg_bytes=msg, chunk_extent=extent)
        if pipe:
            with jplanner.pipeline_context(2, 4, 0.25):
                want = jplanner.plan_collectives(
                    None, JCommConfig(**kw), topology=jt, calibration=jcal,
                    **args)
        else:
            want = jplanner.plan_collectives(
                None, JCommConfig(**kw), topology=jt, calibration=jcal,
                **args)
        where = (kw, env, r, node, msg, extent, pipe, cname)
        if pipe:
            with tplanner.pipeline_context(2, 4, 0.25):
                got = tplanner.plan_collectives(
                    None, CommConfig(**kw), topology=tt, calibration=tcal,
                    **args)
        else:
            got = tplanner.plan_collectives(
                None, CommConfig(**kw), topology=tt, calibration=tcal,
                **args)
        assert (got.algorithm, got.intra, got.chunks, got.calibrated,
                got.degraded, got.base, got.transport) == (
            want.algorithm, want.intra, want.chunks, want.calibrated,
            want.degraded, want.base, want.transport), where
        assert got.reason == want.reason, where
        n += 1
    assert n > 0


# ------------------------------- the reference's tests/test_comm.py cases --

def _topo(model=8, node=4, data=2):
    return ttopo.Topology(axis_sizes=(("data", data), ("model", model)),
                          node_size=node)


def _plan(comm, *, model=8, node=4, msg=1 << 24, extent=64):
    return tplanner.plan_collectives(None, comm, topology=_topo(model, node),
                                     msg_bytes=msg, chunk_extent=extent)


def test_topology_factoring():
    assert _topo(8, 4).factor("model") == (2, 4)
    assert _topo(8, 2).factor("model") == (4, 2)
    assert _topo(8, 3).factor("model") == (1, 8)      # does not divide
    assert _topo(8, 8).factor("model") == (1, 8)      # fits in one node
    assert _topo(8, 0).factor("model") == (1, 8)      # unknown
    assert _topo(8, 4).can_factor("model")
    assert not _topo(8, 3).can_factor("model")
    assert _topo().axis_size("pod") == 1              # absent axis -> 1


def test_cost_model_hierarchical_reduces_inter_messages():
    t = _topo(16, 4)
    flat = ttopo.a2a_cost(t, "model", 1 << 24, "flat")
    hier = ttopo.a2a_cost(t, "model", 1 << 24, "hierarchical")

    def by_hop(cs, h):
        return [c for c in cs if c.hop == h][0]
    assert by_hop(hier, "inter").messages < by_hop(flat, "inter").messages
    assert by_hop(hier, "inter").bytes == pytest.approx(
        by_hop(flat, "inter").bytes)
    assert ttopo.estimate_seconds(hier) < ttopo.estimate_seconds(flat)
    pipe = ttopo.a2a_cost(t, "model", 1 << 24, "pipelined", chunks=4)
    assert sum(c.bytes for c in pipe) == pytest.approx(
        sum(c.bytes for c in flat))
    assert sum(c.messages for c in pipe) == 4 * sum(c.messages for c in flat)
    assert ttopo.a2a_cost(_topo(1, 0), "model", 8, "flat") == ()


def test_planner_explicit_config_wins(monkeypatch):
    monkeypatch.setenv(tplanner.ENV_VAR, tplanner.PIPELINED)
    p = _plan(CommConfig(a2a_impl="hierarchical"))
    assert p.algorithm == tplanner.HIERARCHICAL and p.intra == 4


def test_planner_env_applies_when_config_auto(monkeypatch):
    monkeypatch.setenv(tplanner.ENV_VAR, tplanner.FLAT)
    p = _plan(CommConfig(a2a_impl="auto", overlap_chunks=4))
    assert p.algorithm == tplanner.FLAT
    assert tplanner.ENV_VAR in p.reason


def test_planner_auto_heuristics(monkeypatch):
    monkeypatch.delenv(tplanner.ENV_VAR, raising=False)
    p = _plan(CommConfig(overlap_chunks=4))
    assert p.algorithm == tplanner.PIPELINED and p.chunks == 4
    assert _plan(CommConfig()).algorithm == tplanner.HIERARCHICAL
    assert _plan(CommConfig(), msg=1 << 10).algorithm == tplanner.FLAT


def test_planner_degrades_to_flat(monkeypatch):
    monkeypatch.delenv(tplanner.ENV_VAR, raising=False)
    p = _plan(CommConfig(a2a_impl="hierarchical"), node=3)
    assert p.algorithm == tplanner.FLAT and "does not factor" in p.reason
    p = _plan(CommConfig(a2a_impl="pipelined", overlap_chunks=5), extent=64)
    assert p.algorithm == tplanner.FLAT and p.chunks == 1
    p = _plan(CommConfig(a2a_impl="hierarchical"), model=1)
    assert p.algorithm == tplanner.FLAT and p.degraded


def test_planner_config_node_size_overrides_topology():
    p = tplanner.plan_collectives(
        None, CommConfig(a2a_impl="hierarchical", node_size=2),
        topology=_topo(8, 4), msg_bytes=1 << 24, chunk_extent=64)
    assert p.intra == 2 and p.topology.node_size == 2


def test_planner_unknown_algorithm_raises():
    with pytest.raises(ValueError, match="unknown comm algorithm"):
        _plan(CommConfig(a2a_impl="ring"))


def test_mesh_hint_feeds_topology(monkeypatch):
    """The mesh's node size (make_mesh's argument, or torchrun's
    LOCAL_WORLD_SIZE) stands third, after the config and the
    environment."""
    monkeypatch.delenv(ttopo.ENV_NODE_SIZE, raising=False)
    mesh = Mesh((2, 8), node_size=4)
    t = ttopo.build_topology(mesh, axis_name="model")
    assert t.node_size == 4 and t.factor("model") == (2, 4)
    assert dict(t.axis_sizes) == {"data": 2, "model": 8}
    monkeypatch.setenv(ttopo.ENV_NODE_SIZE, "2")
    assert ttopo.build_topology(mesh).factor("model") == (4, 2)
    assert ttopo.build_topology(mesh, node_size=8).factor("model") == (1, 8)
    assert ttopo.build_topology(None).axis_size("model") == 1


def test_h100_link_priors():
    """The priors are the H100 platform's: NVLink 4 at 450 GB/s each way
    and one 400 Gb/s NDR port a GPU, 50 GB/s each way."""
    assert ttopo.DEFAULT_INTRA_BW == 900e9 / 2
    assert ttopo.DEFAULT_INTER_BW == 400e9 / 8
    t = ttopo.Topology(axis_sizes=(("model", 8),), node_size=4)
    (intra, inter) = ttopo.a2a_cost(t, "model", 1 << 24, "hierarchical")
    assert intra.seconds < inter.seconds


def test_comm_metric_describe():
    assert tplanner.describe_comm_metrics(0) == "flat/raw"
    assert tplanner.describe_comm_metrics(1, 0, 1, 1) == \
        "hierarchical+cal/int8"
    assert tplanner.describe_comm_metrics(2, 1, 0, 0) == \
        "pipelined(degraded)/bf16"
    assert tplanner.describe_comm_metrics(-1) == "unplanned/raw"


def test_plan_events_and_last_plan():
    """A ``comm_plan`` event when the axis's plan changes, none for the
    same plan again; ``last_plan`` keeps the latest."""
    from repro_torch.obs import events
    sink = events.global_log().add_sink(events.MemorySink())
    try:
        for impl in ("flat", "flat", "hierarchical"):
            tplanner.plan_collectives(
                None, CommConfig(a2a_impl=impl), axis_name="events-axis",
                topology=ttopo.Topology(axis_sizes=(("events-axis", 8),),
                                        node_size=4))
    finally:
        events.global_log().remove_sink(sink)
    got = sink.of_kind("comm_plan")
    assert [e.data["algorithm"] for e in got] == ["flat", "hierarchical"]
    assert tplanner.last_plan("events-axis").algorithm == "hierarchical"
