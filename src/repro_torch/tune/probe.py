"""Timed probes of the production collectives on the live mesh and of the
kernel ops (counterpart of ``repro/tune/probe.py``).

``probe_a2a`` times one planned all-to-all leg, built from the legs the
exchange runs (the flat all-to-all, the 2-hop, the chunked transfer, and
the coded int8 / fp8 transfers with their scales sidecar, chunked through
``wire.transfer_fn``), on a float wire tensor [R, 1, c, H].
``probe_stage_transfer`` times the 1F1B stage leg over ``pipe`` (the
reference's ``ppermute`` ring: ``collectives.raw_ring_shift``).
``probe_kernels`` times the kernel ops through ``kernels/dispatch.py``
(so a CUDA tensor runs the hand-written kernels), at the reference's op
list: ``lsh_hash`` (from f32 tokens: the FMA route, which the bf16
training path does not launch), ``segment_centroid``, and each fused
codec op beside the composed ops it replaces.

Timing: a first call, ``warmup`` calls, then ``iters`` samples, each
between CUDA events on the card and the host clock on the CPU; the
trimmed mean of the samples.  Over several ranks every row is then the
largest of the ranks' times (an all-reduce), so every rank stores the
same rows and plans the same.

Rows are ``model.MeasuredRow``; ``msg_bytes`` is one rank's wire buffer
in the probed format, scales included (``clustering.wire_bytes``).
"""
from __future__ import annotations

import logging
import math
import time
from typing import Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.comm import collectives
from repro_torch.comm import wire as wire_lib
from repro_torch.comm.hierarchical import hierarchical_all_to_all
from repro_torch.comm.pipeline import pipelined_all_to_all
from repro_torch.comm.topology import Topology
from repro_torch.core.clustering import wire_bytes
from repro_torch.core.hashing import make_rotations
from repro_torch.kernels import dispatch
from repro_torch.runtime import sharding
from repro_torch.tune.fingerprint import on_card
from repro_torch.tune.model import MeasuredRow

log = logging.getLogger(__name__)

_PROBE_HIDDEN = 128                      # H of the probe wire tensor


def trimmed_mean(samples: Sequence[float]) -> float:
    """The mean with the least and the largest dropped (from 4 samples)."""
    xs = sorted(samples)
    if len(xs) >= 4:
        xs = xs[1:-1]
    return sum(xs) / len(xs)


def probe_device(device=None) -> torch.device:
    """``device``; else the started group's (the current CUDA device
    under NCCL, the CPU under gloo); else the CUDA device."""
    if device is not None:
        return resolve_device(device)
    if dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device()) \
            if on_card() else torch.device("cpu")
    return resolve_device(None)


def _timed(fn: Callable, args: tuple, *, warmup: int, iters: int,
           device: torch.device) -> float:
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    fn(*args)                                # first call: builds
    sync()
    for _ in range(max(0, warmup)):
        fn(*args)
    sync()
    samples = []
    for _ in range(max(1, iters)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            samples.append(time.perf_counter() - t0)
    return trimmed_mean(samples)


def _slot_count(target_bytes: int, r: int, chunks: int) -> int:
    """Slots c of a [R, 1, c, H] bf16 wire tensor of about
    ``target_bytes``, a multiple of lcm(8, chunks)."""
    unit = math.lcm(8, max(1, chunks))
    c = target_bytes / (r * _PROBE_HIDDEN * 2)
    return max(unit, int(round(c / unit)) * unit)


def _transport_fn(transport: str, mesh, axis_name: str, *, intra: int,
                  chunks: int, wire_format: str):
    """One all-to-all leg of (transport, wire_format), from the
    exchange's own legs."""
    group = sharding.group(mesh, axis_name)
    groups = mesh.hop_groups(intra) if transport == "hierarchical" \
        else None
    if wire_format == "bf16":
        if transport == "flat":
            return lambda x: collectives.all_to_all(x, group)
        if transport == "hierarchical":
            return lambda x: hierarchical_all_to_all(x, groups)
        return lambda x: pipelined_all_to_all(x, group, chunks)
    codec = wire_lib.make_codec(wire_format)
    if transport == "pipelined":
        leg = wire_lib.transfer_fn(codec, group)
        return lambda x: pipelined_all_to_all(x, group, chunks, transfer=leg)
    fwd, bwd = wire_lib.hierarchical_leaves(groups) \
        if transport == "hierarchical" else wire_lib.flat_leaves(group)
    return lambda x: wire_lib.coded_transfer(x, codec, fwd, bwd)


@torch.no_grad()
def probe_a2a(mesh, axis_name: str, transport: str, target_bytes: int, *,
              wire_format: str = "bf16", chunks: int = 1, intra: int = 1,
              warmup: int = 1, iters: int = 5,
              device=None) -> MeasuredRow:
    """Time one planned all-to-all leg over the mesh's ``axis_name``: the
    send tensor is the float [R, 1, c, H] wire layout, which a coded
    format encodes in transit as the exchange does."""
    dev = probe_device(device)
    r = int(mesh.axis_size(axis_name))
    c = _slot_count(target_bytes, r, chunks)
    fmt = None if wire_format == "bf16" else wire_format
    msg = wire_bytes(r, c, _PROBE_HIDDEN, fmt)
    leg = _transport_fn(transport, mesh, axis_name, intra=intra,
                        chunks=chunks, wire_format=wire_format)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((r, 1, c, _PROBE_HIDDEN), generator=gen).to(dev)
    x = x.to(torch.bfloat16) if wire_format == "bf16" else x
    seconds = _timed(leg, (x,), warmup=warmup, iters=iters, device=dev)
    return MeasuredRow(kind="a2a", name=transport, wire_format=wire_format,
                       msg_bytes=int(msg), chunks=int(chunks),
                       seconds=float(seconds))


@torch.no_grad()
def probe_stage_transfer(mesh, target_bytes: int, *, axis_name: str = "pipe",
                         warmup: int = 1, iters: int = 5,
                         device=None) -> MeasuredRow:
    """Time one stage-boundary hand-off over the pipeline axis: each rank
    sends a bf16 activation-shaped [c, H] buffer to the next stage (a
    ring, the reference's single-neighbour ``ppermute``)."""
    dev = probe_device(device)
    c = max(8, int(round(target_bytes / (_PROBE_HIDDEN * 2) / 8)) * 8)
    group = sharding.group(mesh, axis_name)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((c, _PROBE_HIDDEN), generator=gen).to(
        dev, torch.bfloat16)
    seconds = _timed(lambda t: collectives.raw_ring_shift(t, group), (x,),
                     warmup=warmup, iters=iters, device=dev)
    return MeasuredRow(kind="stage", name="ppermute", wire_format="bf16",
                       msg_bytes=int(c * _PROBE_HIDDEN * 2), chunks=1,
                       seconds=float(seconds))


@torch.no_grad()
def probe_kernels(*, sizes: Sequence[Tuple[int, int, int]] = ((8, 256, 128),),
                  num_hashes: int = 4, num_slots: int = 64, warmup: int = 1,
                  iters: int = 5, wire_format: str = "int8",
                  device=None) -> List[MeasuredRow]:
    """Time ``lsh_hash`` and ``segment_centroid``, and each fused codec op
    beside its composed equivalent, at each (g, c, h) of ``sizes``: g
    groups (experts) of c slots of h values, routed round-robin so that
    every row of the [g, c] dispatch buffer is filled."""
    dev = probe_device(device)
    rows = []
    gen = torch.Generator().manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def krow(name, fn, args, fmt="-", nbytes=0):
        return MeasuredRow(
            kind="kernel", name=name, wire_format=fmt,
            msg_bytes=int(nbytes), chunks=1,
            seconds=float(_timed(fn, args, warmup=warmup, iters=iters,
                                 device=dev)))

    for g, c, h in sizes:
        toks = randn(g, c, h)
        rot = make_rotations(gen, num_hashes, h, min(64, h),
                             torch.float32).to(dev)

        def hash_fn(t):                       # the op's contract: [T, H]
            return dispatch.lsh_hash(t.reshape(-1, t.shape[-1]), rot)
        rows.append(krow("lsh_hash", hash_fn, (toks,),
                         nbytes=g * c * h * 4))
        slots = torch.remainder(torch.abs(hash_fn(toks))[:, 0],
                                num_slots).to(torch.int32).reshape(g, c)
        rows.append(krow(
            "segment_centroid",
            lambda s, t: dispatch.segment_centroid(s, t, num_slots),
            (slots, toks), nbytes=g * c * h * 4))

        fmt = wire_format
        wbytes = wire_bytes(g, c, h, fmt)
        flat = randn(g * c, h)
        ids = (torch.arange(g * c, dtype=torch.int32) % g).to(dev)
        pos = (torch.arange(g * c, dtype=torch.int32) // g).to(dev)
        w = torch.abs(randn(g * c))
        rows.append(krow(
            "dispatch_scatter_quantize",
            lambda i, p, s: dispatch.dispatch_scatter_quantize(
                i, p, s, g, c, fmt), (ids, pos, flat), fmt, wbytes))
        rows.append(krow(
            "dispatch_scatter+quantize",
            lambda i, p, s: dispatch.wire_quantize(
                dispatch.dispatch_scatter(i, p, s, g, c), fmt),
            (ids, pos, flat), fmt, wbytes))
        q, sc = dispatch.wire_quantize(toks, fmt)
        rows.append(krow(
            "dequantize_combine_gather", dispatch.dequantize_combine_gather,
            (ids, pos, q, sc, w), fmt, wbytes))
        rows.append(krow(
            "dequantize+combine_gather",
            lambda i, p, qq, ss, ww: dispatch.combine_gather(
                i, p, dispatch.wire_dequantize(qq, ss), ww),
            (ids, pos, q, sc, w), fmt, wbytes))
        resid = randn(g, c, h)
        sl = torch.remainder(slots, c).to(torch.int32)
        rows.append(krow(
            "dequantize_residual_apply", dispatch.dequantize_residual_apply,
            (sl, q, sc, resid), fmt, wbytes))
        rows.append(krow(
            "dequantize+residual_apply",
            lambda s, qq, ss, rr: dispatch.residual_apply(
                s, dispatch.wire_dequantize(qq, ss), rr),
            (sl, q, sc, resid), fmt, wbytes))
    return rows


def _agree(rows: List[MeasuredRow], device: torch.device
           ) -> List[MeasuredRow]:
    """Every row's time, the largest over the ranks (all of them hold the
    same rows, in one order)."""
    if not dist.is_initialized() or dist.get_world_size() == 1 or not rows:
        return rows
    t = torch.tensor([r.seconds for r in rows], dtype=torch.float64,
                     device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return [MeasuredRow(r.kind, r.name, r.wire_format, r.msg_bytes,
                        r.chunks, float(s)) for r, s in zip(rows, t.tolist())]


def run_probe_suite(mesh, topo: Topology, axis_name: str = "model", *,
                    ladder: Sequence[int] = (1 << 16, 1 << 19, 1 << 22),
                    wire_formats: Sequence[str] = ("bf16", "int8"),
                    chunk_candidates: Sequence[int] = (2, 4),
                    warmup: int = 1, iters: int = 5,
                    include_kernels: bool = True, verbose: bool = False,
                    device=None) -> List[MeasuredRow]:
    """Every transport the topology can run x wire format x ladder point
    (pipelined also per chunk candidate), the stage leg at each ladder
    point when the mesh has a pipe axis, then the kernel ops.  On an
    axis of one rank there is no all-to-all row: the planner runs flat
    there whatever the rows say."""
    dev = probe_device(device)
    rows: List[MeasuredRow] = []
    r = topo.axis_size(axis_name)
    inter, intra = topo.factor(axis_name)
    if r > 1:
        transports = [("flat", 1)]
        if inter > 1:
            transports.append(("hierarchical", 1))
        transports += [("pipelined", k) for k in chunk_candidates if k > 1]
        for fmt in wire_formats:
            for nbytes in ladder:
                for name, k in transports:
                    row = probe_a2a(mesh, axis_name, name, nbytes,
                                    wire_format=fmt, chunks=k, intra=intra,
                                    warmup=warmup, iters=iters, device=dev)
                    rows.append(row)
                    if verbose:
                        log.info("probe %s/%s %dB chunks=%d -> %.3fms",
                                 name, fmt, row.msg_bytes, k,
                                 row.seconds * 1e3)
    elif verbose:
        log.info("probe: axis %r has size 1; no a2a rows", axis_name)
    if topo.axis_size("pipe") > 1 and "pipe" in mesh.axis_names:
        for nbytes in ladder:
            row = probe_stage_transfer(mesh, nbytes, warmup=warmup,
                                       iters=iters, device=dev)
            rows.append(row)
            if verbose:
                log.info("probe stage/ppermute %dB -> %.3fms",
                         row.msg_bytes, row.seconds * 1e3)
    if include_kernels:
        rows += probe_kernels(warmup=warmup, iters=iters, device=dev)
    return _agree(rows, dev)

