"""Phase ranges of the MoE layer (counterpart of ``repro/obs/tracing.py``).

The MoE forward decomposes into the paper's phases

    gate -> hash/compress -> dispatch-a2a -> expert-MLP -> combine-a2a
         -> decompress          (+ stage-transfer at pipeline boundaries)

``phase_scope(PH_*)`` wraps each region in a
``torch.profiler.record_function`` range, which a ``torch.profiler``
trace shows as a ``user_annotation`` event enclosing the region's ops on
the host; obs/profile.py attributes the kernels those ops launch, and
through autograd's sequence numbers the backward's too, to the phase.
The ranges are real only inside an ``activate(True)`` context (entered by
core/moe.py from ``ObsConfig.phase_tracing``) and ``nullcontext``
otherwise: with obs off the step records no range, so library code calls
``phase_scope`` unconditionally and never threads the config.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

from torch.profiler import record_function

# The "obs/" prefix namespaces the ranges; PHASES orders them as they run,
# and obs/timeline.py uses the bare names (PREFIX stripped).
PREFIX = "obs/"
PH_GATE = PREFIX + "gate"
PH_COMPRESS = PREFIX + "hash_compress"
PH_DISPATCH = PREFIX + "dispatch_a2a"
PH_EXPERT = PREFIX + "expert_mlp"
PH_COMBINE = PREFIX + "combine_a2a"
PH_DECOMPRESS = PREFIX + "decompress"
PH_STAGE = PREFIX + "stage_transfer"
PHASES = (PH_GATE, PH_COMPRESS, PH_DISPATCH, PH_EXPERT, PH_COMBINE,
          PH_DECOMPRESS, PH_STAGE)

_ACTIVE: list = []              # a stack of bools; [-1] is the live one


@contextlib.contextmanager
def activate(enabled: bool = True) -> Iterator[None]:
    """Turn the phase ranges on (or explicitly off) for the code run under
    this context; a stack, so nested activations compose."""
    _ACTIVE.append(bool(enabled))
    try:
        yield
    finally:
        _ACTIVE.pop()


def active() -> bool:
    return bool(_ACTIVE) and _ACTIVE[-1]


def phase_scope(name: str):
    """``record_function(name)`` while activated, else a no-op context."""
    if active():
        return record_function(name)
    return contextlib.nullcontext()
