"""How far jamba's smoke train step on the card lies from the CPU's, and
whether a fault would show beyond that.

Runs chip_smoke.py's parity check of phase hybrid (one ``make_train_step``
step of jamba-1.5-large-398b's smoke config in f32, LSH on, f32 wire: the
card's kernels against the CPU's plain versions, from the same params and
batch) on several params seeds and batches, and reads for each:

- the worst gradient leaf's and the worst param-after-AdamW leaf's
  relative L2 between the card and the CPU, the loss's relative gap and
  the slot ids that differ;
- the CPU's own sensitivity: the worst gradient leaf's relative L2 between
  two CPU runs whose embeddings differ by 1e-7 relative.

Then three controls on the first seed, changed on the card's side only:

- ``a_log_ulp``: every ``a_log`` one ulp up (a rounding-size move);
- ``scan_grad_bf16``: the cotangent of the SSD scan's output rounded to
  bf16, a precision fault of the Mamba backward alone (the forward, its
  slots and the loss stay exact);
- ``scan_bf16``: the SSD scan's inputs (x, dt, B, C) rounded to bf16, a
  precision fault of the Mamba forward.

Prints one JSON line a reading and, last, the largest sound gaps beside
chip_smoke.py's bounds.  Needs one CUDA device:

  PYTHONPATH=src python3 scripts/hybrid_parity_sweep.py
"""
from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

# (params seed, batch index); the first is chip_smoke.py's own reading
READINGS = ((5, 0), (6, 1), (7, 2), (8, 3), (9, 4), (10, 5))
SENS_EPS = 1e-7


def sensitivity(torch, model_lib, step_lib, cfg, batch, seed):
    """The worst gradient leaf's relative L2 between the CPU's gradients
    from the params of ``seed`` and from the same params with the
    embedding moved by SENS_EPS relative."""
    from repro_torch.optim.adam import leaves
    cpu = torch.device("cpu")
    grads = []
    for eps in (0.0, SENS_EPS):
        params = model_lib.init_params(cfg, seed=seed, device=cpu)
        table = params["embed"]["table"]
        with torch.no_grad():
            table.mul_(1 + eps * torch.randn(
                table.shape, generator=torch.Generator().manual_seed(9)))
        train = [p for p in leaves(params) if p.is_floating_point()]
        for p in train:
            p.requires_grad_(True)
        loss, _ = model_lib.loss_fn(params, cfg,
                                    step_lib.batch_to_device(batch, cpu))
        grads.append(torch.autograd.grad(loss, train, allow_unused=True))
    return max(float((a.double() - b.double()).norm()
                     / b.double().norm().clamp_min(1e-30))
               for a, b in zip(*grads) if b is not None and b.any())


def a_log_ulp(torch, tree):
    """chip_smoke.tree_to to the card, with every a_log one ulp up."""
    if isinstance(tree, dict):
        return {k: (torch.nextafter(v.detach(), torch.tensor(math.inf))
                    .to("cuda") if k == "a_log" else a_log_ulp(torch, v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [a_log_ulp(torch, v) for v in tree]
    return tree.detach().to("cuda")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("hybrid_parity_sweep: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.base import MOE, OptimizerConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core import clustering
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.kernels import build, dispatch, lsh_hash
    from repro_torch.models import model as model_lib
    from repro_torch.models import ssm
    from repro_torch.runtime import step as step_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    kernels = list(dispatch.KERNELS)
    path = dispatch.ROUTING_KERNELS + dispatch.LSH_KERNELS
    build.build_all(sorted({k.source for k in path}))
    print(f"built in {time.time() - t0:.1f} s; card "
          f"{cs.phase_device(torch)}", flush=True)
    smoke = get_smoke_config(cs.HYB_ARCH).replace(dtype="float32")
    cfg = cs.with_wire(smoke, wire_dtype="float32")
    n_moe = sum(f == MOE for _, f in cfg.layout) * cfg.num_super_blocks
    opt = OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)

    def reading(name, seed, index):
        batch = SyntheticLMDataset(cfg.vocab_size, 64, 2).batch_at(index)
        a, b = cs._parity_runs(torch, model_lib, step_lib, clustering,
                               kernels, {k.name for k in path}, cfg, opt,
                               batch, seed=seed)
        n_diff, margin, loss_rel, g_rel, p_rel = cs._parity_stats(
            torch, lsh_hash, a, b, n_moe)
        row = dict(reading=name, seed=seed, batch=index,
                   slot_ids_differing=n_diff, near_tie_margin=margin,
                   loss_rel=loss_rel, grad_rel_l2=g_rel, param_rel_l2=p_rel)
        if name == "sound":
            row["cpu_sensitivity"] = sensitivity(torch, model_lib, step_lib,
                                                 cfg, batch, seed)
            row["grad_over_sensitivity"] = g_rel / row["cpu_sensitivity"]
        print(json.dumps(row), flush=True)
        return row

    sound = [reading("sound", s, i) for s, i in READINGS]
    seed, index = READINGS[0]
    tree_to = cs.tree_to
    cs.tree_to = lambda tree, device: (a_log_ulp(torch, tree)
                                       if device.type == "cuda"
                                       else tree_to(tree, device))
    try:
        ulp = reading("a_log_ulp", seed, index)
    finally:
        cs.tree_to = tree_to
    scan = ssm._ssd_chunk_scan

    class RoundGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, y):
            return y.clone()

        @staticmethod
        def backward(ctx, g):
            return g.to(torch.bfloat16).to(g.dtype)

    def scan_grad_bf16(xh, dt, a_log, Bm, Cm, chunk):
        y, h = scan(xh, dt, a_log, Bm, Cm, chunk)
        return (RoundGrad.apply(y) if y.is_cuda and y.requires_grad
                else y), h

    def scan_bf16(xh, dt, a_log, Bm, Cm, chunk):
        if xh.is_cuda:
            xh, dt, Bm, Cm = (t.to(torch.bfloat16).to(t.dtype)
                              for t in (xh, dt, Bm, Cm))
        return scan(xh, dt, a_log, Bm, Cm, chunk)

    faults = {}
    for name, fn in (("scan_grad_bf16", scan_grad_bf16),
                     ("scan_bf16", scan_bf16)):
        ssm._ssd_chunk_scan = fn
        try:
            faults[name] = reading(name, seed, index)
        finally:
            ssm._ssd_chunk_scan = scan
    g = max(r["grad_rel_l2"] for r in sound)
    p = max(r["param_rel_l2"] for r in sound)
    print(json.dumps(dict(
        largest_sound_grad_rel_l2=g, largest_sound_param_rel_l2=p,
        a_log_ulp=[ulp["grad_rel_l2"], ulp["param_rel_l2"]],
        **{n: [r["grad_rel_l2"], r["param_rel_l2"]]
           for n, r in faults.items()},
        bounds=[cs.HYB_GRAD_RTOL, cs.HYB_PARAM_RTOL],
        sound_within_bounds=g <= cs.HYB_GRAD_RTOL and p <= cs.HYB_PARAM_RTOL,
        faults_beyond_bounds={
            n: r["grad_rel_l2"] > cs.HYB_GRAD_RTOL
            or r["param_rel_l2"] > cs.HYB_PARAM_RTOL
            for n, r in faults.items()},
        seconds=time.time() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
