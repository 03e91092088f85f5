"""The port's CUDA kernels against their plain versions on an H100.

These tests need a card with compute capability 9.0 (the kernels are built
for sm_90a) and skip elsewhere with the reason.  The file imports neither
JAX nor the JAX package, so it also runs on a machine without them:

  PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Integer outputs and unique-plan scatter / gather outputs must agree bit for
bit; a scatter with duplicate (expert, position) pairs sums in another
order (the plain version's index_add_ uses atomics on the card), so each
element is held to 1e-6 times the sum of the magnitudes of its terms.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import dispatch, ref, scatter_gather, token_position

DUP_RTOL = 1e-6


@pytest.fixture()
def h100():
    """Skip unless there is a card with compute capability (9, 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device with compute capability (9, 0); "
                    "none is available")
    cap = torch.cuda.get_device_capability()
    if cap != (9, 0):
        pytest.skip(f"kernels are built for sm_90a; this card is sm_{cap}")
    return torch.device("cuda")


def _ids(rng, f, e):
    ids = rng.integers(0, e, size=f).astype(np.int32)
    ids[::97] = -1                          # overflow-bin entries
    ids[5::89] = e + 2
    return torch.from_numpy(ids)


def _plan(rng, f=300, e=5, c=16, h=32):
    ids = _ids(rng, f, e)
    pos, keep, _ = dispatch.positions_in_expert(ids, e, c)   # plain, CPU
    flat = torch.where(keep, ids, e).to(torch.int32)
    src = torch.from_numpy(rng.standard_normal((f, h)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(size=f).astype(np.float32))
    return flat, pos, src, w, e, c


@pytest.mark.cuda
@pytest.mark.parametrize("f,e", [(32, 40), (300, 5), (5000, 40), (3000, 1)])
def test_cuda_positions_in_expert_bitwise(h100, f, e):
    ids = _ids(np.random.default_rng(7), f, e)
    before = token_position.KERNEL.launches
    pos, counts = token_position.positions_in_expert(ids.to(h100), e)
    rpos, rcounts = ref.positions_in_expert_ref(ids, e)
    assert torch.equal(pos.cpu(), rpos) and torch.equal(counts.cpu(), rcounts)
    assert token_position.KERNEL.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("src_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h", [32, 30])
def test_cuda_scatter_gather_bitwise(h100, src_dtype, h):
    """h=30 takes the kernels' one-column path, h=32 the 4-wide one."""
    flat, pos, src, w, e, c = _plan(np.random.default_rng(8), h=h)
    src = src.to(src_dtype)
    buf = scatter_gather.dispatch_scatter(flat.to(h100), pos.to(h100),
                                          src.to(h100), e, c)
    want = ref.dispatch_scatter_ref(flat, pos, src, e, c)
    assert torch.equal(buf.cpu(), want)
    out = scatter_gather.combine_gather(flat.to(h100), pos.to(h100), buf,
                                        w.to(h100))
    assert torch.equal(out.cpu(), ref.combine_gather_ref(flat, pos, want, w))
    assert (out.cpu()[flat == e] == 0).all()


@pytest.mark.cuda
def test_cuda_scatter_duplicates(h100):
    rng = np.random.default_rng(9)
    ids = torch.from_numpy(rng.integers(-1, 5, size=3000).astype(np.int32))
    pos = torch.from_numpy(rng.integers(-1, 9, size=3000).astype(np.int32))
    src = torch.from_numpy(rng.standard_normal((3000, 64)).astype(np.float32))
    got = scatter_gather.dispatch_scatter(ids.to(h100), pos.to(h100),
                                          src.to(h100), 4, 8).cpu()
    want = ref.dispatch_scatter_ref(ids, pos, src, 4, 8)
    magnitude = ref.dispatch_scatter_ref(ids, pos, src.abs(), 4, 8)
    assert ((got - want).abs() <= DUP_RTOL * magnitude).all()


@pytest.mark.cuda
def test_cuda_wrappers_reject_cpu_cuda_mix(h100):
    flat, pos, src, w, e, c = _plan(np.random.default_rng(10))
    with pytest.raises(ValueError, match="different devices"):
        scatter_gather.dispatch_scatter(flat.to(h100), pos, src.to(h100), e, c)
