"""The port's routing ops against the JAX package's (``repro.kernels.ref``
and the Pallas kernels in interpret mode).  The CUDA kernels are held
against their plain versions on the card in test_torch_cuda.py.

Inputs are made with numpy from a fixed seed and handed to both packages.
Integer outputs and unique-plan scatter / gather outputs must agree bit
for bit; a scatter with duplicate (expert, position) pairs sums in another
order, so each element is held to 1e-6 times the sum of the magnitudes of
its terms.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # parallel test workers share the cores
pytest.importorskip("jax")
import jax.numpy as jnp

from repro.kernels import dispatch as jdispatch
from repro.kernels import ref as jref
from repro_torch.kernels import (dispatch, lsh_hash, ref, residual_apply,
                                 scatter_gather, segment_centroid,
                                 token_position)

JAX_BACKENDS = ("reference", "pallas_interpret")
DUP_RTOL = 1e-6
ROOT = Path(__file__).resolve().parents[1]


def _ids(rng, f=300, e=5):
    """f=300 crosses the Pallas kernels' 128-entry tile edges; ids -1, -3
    and e+2 exercise the overflow bin."""
    ids = rng.integers(0, e, size=f).astype(np.int32)
    ids[0], ids[3], ids[60], ids[200] = -3, -1, e + 2, e + 2
    return ids


def _routing(rng, f=300, e=5, c=16, h=32, src_dtype=np.float32):
    """A plan from the JAX reference, with drops to capacity (60 entries
    per expert against c=16) and out-of-range ids."""
    ids = _ids(rng, f, e)
    pos, keep, _ = jdispatch.positions_in_expert(jnp.asarray(ids), e, c,
                                                 backend="reference")
    flat_ids = np.where(np.asarray(keep), ids, e).astype(np.int32)
    src = rng.standard_normal((f, h)).astype(src_dtype)
    w = rng.uniform(size=f).astype(np.float32)
    return flat_ids, np.asarray(pos), src, w, e, c


def _t(a):
    return torch.from_numpy(np.array(a))


def _skewed_ids(rng, f=1001, e=5):
    """f=1001 (not a multiple of the 128-entry tile) with nine in ten ids
    on expert 2, and ids -1 and e out of range."""
    ids = np.where(rng.uniform(size=f) < 0.9, 2,
                   rng.integers(0, e, size=f)).astype(np.int32)
    ids[[7, 500, 1000]] = [-1, e, -1]
    return ids


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("case", ["uniform", "skewed"])
def test_positions_in_expert_matches_jax(backend, case):
    rng = np.random.default_rng(0)
    ids = _ids(rng) if case == "uniform" else _skewed_ids(rng)
    want = jdispatch.positions_in_expert(jnp.asarray(ids), 5, 16,
                                         backend=backend)
    got = dispatch.positions_in_expert(_t(ids), 5, 16)
    for name, a, b in zip(("pos", "keep", "counts"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    # four (three) out-of-range ids
    assert int(got[2].sum()) == (296 if case == "uniform" else 998)


def test_positions_in_expert_ref_raw_matches_jax():
    ids = _ids(np.random.default_rng(1), f=1000, e=7)
    pos, counts = ref.positions_in_expert_ref(_t(ids), 7)
    jpos, jcounts = jref.positions_in_expert_ref(jnp.asarray(ids), 7)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(counts.numpy(),
                                  np.asarray(jcounts).astype(np.int32))
    assert pos.dtype == counts.dtype == torch.int32
    assert (pos.numpy()[[0, 3, 60, 200]] == 0).all()


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("src_dtype", ["float32", "bfloat16"])
def test_dispatch_scatter_matches_jax(backend, src_dtype):
    flat_ids, pos, src, _, e, c = _routing(np.random.default_rng(2))
    jsrc = jnp.asarray(src).astype(src_dtype)
    want = jdispatch.dispatch_scatter(jnp.asarray(flat_ids), jnp.asarray(pos),
                                      jsrc, e, c, backend=backend)
    tsrc = _t(np.asarray(jsrc.astype(jnp.float32))).to(
        getattr(torch, src_dtype))
    got = dispatch.dispatch_scatter(_t(flat_ids), _t(pos), tsrc, e, c)
    assert got.dtype == torch.float32 and got.shape == (e, c, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (F, E, C, H): jamba's decode shape class (few entries, rows split over
# warps), a ragged F and H % 4 == 0, one entry with H % 4 != 0 (the
# one-column-a-lane path on the card), every entry dropped
GATHER_SHAPES = {"decode": (8, 16, 4, 64), "ragged-f": (33, 5, 7, 36),
                 "one-entry": (1, 3, 2, 30), "dropped": (40, 4, 8, 32)}


def _gather_inputs(shape):
    """(ids, positions, buf, weights, dropped) for one shape class of the
    CUDA launcher: "f300" is the original plan (drops to capacity and
    out-of-range ids); the others draw ids in [-2, e + 2) and positions in
    [-1, c + 1), so both can leave the range on either side, with entry 0
    on the buffer's last row; "dropped" has every entry out of range."""
    if shape == "f300":
        flat_ids, pos, _, w, e, c = _routing(np.random.default_rng(3))
        buf = np.random.default_rng(4).standard_normal((e, c, 32)).astype(
            np.float32)
        return flat_ids, pos, buf, w, flat_ids == e
    f, e, c, h = GATHER_SHAPES[shape]
    rng = np.random.default_rng(f * 1000 + h)
    ids = rng.integers(-2, e + 2, size=f).astype(np.int32)
    pos = rng.integers(-1, c + 1, size=f).astype(np.int32)
    ids[0], pos[0] = e - 1, c - 1          # the last row, in range
    if shape == "dropped":
        ids = np.where(rng.uniform(size=f) < 0.5, -1, e).astype(np.int32)
    buf = rng.standard_normal((e, c, h)).astype(np.float32)
    w = rng.standard_normal(f).astype(np.float32)
    dropped = (ids < 0) | (ids >= e) | (pos < 0) | (pos >= c)
    return ids, pos, buf, w, dropped


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("shape", ["f300", *GATHER_SHAPES])
def test_combine_gather_matches_jax(backend, shape):
    ids, pos, buf, w, dropped = _gather_inputs(shape)
    want = jdispatch.combine_gather(jnp.asarray(ids), jnp.asarray(pos),
                                    jnp.asarray(buf), jnp.asarray(w),
                                    backend=backend)
    got = dispatch.combine_gather(_t(ids), _t(pos), _t(buf), _t(w))
    assert got.dtype == torch.float32 and got.shape == (len(ids),
                                                        buf.shape[2])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[dropped] == 0.0).all()
    assert dropped.any() or shape == "one-entry"
    assert dropped.all() == (shape == "dropped")


def test_dispatch_scatter_duplicates_sum():
    """Duplicate (e, c) pairs sum, as the op's contract says; the order of
    the sum differs from the JAX one-hot product, hence the tolerance."""
    rng = np.random.default_rng(5)
    f, e, c, h = 400, 4, 8, 16
    ids = rng.integers(-1, e + 1, size=f).astype(np.int32)
    pos = rng.integers(-1, c + 1, size=f).astype(np.int32)
    src = rng.standard_normal((f, h)).astype(np.float32)
    want = np.asarray(jref.dispatch_scatter_ref(
        jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(src), e, c))
    got = dispatch.dispatch_scatter(_t(ids), _t(pos), _t(src), e, c).numpy()
    magnitude = np.asarray(jref.dispatch_scatter_ref(
        jnp.asarray(ids), jnp.asarray(pos), jnp.abs(jnp.asarray(src)), e, c))
    assert (np.abs(got - want) <= DUP_RTOL * magnitude).all()
    assert np.abs(want).max() > 0


def test_cpu_tensors_take_the_plain_path():
    """On the CPU a wrapper runs its plain version and counts no launch."""
    flat_ids, pos, src, w, e, c = _routing(np.random.default_rng(6))
    kernels = (token_position.KERNEL, scatter_gather.SCATTER,
               scatter_gather.GATHER)
    before = [k.launches for k in kernels]
    ids_t, pos_t = _t(flat_ids), _t(pos)
    p, cnt = token_position.positions_in_expert(ids_t, e)
    rp, rc = ref.positions_in_expert_ref(ids_t, e)
    assert torch.equal(p, rp) and torch.equal(cnt, rc)
    buf = scatter_gather.dispatch_scatter(ids_t, pos_t, _t(src), e, c)
    assert torch.equal(buf, ref.dispatch_scatter_ref(ids_t, pos_t, _t(src),
                                                     e, c))
    out = scatter_gather.combine_gather(ids_t, pos_t, buf, _t(w))
    assert torch.equal(out, ref.combine_gather_ref(ids_t, pos_t, buf, _t(w)))
    assert [k.launches for k in kernels] == before


@pytest.mark.parametrize("bad", ["int64_ids", "2d_ids", "f16_src",
                                 "f64_weights", "f16_hash_x", "hash_h_mismatch",
                                 "int64_slots", "bf16_eout",
                                 "residual_shape"])
def test_wrappers_reject_bad_inputs(bad):
    ids = torch.zeros(4, dtype=torch.int32)
    src = torch.zeros(4, 8)
    buf = torch.zeros(2, 2, 8)
    w = torch.ones(4)
    slots = torch.zeros(2, 4, dtype=torch.int32)
    with pytest.raises(ValueError):
        if bad == "f16_hash_x":
            lsh_hash.lsh_hash(src.half(), torch.zeros(2, 8, 4))
        elif bad == "hash_h_mismatch":
            lsh_hash.lsh_hash(src, torch.zeros(2, 6, 4))
        elif bad == "int64_slots":
            segment_centroid.segment_centroid(slots.long(), buf.new_zeros(
                2, 4, 8), 3)
        elif bad == "bf16_eout":
            residual_apply.residual_apply(slots, buf.bfloat16())
        elif bad == "residual_shape":
            residual_apply.residual_apply(slots, buf, torch.zeros(2, 3, 8))
        elif bad == "int64_ids":
            token_position.positions_in_expert(ids.long(), 2)
        elif bad == "2d_ids":
            scatter_gather.dispatch_scatter(ids[None], ids[None], src, 2, 2)
        elif bad == "f16_src":
            scatter_gather.dispatch_scatter(ids, ids, src.half(), 2, 2)
        else:
            scatter_gather.combine_gather(ids, ids, buf, w.double())


def test_lsh_kernels_on_cpu_take_the_plain_path():
    """The three LSH wrappers run their plain versions on the CPU and count
    no launch."""
    rng = np.random.default_rng(8)
    kernels = (lsh_hash.KERNEL, segment_centroid.KERNEL,
               residual_apply.KERNEL)
    before = [k.launches for k in kernels]
    x = _t(rng.standard_normal((2, 50, 16)).astype(np.float32))
    rot = _t(rng.standard_normal((3, 16, 8)).astype(np.float32))
    slots = _t(rng.integers(0, 7, size=(2, 50)).astype(np.int32))
    assert torch.equal(lsh_hash.lsh_hash(x[0], rot),
                       ref.lsh_hash_ref(x[0], rot))
    cent, counts = segment_centroid.segment_centroid(slots, x, 6)
    rc, rn = ref.segment_centroid_ref(slots, x, 6)
    assert torch.equal(cent, rc) and torch.equal(counts, rn)
    assert torch.equal(residual_apply.residual_apply(slots, cent, x),
                       ref.residual_apply_ref(slots, cent, x))
    assert [k.launches for k in kernels] == before


def test_cuda_tests_skip_without_an_h100_and_say_why():
    """Without a card of compute capability (9, 0) every test of
    test_torch_cuda.py skips, and the skip states its reason."""
    if (torch.cuda.is_available()
            and torch.cuda.get_device_capability() == (9, 0)):
        pytest.skip("an H100 is present, so the CUDA tests run instead")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rs", "-p",
         "no:cacheprovider", "--noconftest", "tests/test_torch_cuda.py"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "passed" not in res.stdout and "skipped" in res.stdout
    assert "needs a CUDA device with compute capability (9, 0)" in res.stdout
