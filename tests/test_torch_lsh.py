"""The port's LSH ops against the JAX package's: the plain versions of
``lsh_hash``, ``segment_centroid`` and ``residual_apply`` against
``repro.kernels.ref`` and the Pallas kernels in interpret mode; the four
``torch.autograd.Function`` backwards against ``jax.vjp`` of the JAX custom
VJPs; the hash folding and slot assignment; and ``compress`` /
``decompress``.  The CUDA kernels are held against these plain versions on
the card (test_torch_cuda.py, chip_smoke.py).

Inputs are made with numpy from fixed seeds.  Tolerances:
- vertex ids: equal on every row whose two largest |v| differ by more than
  NEAR_TIE times the largest (the hash is discontinuous, and two f32
  products summed in another order may pick another vertex at a near-tie);
  the other rows are counted and printed;
- integer outputs, gathers and counts: exact;
- sums (centroids, scatters, and backwards that sum): within 1e-6 of the
  sum of the magnitudes of their terms, or absolute 1e-6 where stated.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # parallel test workers share the cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core import clustering as jclust
from repro.core import hashing as jhash
from repro.kernels import dispatch as jdispatch
from repro.kernels import ref as jref
from repro_torch.core import clustering as tclust
from repro_torch.core import hashing as thash
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import lsh_hash as lsh_hash_k
from repro_torch.kernels import segment_centroid as segment_centroid_k
from repro_torch.kernels.lsh_hash import near_tie_margin
from test_torch_wire import _bits, near_midpoint

JAX_BACKENDS = ("reference", "pallas_interpret")
NEAR_TIE = 1e-5
RTOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _slots(rng, g, c, s):
    """Slot ids with the overflow bin (s), a far id (s + 5) and -1."""
    slots = rng.integers(0, s, size=(g, c)).astype(np.int32)
    slots[0, :7] = s
    slots[-1, 3] = s + 5
    slots[-1, 4] = -1
    return slots


def _assert_vertices(got, want, margin, what):
    ok = margin > NEAR_TIE
    np.testing.assert_array_equal(got[ok], want[ok], err_msg=what)
    print(f"{what}: {int((~ok).sum())} of {ok.size} (token, hash) pairs "
          f"within the near-tie margin; smallest margin {margin.min():.3g}")


# ------------------------------------------------------------- lsh_hash --

@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_lsh_hash_matches_jax(backend, x_dtype):
    """T = 300 crosses the Pallas 128-token tiles; rows 0 and 1 are zero
    (vertex 0, as unfilled dispatch-buffer rows)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 48)).astype(np.float32)
    x[:2] = 0.0
    rot = (rng.standard_normal((3, 48, 16)) / np.sqrt(48)).astype(np.float32)
    jx = jnp.asarray(x).astype(x_dtype)
    want = np.asarray(jdispatch.lsh_hash(jx.astype(jnp.float32),
                                         jnp.asarray(rot), backend=backend))
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, x_dtype))
    got = dispatch.lsh_hash(tx, _t(rot))
    assert got.dtype == torch.int32 and got.shape == (300, 3)
    assert (got[:2] == 0).all()
    _assert_vertices(got.numpy(), want, near_tie_margin(tx, _t(rot)).numpy(),
                     f"lsh_hash vs {backend}")


def test_lsh_hash_exact_tie_takes_first_index_and_its_sign():
    """Columns 5 and 9 of R equal column 2 negated: three exactly tied |v|.
    The ref rule takes index 2 with the sign of v[2] (the Pallas body would
    sum v over the tie instead, which this port does not follow)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((40, 32)).astype(np.float32)
    rot = rng.standard_normal((2, 32, 12)).astype(np.float32) * 0.01
    rot[:, :, 2] = rng.standard_normal((2, 32)) * 10.0
    rot[:, :, 5] = -rot[:, :, 2]
    rot[:, :, 9] = -rot[:, :, 2]
    want = np.asarray(jref.lsh_hash_ref(jnp.asarray(x), jnp.asarray(rot)))
    got = dispatch.lsh_hash(_t(x), _t(rot)).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got // 2)) == {2}
    assert set(np.unique(got % 2)) == {0, 1}


@pytest.mark.parametrize("l,h,dr", [(6, 48, 16), (5, 40, 16), (1, 1096, 8),
                                    (3, 36, 12)])
def test_pack_rotations_is_one_gemm_of_all_hashes(l, h, dr):
    """The tensor-core kernel's operand: row l * Dr + d of the packed
    [L * Dr, H] is R[l, :, d], so x @ packed.T is einsum("th,lhd->tld")
    over the original layout, and its argmax gives JAX's vertex ids."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((50, h)).astype(np.float32)
    x[0] = 0.0
    rot = (rng.standard_normal((l, h, dr)) / np.sqrt(h)).astype(np.float32)
    packed = lsh_hash_k.pack_rotations(_t(rot))
    assert packed.shape == (l * dr, h) and packed.is_contiguous()
    for i, d in ((0, 0), (l - 1, dr - 1), (l // 2, dr // 2)):
        assert torch.equal(packed[i * dr + d], _t(rot)[i, :, d])
    v = (_t(x) @ packed.T).view(50, l, dr)
    torch.testing.assert_close(
        v, torch.einsum("th,lhd->tld", _t(x), _t(rot)), rtol=0, atol=1e-5)
    idx = torch.argmax(v.abs(), dim=-1)
    sign = torch.gather(v, -1, idx[..., None])[..., 0] < 0
    want = np.asarray(jref.lsh_hash_ref(jnp.asarray(x), jnp.asarray(rot)))
    _assert_vertices((2 * idx + sign).numpy(), want,
                     near_tie_margin(_t(x), _t(rot)).numpy(),
                     "packed GEMM vs JAX lsh_hash_ref")


@pytest.mark.parametrize("x_dtype,rot_dtype,h,dr,offset,tensor_cores", [
    (torch.bfloat16, torch.bfloat16, 48, 16, 0, True),   # the training path
    (torch.bfloat16, torch.bfloat16, 40, 8, 0, True),
    (torch.bfloat16, torch.bfloat16, 36, 16, 0, False),  # H % 8 != 0
    (torch.bfloat16, torch.bfloat16, 48, 12, 0, False),  # Dr % 8 != 0
    (torch.bfloat16, torch.bfloat16, 48, 16, 1, False),  # x not 16-byte aligned
    (torch.bfloat16, torch.float32, 48, 16, 0, False),
    (torch.float32, torch.bfloat16, 48, 16, 0, False),
    (torch.float32, torch.float32, 48, 16, 0, False)])
def test_lsh_hash_kernel_choice(x_dtype, rot_dtype, h, dr, offset,
                                tensor_cores):
    """Which kernel a CUDA input would take, decided from dtypes, shapes and
    x's address alone (the rotations are packed into a fresh tensor)."""
    flat = torch.zeros(10 * h + offset, dtype=x_dtype)
    x = flat[offset:].view(10, h)
    rot = torch.zeros(3, h, dr, dtype=rot_dtype)
    assert lsh_hash_k.uses_tensor_cores(x, rot) is tensor_cores


def test_fold_wraps_int32_like_jax():
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 128, size=(50, 6)).astype(np.int32)
    ids[0] = 127                         # 127 * 1000003^5 wraps many times
    want = np.asarray(jhash._fold(jnp.asarray(ids)))
    got = thash._fold(_t(ids))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 0).any()              # the fold did overflow


def test_assign_slots_floor_mod_of_int_min(monkeypatch):
    """abs(INT_MIN) stays negative; JAX's % is a floor-mod, so the slot is
    still in [0, S)."""
    special = np.array([np.iinfo(np.int32).min, -7, 0, 13, 2 ** 31 - 1],
                       np.int32)
    monkeypatch.setattr(thash, "lsh_hash", lambda *a: _t(special))
    monkeypatch.setattr(tclust, "lsh_hash", lambda *a: _t(special))
    got = tclust.assign_slots(None, None, 24, "cross_polytope")
    want = np.abs(special) % np.int32(24)           # numpy: floor-mod too
    want_j = np.asarray(jnp.abs(jnp.asarray(special)) % jnp.int32(24))
    np.testing.assert_array_equal(want, want_j)
    np.testing.assert_array_equal(got.numpy(), want_j)
    assert got.dtype == torch.int32 and (got.numpy() >= 0).all()


def test_spherical_hash_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 9, 32)).astype(np.float32)
    rot = rng.standard_normal((5, 32, 8)).astype(np.float32)
    want = np.asarray(jhash.spherical_hash(jnp.asarray(x), jnp.asarray(rot)))
    got = thash.lsh_hash(_t(x), _t(rot), "spherical")
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------- segment_centroid / residual --

def _slot_set(rng, g, c, s, dist):
    """Slot ids of one of the distributions the CUDA kernel is designed
    for: "uniform" (_slots: with the overflow bin, a far id and -1), "one
    slot" (all rows of every group in slot s - 1), "clamped" (what
    decompress hands residual_apply's backward: each group's first n rows
    occupied, n = 0, 0.8 c and c, uniform slots, the unoccupied rows sent
    to the overflow bin s and then clamped into s - 1)."""
    if dist == "uniform":
        return _slots(rng, g, c, s)
    if dist == "one slot":
        return np.full((g, c), s - 1, dtype=np.int32)
    occupied = np.arange(c)[None] < np.array([0, int(0.8 * c), c])[:g, None]
    slots = np.where(occupied, rng.integers(0, s, size=(g, c)), s)
    return np.minimum(slots, s - 1).astype(np.int32)


@pytest.mark.parametrize("dist", ["uniform", "one slot", "clamped"])
@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_segment_centroid_matches_jax(backend, x_dtype, dist):
    """C = 200 is not a multiple of the Pallas 128-row tile nor of the
    CUDA kernel's 64-row item; the overflow bin and the out-of-range ids
    count nowhere; skewed slot sets as the training path has them."""
    rng = np.random.default_rng(4)
    g, c, s, h = 3, 200, 24, 20
    slots = _slot_set(rng, g, c, s, dist)
    jx = jnp.asarray(rng.standard_normal((g, c, h)).astype(np.float32)
                     ).astype(x_dtype)
    cent, counts = jdispatch.segment_centroid(jnp.asarray(slots), jx, s,
                                              backend=backend)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, x_dtype))
    tcent, tcounts = dispatch.segment_centroid(_t(slots), tx, s)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(counts))
    assert tcounts.sum() == {"uniform": g * c - 9}.get(dist, g * c)
    if dist != "uniform":     # a cold group: every row in slot s - 1
        assert tcounts[0, s - 1] == c
    if dist == "clamped":
        assert tcounts[1, s - 1] >= c - int(0.8 * c)
    mag, _ = ref.segment_centroid_ref(_t(slots), tx.float().abs(), s)
    assert (np.abs(tcent.numpy() - np.asarray(cent))
            <= RTOL * mag.numpy()).all()


@pytest.mark.parametrize("c", [1, 63, 64, 65, 200, 1024, 1025])
def test_segment_centroid_work_bounds(c):
    """The CUDA kernel's work layout, which the wrapper gives it, and the
    scratch sized by it hold every slot distribution's work items: all
    rows in one slot, slots of R + 1 rows (the most slots of several
    items), of R and of 2R + 1, one row each, none, and random skews; the
    bounds are reached where they are tight."""
    r = segment_centroid_k.ROWS_PER_ITEM
    rng = np.random.default_rng(40)
    s = 300
    cases = [[c], [r + 1] * (c // (r + 1)), [r] * (c // r),
             [2 * r + 1] * (c // (2 * r + 1)), [1] * min(c, s), []]
    for _ in range(20):
        cases.append(np.bincount(rng.integers(
            0, rng.integers(1, s + 1), size=c), minlength=1).tolist())
    bound = segment_centroid_k.work_bounds(c, s)
    seen = [0, 0, 0]
    for sizes in cases:
        counts = np.zeros(s, dtype=np.int64)
        counts[:len(sizes)] = sizes
        assert counts.sum() <= c
        k = np.maximum(1, -(-counts // r))
        got = (int(k.sum()), int((k > 1).sum()), int(k[k > 1].sum()))
        assert all(g <= b for g, b in zip(got, bound)), (sizes, got, bound)
        seen = [max(a, g) for a, g in zip(seen, got)]
    assert seen[1] == bound[1]      # slots of r + 1 rows
    assert bound[0] - seen[0] <= 1 and bound[2] - seen[2] <= 2
    assert (bound[2] == 0) == (c <= r)    # no partial sums to keep
    assert 1 <= r <= 192                  # the reduce kernel's threads
    words, floats = segment_centroid_k.scratch_sizes(3, c, s, 20)
    assert words % 4 == 0                 # the partials 16-byte aligned
    assert 0 <= words - 3 * (4 * bound[0] + 4 * bound[1] + c + 2) < 4
    assert floats == 3 * bound[2] * 20


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("residual", [True, False])
def test_residual_apply_matches_jax(backend, residual):
    rng = np.random.default_rng(5)
    g, c, s, h = 3, 200, 24, 20
    slots = _slots(rng, g, c, s)
    eout = rng.standard_normal((g, s, h)).astype(np.float32)
    res = rng.standard_normal((g, c, h)).astype(np.float32)
    want = np.asarray(jdispatch.residual_apply(
        jnp.asarray(slots), jnp.asarray(eout),
        jnp.asarray(res if residual else np.zeros_like(res)),
        backend=backend))
    got = dispatch.residual_apply(_t(slots), _t(eout),
                                  _t(res) if residual else None)
    np.testing.assert_array_equal(got.numpy(), want)
    out_of_range = (slots >= s) | (slots < 0)
    np.testing.assert_array_equal(
        got.numpy()[out_of_range], res[out_of_range] if residual else 0.0)


# --------------------------------------------------------- the backwards --

def _routing(rng, f=300, e=5, c=16, h=24):
    ids = rng.integers(0, e, size=f).astype(np.int32)
    ids[[0, 3, 60]] = [-1, e + 2, e]
    pos, keep, _ = jdispatch.positions_in_expert(jnp.asarray(ids), e, c,
                                                 backend="reference")
    flat = np.where(np.asarray(keep), ids, e).astype(np.int32)
    return flat, np.asarray(pos), e, c, h


@pytest.mark.parametrize("op", ["segment_centroid", "residual_apply",
                                "dispatch_scatter", "combine_gather"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_backward_matches_jax_vjp(op, x_dtype):
    """Each autograd.Function backward against jax.vjp of the
    pallas_interpret custom VJP on the same cotangent, within 1e-6; the
    cotangent comes back in the primal's dtype."""
    rng = np.random.default_rng(6)
    be = "pallas_interpret"
    dt = getattr(torch, x_dtype)

    def pair(a):
        j = jnp.asarray(a).astype(x_dtype)
        return j, _t(np.asarray(j.astype(jnp.float32))).to(dt) \
            .requires_grad_(True)

    if op in ("segment_centroid", "residual_apply"):
        g, c, s, h = 2, 150, 16, 12
        slots = _slots(rng, g, c, s)
        if op == "segment_centroid":
            jx, tx = pair(rng.standard_normal((g, c, h)))
            ct = rng.standard_normal((g, s, h)).astype(np.float32)
            _, vjp = jax.vjp(lambda x: jdispatch.segment_centroid(
                jnp.asarray(slots), x, s, backend=be)[0], jx)
            want = vjp(jnp.asarray(ct))
            out = dispatch.segment_centroid(_t(slots), tx, s)[0]
            got = torch.autograd.grad(out, [tx], _t(ct))
        else:
            je, te = pair(rng.standard_normal((g, s, h)))
            jr, tr = pair(rng.standard_normal((g, c, h)))
            ct = rng.standard_normal((g, c, h)).astype(np.float32)
            _, vjp = jax.vjp(lambda e, r: jdispatch.residual_apply(
                jnp.asarray(slots), e, r, backend=be), je, jr)
            want = vjp(jnp.asarray(ct))
            out = dispatch.residual_apply(_t(slots), te, tr)
            got = torch.autograd.grad(out, [te, tr], _t(ct))
    else:
        flat, pos, e, c, h = _routing(rng)
        if op == "dispatch_scatter":
            js, ts = pair(rng.standard_normal((flat.shape[0], h)))
            ct = rng.standard_normal((e, c, h)).astype(np.float32)
            _, vjp = jax.vjp(lambda x: jdispatch.dispatch_scatter(
                jnp.asarray(flat), jnp.asarray(pos), x, e, c, backend=be), js)
            want = vjp(jnp.asarray(ct))
            out = dispatch.dispatch_scatter(_t(flat), _t(pos), ts, e, c)
            got = torch.autograd.grad(out, [ts], _t(ct))
        else:
            jb = jnp.asarray(rng.standard_normal((e, c, h)).astype(
                np.float32))
            tb = _t(np.asarray(jb)).requires_grad_(True)
            jw = jnp.asarray(rng.uniform(size=flat.shape[0]).astype(
                np.float32))
            tw = _t(np.asarray(jw)).requires_grad_(True)
            ct = rng.standard_normal((flat.shape[0], h)).astype(np.float32)
            _, vjp = jax.vjp(lambda b, w: jdispatch.combine_gather(
                jnp.asarray(flat), jnp.asarray(pos), b, w, backend=be),
                jb, jw)
            want = vjp(jnp.asarray(ct))
            out = dispatch.combine_gather(_t(flat), _t(pos), tb, tw)
            got = torch.autograd.grad(out, [tb, tw], _t(ct))
    assert len(got) == len(want)
    for gt, wt in zip(got, want):
        assert str(gt.dtype).split(".")[-1] == str(wt.dtype)
        np.testing.assert_allclose(gt.float().numpy(),
                                   np.asarray(wt.astype(jnp.float32)),
                                   rtol=RTOL, atol=RTOL)


# ------------------------------------------------- compress / decompress --

@pytest.mark.parametrize("wire_format", [None, "bf16", "int8", "fp8"])
@pytest.mark.parametrize("compensation", [True, False])
def test_compress_decompress_match_jax(wire_format, compensation):
    """The same tokens, occupancy and rotations: equal slots and counts,
    centroids and the decompressed expert outputs (an identity-plus-scale
    'expert') within 1e-6; gradients of the round trip within 1e-6.

    Under int8 / fp8 the two packages quantize centroids that they summed
    in another order: payload bits and scales must be equal wherever the
    port's scaled centroid lies outside the 1e-6 margin of a rounding
    midpoint (the counts in and out of it are printed); this seed puts
    none inside it, so the comparisons above hold as they are."""
    rng = np.random.default_rng(7)
    g, c, h, s = 3, 40, 32, 8
    tokens = rng.standard_normal((g, c, h)).astype(np.float32)
    valid = rng.uniform(size=(g, c)) < 0.8
    rot = (rng.standard_normal((4, h, 16)) / np.sqrt(h)).astype(np.float32)
    ct = rng.standard_normal((g, c, h)).astype(np.float32)

    def j_round(tok):
        comp = jclust.compress(tok, jnp.asarray(valid), jnp.asarray(rot), s,
                               "cross_polytope", compensation,
                               backend="reference", wire_format=wire_format)
        y = jclust.decompress(comp.centroids.astype(jnp.float32) * 1.5,
                              comp, backend="reference")
        return y, comp

    jy, jcomp = j_round(jnp.asarray(tokens))
    _, vjp = jax.vjp(lambda t: j_round(t)[0], jnp.asarray(tokens))
    (jdx,) = vjp(jnp.asarray(ct))

    tt = _t(tokens).requires_grad_(True)
    tcomp = tclust.compress(tt, _t(valid), _t(rot), s, "cross_polytope",
                            compensation, wire_format=wire_format)
    ty = tclust.decompress(tcomp.centroids.float() * 1.5, tcomp)
    (tdx,) = torch.autograd.grad(ty, [tt], _t(ct))

    if wire_format in ("int8", "fp8"):
        cent32, _ = ref.segment_centroid_ref(
            _t(np.where(valid, np.asarray(jcomp.slots), s).astype(np.int32)),
            tt.detach(), s)
        y = (cent32 / tcomp.scales[..., None]).numpy()
        near = near_midpoint(y, wire_format)
        tb, jb = _bits(tcomp.payload), _bits(jcomp.payload)
        print(f"{wire_format}: {int(near.sum())} scaled centroids within "
              f"the midpoint margin, {int((~near).sum())} outside; "
              f"{int((tb != jb).sum())} payload elements differ")
        np.testing.assert_array_equal(tb[~near], jb[~near])
        assert not near.any()
        np.testing.assert_array_equal(tcomp.scales.numpy(),
                                      np.asarray(jcomp.scales))
    np.testing.assert_array_equal(tcomp.slots.numpy(), np.asarray(jcomp.slots))
    np.testing.assert_array_equal(tcomp.counts.numpy(),
                                  np.asarray(jcomp.counts))
    np.testing.assert_allclose(tcomp.centroids.detach().numpy(),
                               np.asarray(jcomp.centroids), atol=1e-6)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=1e-6)
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), atol=1e-6)
    if compensation:
        assert tcomp.residuals is None and tcomp.tokens is tt
        # the diagnostic view JAX returns: tokens - centroids[slot]
        unclamped = np.where(valid, np.asarray(jcomp.slots), s)
        view = tokens - ref.residual_apply_ref(
            _t(unclamped.astype(np.int32)),
            tcomp.centroids.detach().float()).numpy()
        np.testing.assert_allclose(view, np.asarray(jcomp.residuals),
                                   atol=1e-6)
    else:
        assert tcomp.tokens is None and (tcomp.residuals == 0).all()
    stats = tclust.compression_stats(tcomp, _t(valid), wire_format)
    jstats = jclust.compression_stats(jcomp, jnp.asarray(valid), wire_format)
    for k in ("configured_rate", "wire_bytes", "wire_bytes_ratio_vs_bf16"):
        assert stats[k] == jstats[k], k
    for k in ("occupied_slots", "effective_rate"):
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                   rtol=1e-6, err_msg=k)
