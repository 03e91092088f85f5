"""The port's quantized wire (int8 / fp8-e4m3 payload with power-of-two
scales) against the JAX package's: ``wire_quantize`` / ``wire_dequantize``,
the three fused codec ops, the coded, precoded and fused transfers with
their gradients, ``compress`` / ``decompress`` under a quantized wire, and
the train-path MoE layer.  The JAX side runs its ``reference`` and
``pallas_interpret`` backends.  The CUDA kernels are held against these
plain versions on the card (test_torch_cuda.py, chip_smoke.py).

Inputs come from numpy with fixed seeds.  Tolerances:
- payload bits (fp8 compared as uint8) and scales: bitwise on the same
  inputs.  Where the two packages quantize values they computed
  separately (centroids, expert outputs), bitwise except where the scaled
  value lies within 1e-6 (relative) of a rounding midpoint of the format:
  there a last-bit difference of the f32 input may round to the next
  quantum.  The count in and out of that margin is printed;
- values built from the same payload (dequantize, the fused ops, the
  transfers' values): bitwise;
- gradients that are segment sums (the slot gather's transpose) or row
  dot products (the combine weights'): within 1e-6 of the sum of the
  magnitudes of their terms, and, after the backward wire's bf16
  rounding, within one bf16 step (2**-8 relative);
- fused against composed in the port: bitwise, values and gradients.

Two flushes of the reference, which runs where subnormal floats flush to
zero, are emulated (kernels/ref.py): a row whose absmax is subnormal is
empty, and a dequantized value below 2**-126 is a zero of its sign (an
fp8 payload under a row scale of 2**-117 or less), which
test_dequantize_subnormal_rows_match_jax pins.  Other f32 arithmetic does
not flush in the port, so the other inputs here keep every nonzero value
of a non-empty row at or above 2**-126 times its scale.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # parallel test workers share the cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.comm import wire as jwire
from repro.compat import set_mesh
from repro.configs import base as jbase
from repro.core import clustering as jclust
from repro.core.lsh_moe import lsh_moe_apply as j_lsh_moe_apply
from repro.core.lsh_moe import lsh_moe_init as j_lsh_moe_init
from repro.kernels import dispatch as jdispatch
from repro.kernels.wire_quant import po2_scale as j_po2_scale
from repro.kernels.wire_quant import quant_dtype as j_quant_dtype
from repro_torch.comm import planner as tplanner
from repro_torch.comm import wire as twire
from repro_torch.configs import base as tbase
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import clustering as tclust
from repro_torch.core.hashing import make_rotations
from repro_torch.core.lsh_moe import lsh_moe_apply
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels.wire_quant import qmax
from repro_torch.launch.mesh import Mesh

JAX_BACKENDS = ("reference", "pallas_interpret")
FORMATS = ("int8", "fp8")
MIDPOINT = 1e-6
RTOL = 1e-6
BF16_STEP = 2.0 ** -8
CPU = torch.device("cpu")


def _t(a):
    """numpy (or JAX) array -> torch tensor, fp8 and bf16 through their
    bits."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return tensor_from_numpy(a, CPU)


def _bits(q):
    """A payload as comparable integers: fp8 as its uint8 bits."""
    if isinstance(q, torch.Tensor):
        return (q.view(torch.uint8) if q.dtype == torch.float8_e4m3fn
                else q).numpy()
    q = np.asarray(q)
    return q.view(np.uint8) if q.dtype.name == "float8_e4m3fn" else q


def near_midpoint(y, fmt):
    """True where the scaled value y lies within MIDPOINT * |y| of a
    rounding midpoint of ``fmt`` (int8: k + 1/2; fp8-e4m3: halfway between
    neighbours, 2**(e - 3) apart, 2**-9 below 2**-6)."""
    a = np.abs(np.asarray(y, np.float64))
    if fmt == "int8":
        dist = np.abs(a - np.floor(a) - 0.5)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(a, 2.0 ** -6))) - 3)
        dist = np.abs(np.mod(a, ulp) - ulp / 2)
    return (dist <= MIDPOINT * a) & (a < qmax(fmt))


def _wire_inputs(rng, fmt, g=3, s=17, h=40):
    """[G, S, H] f32: a per-row dynamic range of e^(3 N(0, 1)); row (0, 5)
    all zero; row (1, 2) a single element; row (2, 3) subnormal; rows 8-10
    of group i with absmax qmax * 2**k_i one ulp below, at, and one ulp
    above (k = -20, 0, 7).  S = 17 is not a multiple of the Pallas 8-row
    tile."""
    x = rng.standard_normal((g, s, h)) * np.exp(
        3.0 * rng.standard_normal((g, s, 1)))
    x[0, 5] = 0.0
    x[1, 2] = 0.0
    x[1, 2, 7] = -3.25
    x[2, 3] = rng.standard_normal(h) * 1e-39
    for i, k in enumerate((-20, 0, 7)):
        edge = np.float32(qmax(fmt) * 2.0 ** k)
        for j, v in enumerate((np.nextafter(edge, np.float32(0)), edge,
                               np.nextafter(edge, np.float32(np.inf)))):
            x[i, 8 + j] = rng.uniform(-0.9, 0.9, h) * edge
            x[i, 8 + j, 2 * j] = v if j % 2 else -v
    return x.astype(np.float32)


# ---------------------------------------------------- quantize, dequantize --

@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_wire_quantize_matches_jax(backend, fmt, x_dtype):
    """Payload bits, scales and the dequantized values bitwise."""
    x = _wire_inputs(np.random.default_rng(0), fmt)
    jx = jnp.asarray(x).astype(x_dtype)
    jq, js = jdispatch.wire_quantize(jx, fmt, backend=backend)
    jdq = jdispatch.wire_dequantize(jq, js, backend=backend)
    tx = _t(jx)
    assert tx.dtype == getattr(torch, x_dtype)
    tq, ts = dispatch.wire_quantize(tx, fmt)
    tdq = dispatch.wire_dequantize(tq, ts)
    assert tq.dtype == (torch.int8 if fmt == "int8" else torch.float8_e4m3fn)
    rows = np.ones(ts.shape, bool)
    if backend == "pallas_interpret" and x_dtype == "float32":
        # The interpreted Pallas body computes absmax / qmax as absmax *
        # (1 / qmax), which may round one ulp above qmax * 2**k down to
        # 2**k (it does for int8); the reference and the port divide
        # (IEEE) and get 2**(k + 1).  Where the product rounds down, the
        # row is held to the product's scale for the interpreter and to
        # the reference's for the port.
        recip = np.float32(1.0) / np.float32(qmax(fmt))
        for i, k in enumerate((-20, 0, 7)):
            above = np.float32(np.abs(x[i, 10]).max())
            if above * recip == np.float32(2.0 ** k):
                rows[i, 10] = False
                assert float(np.asarray(js)[i, 10]) == 2.0 ** k
                assert float(ts[i, 10]) == 2.0 ** (k + 1)
        assert fmt == "fp8" or not rows[:, 10].any()
    np.testing.assert_array_equal(_bits(tq)[rows], _bits(jq)[rows])
    np.testing.assert_array_equal(ts.numpy()[rows], np.asarray(js)[rows])
    np.testing.assert_array_equal(tdq.numpy()[rows], np.asarray(jdq)[rows])
    # empty rows (zero, subnormal): scale 1, zero payload
    for g, s in ((0, 5), (2, 3)):
        assert ts[g, s] == 1.0 and not tdq[g, s].any()
    # the boundary rows: qmax * 2**k gets 2**k, one ulp above 2**(k + 1)
    for i, k in enumerate((-20, 0, 7)):
        if x_dtype == "float32":
            assert ts[i, 8:11].tolist() == [2.0 ** k, 2.0 ** k,
                                             2.0 ** (k + 1)]
    m, _ = np.frexp(ts.numpy())
    assert (m == 0.5).all() and tq.float().abs().max() <= qmax(fmt)


# payload values whose product with a row scale of 2**-124 or 2**-120
# falls below 2**-126: fp8 subnormals (2**-9, 3 * 2**-9, 7 * 2**-9), 0.5
# and 1.0 (at 2**-124 only), beside values that stay normal and signed
# zeros
_SUBNORMAL_PAYLOAD = {
    "fp8": [0.5, 1.0, 448.0, 2.0 ** -9, -2.0 ** -9, 3 * 2.0 ** -9,
            -7 * 2.0 ** -9, 2.0 ** -6, -2.0 ** -7, 0.0, -0.0, -448.0,
            -0.5, 1.5, 2.0 ** -8, -3.0],
    "int8": [1, -1, 127, -127, 0, 3, -3, 64, -64, 2, -2, 5, 7, -100, 100,
             1]}


def _subnormal_rows(fmt, scale):
    """q [2, 3, 16]: the payload above in every row, negated in row 1 of
    group 1; scales [2, 3]: ``scale`` in rows 0 and 1, 1.0 in row 2."""
    vals = np.array(_SUBNORMAL_PAYLOAD[fmt], np.float32)
    q = np.broadcast_to(vals, (2, 3, vals.size)).copy()
    q[1, 1] = -q[1, 1]
    jq = jnp.asarray(q).astype(j_quant_dtype(fmt))
    js = jnp.asarray(np.array([[scale, scale, 1.0]] * 2, np.float32))
    return jq, js


def _int_bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("scale", [2.0 ** -124, 2.0 ** -120])
def test_dequantize_subnormal_rows_match_jax(backend, fmt, scale):
    """Dequantized values below 2**-126 flush to a zero of their sign, as
    the reference's do: wire_dequantize bitwise (signs of zero included),
    and the two fused dequantizing ops, whose weights (1, 1.5, 2) and
    residuals (zero in the first half of the columns) keep everything
    else normal, equal in value (the interpreted Pallas bodies sum one-hot
    products, so a gathered zero may lose its sign there)."""
    jq, js = _subnormal_rows(fmt, scale)
    tq, ts = _t(jq), _t(js)
    want = jdispatch.wire_dequantize(jq, js, backend=backend)
    got = dispatch.wire_dequantize(tq, ts)
    np.testing.assert_array_equal(_int_bits(got.numpy()), _int_bits(want))
    if fmt == "fp8":    # the reference flushes some: the port must too
        assert (np.asarray(want)[:, :2] == 0).sum() > \
            (_bits(jq)[:, :2] & 0x7F == 0).sum()

    # the gather: every (e, c) row, an out-of-range id and position
    E, C, H = jq.shape
    ids = np.array([0, 0, 0, 1, 1, 1, E, 0], np.int32)
    pos = np.array([0, 1, 2, 0, 1, 2, 0, C], np.int32)
    w = np.array([1.0, 1.5, 2.0, 1.0, 1.5, 2.0, 1.0, 1.0], np.float32)
    want = jdispatch.dequantize_combine_gather(
        jnp.asarray(ids), jnp.asarray(pos), jq, js, jnp.asarray(w),
        backend=backend)
    got = dispatch.dequantize_combine_gather(_t(ids), _t(pos), tq, ts, _t(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if backend == "reference":
        np.testing.assert_array_equal(_int_bits(got.numpy()),
                                      _int_bits(want))

    # the residual gather, with and without base
    slots = np.array([[0, 1, 2, 3, 1], [2, 1, 0, -1, 1]], np.int32)
    resid = np.zeros((2, 5, H), np.float32)
    resid[..., H // 2:] = 1.0
    base = np.zeros((2, 3, H), np.float32)
    base[:, 2, :] = 0.25
    for b in (None, base):
        want = jdispatch.dequantize_residual_apply(
            jnp.asarray(slots), jq, js, jnp.asarray(resid),
            None if b is None else jnp.asarray(b), backend=backend)
        got = dispatch.dequantize_residual_apply(
            _t(slots), tq, ts, _t(resid), None if b is None else _t(b))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fmt", FORMATS)
def test_wire_roundtrip_idempotent(fmt):
    """quantize(dequantize(quantize(x))): the same int8 payload and
    scales; for fp8 the same dequantized values (the row max may re-encode
    as (2q, s / 2))."""
    x = torch.from_numpy(_wire_inputs(np.random.default_rng(1), fmt))
    q, s = dispatch.wire_quantize(x, fmt)
    dq = dispatch.wire_dequantize(q, s)
    q2, s2 = dispatch.wire_quantize(dq, fmt)
    assert torch.equal(dispatch.wire_dequantize(q2, s2), dq)
    if fmt == "int8":
        assert torch.equal(q2, q) and torch.equal(s2, s)
        # the rounding error is at most half a quantum
        assert ((dq - x).abs() <= s[..., None] * 0.5).all()


@pytest.mark.parametrize("fmt", FORMATS)
def test_wire_roundtrip_straight_through(fmt):
    """d/dx [dequantize(quantize(x))] is the identity, bit for bit; the
    payload and scales are not differentiable."""
    x = torch.from_numpy(_wire_inputs(np.random.default_rng(2), fmt)) \
        .requires_grad_(True)
    dq, scales = dispatch.wire_roundtrip(x, fmt)
    (g,) = torch.autograd.grad((dq * 2.0).sum(), [x])
    assert torch.equal(g, torch.full(x.shape, 2.0))
    assert not scales.requires_grad
    dq2, q, s = dispatch.wire_encode_roundtrip(x, fmt)
    assert torch.equal(dq2, dq) and not q.requires_grad
    assert not s.requires_grad


def test_po2_scale_exact_boundaries():
    """absmax = qmax * 2**k and one ulp either side, for k over the whole
    exponent range, against the JAX po2_scale; subnormal quotients and
    subnormal absmax as the reference has them."""
    for qm in (127.0, 448.0):
        vals = [0.0, qm, qm * 2.0 ** -20, 1e-20, 500.0, 1e-39, 3e-39,
                qm * 2.0 ** -126, 1.1 * 2.0 ** -126, 2.0 ** -126]
        for k in range(-126, 120, 7):
            edge = np.float32(qm * 2.0 ** k)
            vals += [np.nextafter(edge, np.float32(0)), edge,
                     np.nextafter(edge, np.float32(np.inf))]
        absmax = np.array(vals, np.float32)
        want = np.asarray(j_po2_scale(jnp.asarray(absmax), qm))
        got = ref.po2_scale(torch.from_numpy(absmax), qm).numpy()
        np.testing.assert_array_equal(got, want)
        assert got[0] == 1.0 and got[1] == 1.0
        assert got[2] == 2.0 ** -20 and got[5] == got[6] == 1.0
        if qm == 127.0:
            assert got[4] == 4.0
        m, _ = np.frexp(got)
        assert (m == 0.5).all()


# ------------------------------------------------------- fused codec ops --

def _plan(rng, f=300, e=5, c=16, h=24):
    """A plan from the JAX reference with drops to capacity, ids -1 and
    e + 2, no entry for expert e - 1 (an empty expert) and all-zero tokens
    for the entries of expert 0; [F, H] tokens with a per-row dynamic
    range."""
    ids = rng.integers(0, e - 1, size=f).astype(np.int32)
    ids[[0, 3, 60]] = [-1, e + 2, e + 2]
    pos, keep, _ = jdispatch.positions_in_expert(jnp.asarray(ids), e, c,
                                                 backend="reference")
    flat = np.where(np.asarray(keep), ids, e).astype(np.int32)
    src = (rng.standard_normal((f, h)) * np.exp(
        2.0 * rng.standard_normal((f, 1)))).astype(np.float32)
    src[ids == 0] = 0.0
    return flat, np.asarray(pos), src, e, c, h


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("src_dtype", ["float32", "bfloat16"])
def test_dispatch_scatter_quantize_matches_jax(backend, fmt, src_dtype):
    flat, pos, src, e, c, h = _plan(np.random.default_rng(3))
    jsrc = jnp.asarray(src).astype(src_dtype)
    jq, js = jdispatch.dispatch_scatter_quantize(
        jnp.asarray(flat), jnp.asarray(pos), jsrc, e, c, fmt,
        backend=backend)
    tf, tp, ts_ = _t(flat), _t(pos), _t(jsrc)
    tq, ts = dispatch.dispatch_scatter_quantize(tf, tp, ts_, e, c, fmt)
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # fused == composed
    cq, cs = dispatch.wire_quantize(dispatch.dispatch_scatter(
        tf, tp, ts_, e, c), fmt)
    assert torch.equal(tq.view(torch.uint8), cq.view(torch.uint8))
    assert torch.equal(ts, cs)
    # the all-zero expert 0 and the empty expert e - 1
    for ex in (0, e - 1):
        assert not tq[ex].float().any() and (ts[ex] == 1.0).all()


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("src_dtype", ["float32", "bfloat16"])
def test_dispatch_scatter_quantize_duplicates_match_jax(backend, fmt,
                                                        src_dtype):
    """Many entries per (expert, position), ids and positions out of range
    on both sides, and empty rows (positions C - 2 and C - 1).  The src
    values are multiples of 1/4 below 2, so every row's sum is exact in any
    order and the comparison is bitwise; the CUDA kernel sums a row's
    entries in entry order, as the plain version does."""
    rng = np.random.default_rng(5)
    f, e, c, h = 400, 4, 9, 32
    ids = rng.integers(-1, e + 1, size=f).astype(np.int32)
    pos = rng.integers(-1, c - 2, size=f).astype(np.int32)
    pos[::37] = c + 1
    src = (rng.integers(-8, 8, size=(f, h)) * 0.25).astype(np.float32)
    jsrc = jnp.asarray(src).astype(src_dtype)
    jq, js = jdispatch.dispatch_scatter_quantize(
        jnp.asarray(ids), jnp.asarray(pos), jsrc, e, c, fmt,
        backend=backend)
    tq, ts = dispatch.dispatch_scatter_quantize(
        _t(ids), _t(pos), _t(jsrc), e, c, fmt)
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ts[:, c - 2:] == 1.0).all() and not tq[:, c - 2:].float().any()
    assert not (ts[:, :c - 2] == 1.0).all()


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_dequantize_combine_gather_matches_jax(backend, fmt):
    rng = np.random.default_rng(4)
    flat, pos, _, e, c, h = _plan(rng)
    buf = (rng.standard_normal((e, c, h)) * 20.0).astype(np.float32)
    jq, js = jdispatch.wire_quantize(jnp.asarray(buf), fmt,
                                     backend="reference")
    w = np.abs(rng.standard_normal(flat.shape[0])).astype(np.float32)
    want = jdispatch.dequantize_combine_gather(
        jnp.asarray(flat), jnp.asarray(pos), jq, js, jnp.asarray(w),
        backend=backend)
    tq, ts = _t(jq), _t(js)
    got = dispatch.dequantize_combine_gather(_t(flat), _t(pos), tq, ts,
                                             _t(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    composed = dispatch.combine_gather(_t(flat), _t(pos),
                                       dispatch.wire_dequantize(tq, ts),
                                       _t(w))
    assert torch.equal(got, composed)
    assert not got[torch.from_numpy(flat == e)].any()


def _slot_case(rng, g=3, c=40, s=8, h=24):
    cent = (rng.standard_normal((g, s, h)) * 10.0).astype(np.float32)
    cent[1] = 0.0                                  # an all-zero group
    slots = rng.integers(0, s, size=(g, c)).astype(np.int32)
    slots[0, 3], slots[0, 4], slots[2, 5] = s, s + 5, -1   # out of range
    resid = rng.standard_normal((g, c, h)).astype(np.float32)
    return cent, slots, resid


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("base_on", [True, False])
def test_dequantize_residual_apply_matches_jax(backend, fmt, base_on):
    cent, slots, resid = _slot_case(np.random.default_rng(5))
    jq, js = jdispatch.wire_quantize(jnp.asarray(cent), fmt,
                                     backend="reference")
    base = cent * 0.5 if base_on else None
    want = jdispatch.dequantize_residual_apply(
        jnp.asarray(slots), jq, js, jnp.asarray(resid),
        None if base is None else jnp.asarray(base), backend=backend)
    tq, ts = _t(jq), _t(js)
    tb = None if base is None else _t(base)
    got = dispatch.dequantize_residual_apply(_t(slots), tq, ts, _t(resid),
                                             tb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dq = dispatch.wire_dequantize(tq, ts)
    composed = dispatch.residual_apply(_t(slots),
                                       dq if tb is None else dq - tb,
                                       _t(resid))
    assert torch.equal(got, composed)
    # an out-of-range slot passes the residual through
    for g, c in ((0, 3), (0, 4), (2, 5)):
        assert torch.equal(got[g, c], _t(resid)[g, c])


# ------------------------------------------------------------ transfers --

def _vjp(fn, primals, ct):
    """(value, gradients) of ``fn`` in torch on fresh leaves."""
    leaves = [p.detach().clone().requires_grad_(True) for p in primals]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves, ct)


def _assert_same(a, b):
    (va, ga), (vb, gb) = a, b
    assert torch.equal(va, vb)
    for x, y in zip(ga, gb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _ident(v):
    return v


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_fused_dispatch_combine_transfer_grads(backend, fmt):
    """The coded baseline's two fused legs under identity leaves: values
    and gradients against jax.vjp of the JAX transfers, and fused ==
    composed in the port, bitwise."""
    rng = np.random.default_rng(6)
    flat, pos, src, e, c, h = _plan(rng)
    jcodec = jwire.make_codec(fmt, compute_dtype="float32", backend=backend)
    tcodec = twire.make_codec(fmt, compute_dtype="float32")
    tf, tp = _t(flat), _t(pos)
    ct = rng.standard_normal((1, e, c, h)).astype(np.float32)

    # dispatch leg
    want, vjp = jax.vjp(lambda s: jwire.fused_dispatch_transfer(
        jnp.asarray(flat), jnp.asarray(pos), s, jcodec, _ident, _ident, 1, e,
        c), jnp.asarray(src))
    (jd_src,) = vjp(jnp.asarray(ct))
    fused = _vjp(lambda s: twire.fused_dispatch_transfer(
        tf, tp, s, tcodec, _ident, _ident, 1, e, c), [_t(src)], _t(ct))
    np.testing.assert_array_equal(fused[0].numpy(), np.asarray(want))
    np.testing.assert_array_equal(fused[1][0].numpy(), np.asarray(jd_src))
    _assert_same(fused, _vjp(lambda s: twire.coded_transfer(
        dispatch.dispatch_scatter(tf, tp, s, e, c).reshape(1, e, c, h),
        tcodec, _ident, _ident), [_t(src)], _t(ct)))

    # combine leg
    eo = (rng.standard_normal((1, e, c, h)) * 5.0).astype(np.float32)
    w = np.abs(rng.standard_normal(flat.shape[0])).astype(np.float32)
    ct2 = rng.standard_normal((flat.shape[0], h)).astype(np.float32)
    want, vjp = jax.vjp(lambda x, ww: jwire.fused_combine_transfer(
        x, jnp.asarray(flat), jnp.asarray(pos), ww, jcodec, _ident, _ident,
        1), jnp.asarray(eo), jnp.asarray(w))
    jd_eo, jd_w = vjp(jnp.asarray(ct2))
    fused = _vjp(lambda x, ww: twire.fused_combine_transfer(
        x, tf, tp, ww, tcodec, _ident, _ident, 1), [_t(eo), _t(w)], _t(ct2))
    np.testing.assert_array_equal(fused[0].numpy(), np.asarray(want))
    np.testing.assert_array_equal(fused[1][0].numpy(), np.asarray(jd_eo))
    # d_w sums ct * gathered over H in another order
    mag = (np.abs(ct2) * np.abs(dispatch.dequantize_combine_gather(
        tf, tp, *dispatch.wire_quantize(_t(eo)[0], fmt),
        torch.ones(flat.shape[0])).numpy())).sum(-1)
    assert (np.abs(fused[1][1].numpy() - np.asarray(jd_w))
            <= RTOL * mag).all()
    _assert_same(fused, _vjp(lambda x, ww: dispatch.combine_gather(
        tf, tp, twire.coded_transfer(x, tcodec, _ident, _ident)
        .reshape(e, c, h).to(torch.float32), ww), [_t(eo), _t(w)], _t(ct2)))


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("base_on", [True, False])
def test_fused_lsh_transfer_grads(backend, fmt, base_on):
    """The LSH legs under identity leaves: the precoded dispatch and the
    fused decode + decompress, values and gradients against jax.vjp of the
    JAX transfers (the slot gather's transpose within 1e-6 of the
    magnitude of its terms, one bf16 step after the backward wire's
    rounding), and fused == composed in the port, bitwise."""
    rng = np.random.default_rng(7)
    g, c, s, h = 3, 40, 8, 24
    jcodec = jwire.make_codec(fmt, compute_dtype="float32", backend=backend)
    tcodec = twire.make_codec(fmt, compute_dtype="float32")
    x = (rng.standard_normal((g, s, h)) * 10.0).astype(np.float32)
    tdq, tq, ts = dispatch.wire_encode_roundtrip(_t(x), fmt)
    ct = rng.standard_normal((1, g, s, h)).astype(np.float32)

    jdq, jpay, jsc = jdispatch.wire_encode_roundtrip(jnp.asarray(x), fmt,
                                                     backend=backend)
    want, vjp = jax.vjp(lambda v: jwire.precoded_transfer(
        v, jpay.reshape(1, g, s, h), jsc.reshape(1, g, s), jcodec, _ident,
        _ident), jdq.reshape(1, g, s, h))
    (jdv,) = vjp(jnp.asarray(ct))
    send = tdq.reshape(1, g, s, h)
    pre = _vjp(lambda v: twire.precoded_transfer(
        v, tq.reshape(1, g, s, h), ts.reshape(1, g, s), tcodec, _ident,
        _ident), [send], _t(ct))
    np.testing.assert_array_equal(pre[0].numpy(), np.asarray(want))
    np.testing.assert_array_equal(pre[1][0].numpy(), np.asarray(jdv))
    _assert_same(pre, _vjp(lambda v: twire.coded_transfer(
        v, tcodec, _ident, _ident), [send], _t(ct)))

    eo = (rng.standard_normal((1, g, s, h)) * 5.0).astype(np.float32)
    _, slots, resid = _slot_case(rng, g, c, s, h)
    slots = np.minimum(slots, s - 1).clip(0)     # as compress leaves them
    cot = rng.standard_normal((g, c, h)).astype(np.float32)
    tslots = _t(slots)
    prim = [eo, x, resid] if base_on else [eo, resid]

    def j_fused(*a):
        b = a[1] if base_on else None
        return jwire.fused_decode_residual_transfer(
            a[0], jnp.asarray(slots), b, a[-1], jcodec, _ident, _ident)

    def t_fused(*a):
        b = a[1] if base_on else None
        return twire.fused_decode_residual_transfer(
            a[0], tslots, b, a[-1], tcodec, _ident, _ident)

    def t_composed(*a):
        d = twire.coded_transfer(a[0], tcodec, _ident, _ident) \
            .reshape(g, s, h).to(torch.float32)
        return dispatch.residual_apply(tslots, d - a[1] if base_on else d,
                                       a[-1])

    want, vjp = jax.vjp(j_fused, *[jnp.asarray(p) for p in prim])
    jgrads = vjp(jnp.asarray(cot))
    fused = _vjp(t_fused, [_t(p) for p in prim], _t(cot))
    np.testing.assert_array_equal(fused[0].numpy(), np.asarray(want))
    seg_mag = dispatch.residual_apply_transpose(
        tslots, _t(np.abs(cot)), s).numpy()
    d_eo, want_eo = fused[1][0].numpy(), np.asarray(jgrads[0])
    assert (np.abs(d_eo - want_eo) <= BF16_STEP * np.abs(want_eo)).all()
    print(f"d_eo equal on {(d_eo == want_eo).mean():.4f} of its elements")
    if base_on:
        d_base = fused[1][1].numpy()
        assert (np.abs(d_base - np.asarray(jgrads[1]))
                <= RTOL * seg_mag[0]).all()
    np.testing.assert_array_equal(fused[1][-1].numpy(),
                                  np.asarray(jgrads[-1]))
    _assert_same(fused, _vjp(t_composed, [_t(p) for p in prim], _t(cot)))


# ------------------------------------------------- compress / decompress --

@pytest.mark.parametrize("fmt", ("bf16",) + FORMATS)
def test_identity_exchange_reconstructs_bitwise(fmt):
    """With error compensation on, an identity exchange gives back every
    token bit for bit in every wire format: decompress adds the expert's
    delta to the stored tokens, so the wire representation cancels."""
    gen = torch.Generator().manual_seed(0)
    rot = make_rotations(gen, 4, 64, 32, torch.float32)
    tokens = torch.randn(2, 24, 64, generator=gen)
    comp = tclust.compress(tokens, torch.ones(2, 24, dtype=torch.bool), rot,
                           8, "cross_polytope", True, wire_format=fmt)
    recon = tclust.decompress(comp.centroids.to(torch.float32), comp)
    assert torch.equal(recon, tokens)
    if fmt != "bf16":
        assert comp.payload.shape == (2, 8, 64) and comp.scales.shape == (
            2, 8)
        assert torch.equal(dispatch.wire_dequantize(comp.payload,
                                                    comp.scales),
                           comp.centroids)


# ------------------------------------------------------- the MoE layer --

def _moe_cfgs(fmt, use_lsh):
    jcfg = jbase.MoEConfig(num_experts=6, top_k=2, expert_ffn_dim=32,
                           capacity_factor=2.0, kernel_backend="reference",
                           lsh=jbase.LSHConfig(enabled=use_lsh, num_hashes=3,
                                               rotation_dim=16,
                                               compression_rate=0.5,
                                               wire_format=fmt))
    tcfg = tbase.MoEConfig(**{
        k: v for k, v in dataclasses.asdict(jcfg).items()
        if k not in ("lsh", "comm", "obs")},
        lsh=tbase.LSHConfig(**dataclasses.asdict(jcfg.lsh)))
    return jcfg, tcfg


def _port_layer(params, x, ct, tcfg, mode="train"):
    diff = ("router_w", "w_gate", "w_up", "w_down")
    tp = {k: tensor_from_numpy(v, CPU) for k, v in params.items()}
    for k in diff:
        tp[k].requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, tst = lsh_moe_apply(tp, tx, tcfg, mlp_act="swiglu", mode=mode)
    obj = (ty * torch.from_numpy(ct)).sum() + tst["aux_loss"] \
        + tst["z_loss"]
    grads = torch.autograd.grad(obj, [tx] + [tp[k] for k in diff])
    return ty.detach(), tst, grads


def _layer_inputs(mesh, jcfg):
    h = 16
    params = j_lsh_moe_init(jax.random.PRNGKey(0), h, jcfg, mesh,
                            mlp_act="swiglu", dtype=jnp.float32)
    params["placement"] = jnp.asarray(
        np.random.default_rng(3).permutation(6).astype(np.int32))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, h)).astype(np.float32)
    ct = rng.standard_normal((2, 12, h)).astype(np.float32)
    return {k: np.asarray(v) for k, v in params.items()}, x, ct


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("use_lsh", [True, False])
@pytest.mark.parametrize("fmt", FORMATS)
def test_moe_layer_quantized_wire_matches_jax(mesh, fmt, use_lsh):
    """moe_expert_parallel with an int8 / fp8 wire, LSH on (the fused
    precoded dispatch and decode + decompress) and off (the coded baseline,
    fused scatter-quantize and dequantize-gather): output within 1e-5,
    aux / z losses within 1e-5, equal load, and the gradients of
    sum(y * ct) + aux + z in x, the router and the experts within 1e-4
    relative L2, as the bf16-wire layer is held (test_torch_train.py).
    The expert outputs are quantized from f32 products that the two
    packages sum in another order, so a value within a last bit of a
    rounding midpoint could move by a whole quantum, far above 1e-5; with
    this seed none does (measured: y within 1.5e-6, gradients 2.3e-7)."""
    jcfg, tcfg = _moe_cfgs(fmt, use_lsh)
    params, x, ct = _layer_inputs(mesh, jcfg)
    diff = ("router_w", "w_gate", "w_up", "w_down")

    def j_obj(p, x):
        y, st = j_lsh_moe_apply({**params, **p}, x, jcfg, mesh,
                                mlp_act="swiglu", mode="train")
        return jnp.sum(y * ct) + st["aux_loss"] + st["z_loss"], (y, st)

    with set_mesh(mesh):
        (_, (y, st)), (gp, gx) = jax.jit(jax.value_and_grad(
            j_obj, argnums=(0, 1), has_aux=True))(
                {k: jnp.asarray(params[k]) for k in diff}, jnp.asarray(x))
    ty, tst, grads = _port_layer(params, x, ct, tcfg)
    err = float(np.abs(ty.numpy() - np.asarray(y)).max())
    worst = max(_rel_l2(g.numpy(), w) for g, w in
                zip(grads, [gx] + [gp[k] for k in diff]))
    print(f"{fmt} lsh={use_lsh}: max |y diff| {err:.3g}, worst gradient "
          f"rel L2 {worst:.3g}")
    assert err <= 1e-5 and worst < 1e-4
    for k in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(float(tst[k].detach()), float(st[k]),
                                   atol=1e-5)
    np.testing.assert_array_equal(tst["expert_load"].numpy(),
                                  np.asarray(st["expert_load"]))


@pytest.mark.parametrize("use_lsh", [True, False])
@pytest.mark.parametrize("fmt", FORMATS)
def test_full_layer_fused_flag_is_invisible(mesh, monkeypatch, fmt,
                                            use_lsh):
    """$REPRO_FUSED_WIRE=0 (composed) against 1 (fused) on the port's
    layer: values and gradients bit for bit."""
    jcfg, tcfg = _moe_cfgs(fmt, use_lsh)
    params, x, ct = _layer_inputs(mesh, jcfg)
    runs = []
    for flag in ("1", "0"):
        monkeypatch.setenv(twire.FUSED_ENV, flag)
        assert twire.fused_wire_enabled() == (flag == "1")
        runs.append(_port_layer(params, x, ct, tcfg))
    (y1, _, g1), (y0, _, g0) = runs
    assert torch.equal(y1, y0)
    for a, b in zip(g1, g0):
        assert torch.equal(a, b)


def test_wire_bytes_and_codec_validation():
    """The wire bytes of one leg (the scales included) as the JAX
    accounting has them, and one validation for every entry point."""
    for fmt in (None, "bf16", "int8", "fp8"):
        assert tclust.wire_bytes(40, 208, 1536, fmt) == jclust.wire_bytes(
            40, 208, 1536, fmt)
    assert tclust.wire_bytes(40, 208, 1536, "int8") == 40 * 208 * (1536 + 4)
    for bad in ("int4", "bfloat16"):
        with pytest.raises(ValueError, match="available"):
            twire.make_codec(bad)
        with pytest.raises(ValueError, match="available"):
            tclust.wire_bytes(1, 1, 1, bad)
    # one rank moves nothing; the all-to-all of several is checked on CPU
    # ranks (test_torch_collectives.py), and so is the 2-hop transport of
    # a model axis that factors into nodes (test_torch_transports.py):
    # its plan moves each leaf over an intra-node hop, then an inter-node
    # one
    fwd, bwd = twire.flat_leaves(None)
    leaf = torch.ones(2, 3)
    assert fwd(leaf) is leaf and bwd(leaf) is leaf
    plan = tplanner.plan_collectives(
        Mesh((1, 4)), tbase.CommConfig(a2a_impl="hierarchical",
                                       node_size=2))
    assert (plan.transport, plan.intra) == ("hierarchical", 2)
    assert [h.hop for h in plan.wire_cost(40 * 208 * 1540)] == \
        ["intra", "inter"]
    codec = twire.make_codec("int8", wire_dtype=torch.bfloat16,
                             compute_dtype=torch.float32)
    assert codec.quantized and codec.grad_dtype == torch.bfloat16
    assert codec.compute_dtype == "float32"
    assert twire.make_codec("bf16", wire_dtype="float32").grad_dtype \
        == torch.float32
