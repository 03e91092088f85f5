"""The port's CUDA kernels against their plain versions on an H100.

These tests need a card with compute capability 9.0 (the kernels are built
for sm_90a) and skip elsewhere with the reason.  The file imports neither
JAX nor the JAX package, so it also runs on a machine without them:

  PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Integer outputs and unique-plan scatter / gather outputs must agree bit for
bit; a scatter with duplicate (expert, position) pairs sums in another
order (the plain version's index_add_ uses atomics on the card), so each
element is held to 1e-6 times the sum of the magnitudes of its terms.  The
wire kernels (payload bits, scales, dequantized values, the fused ops) are
held bitwise to their plain versions, and each fused kernel bitwise to the
unfused kernels it replaces on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # parallel test workers share the cores

from repro_torch.kernels import (dispatch, fused_wire, lsh_hash, ref,
                                 residual_apply, scatter_gather,
                                 segment_centroid, token_position,
                                 wire_quant)

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
@pytest.mark.parametrize("f,e", [
    (32, 40), (300, 5), (5000, 40), (3000, 1),
    # the training shape; F not a multiple of the 256-entry tile; E = 1
    # and 128 (the configs' largest); many tiles a block; the largest E
    # (shared memory past 48 KB)
    (32768, 40), (40963, 40), (40963, 1), (40963, 128), (2 ** 20 + 3, 40),
    (5000, token_position.MAX_EXPERTS)])
@pytest.mark.parametrize("dist", ["uniform", "one expert"])
def test_cuda_positions_in_expert_bitwise(h100, f, e, dist):
    """Ids -1 and e + 2 among them; "one expert": every in-range id is
    e - 1.  One launch a call, the same bits twice."""
    ids = _ids(np.random.default_rng(7), f, e)
    if dist == "one expert":
        ids = torch.where((ids >= 0) & (ids < e), e - 1, ids)
    before = token_position.KERNEL.launches
    pos, counts = token_position.positions_in_expert(ids.to(h100), e)
    assert token_position.KERNEL.launches == before + 1
    rpos, rcounts = ref.positions_in_expert_ref(ids, e)
    assert torch.equal(pos.cpu(), rpos) and torch.equal(counts.cpu(), rcounts)
    pos2, counts2 = token_position.positions_in_expert(ids.to(h100), e)
    assert token_position.KERNEL.launches == before + 2
    assert torch.equal(pos2, pos) and torch.equal(counts2, counts)


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


def _gather_case(rng, f, h, device, e=5, c=7, offset=False):
    """ids in [-2, e + 2) and positions in [-1, c + 1) (entry 0 on the
    buffer's last row), signed weights; with ``offset`` the buffer is a
    view one float past an aligned allocation."""
    ids = rng.integers(-2, e + 2, size=f).astype(np.int32)
    pos = rng.integers(-1, c + 1, size=f).astype(np.int32)
    ids[0], pos[0] = e - 1, c - 1
    flat = rng.standard_normal(e * c * h + 1).astype(np.float32)
    w = rng.standard_normal(f).astype(np.float32)
    ids, pos, w = (torch.from_numpy(a).to(device) for a in (ids, pos, w))
    flat = torch.from_numpy(flat).to(device)
    buf = (flat[1:] if offset else flat[:-1]).view(e, c, h)
    return ids, pos, buf, w


def _check_gather(ids, pos, buf, w):
    """The kernel against the plain version on the same inputs: the same
    values, dropped entries exactly +0.0, one launch a call.  Returns the
    number of dropped entries."""
    e, c, _ = buf.shape
    before = scatter_gather.GATHER.launches
    out = scatter_gather.combine_gather(ids, pos, buf, w)
    assert scatter_gather.GATHER.launches == before + 1
    want = ref.combine_gather_ref(ids.cpu(), pos.cpu(), buf.cpu(), w.cpu())
    assert torch.equal(out.cpu(), want)
    dropped = ((ids < 0) | (ids >= e) | (pos < 0) | (pos >= c)).cpu()
    assert (out.cpu()[dropped].view(torch.int32) == 0).all()
    return int(dropped.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("h", [30, 1536, 8192])
@pytest.mark.parametrize("f", [1, 8, 32, 33, 4097])
def test_cuda_combine_gather_bitwise(h100, f, h, offset):
    """Each shape class of the gather's launcher: few entries, whose rows
    it splits over warps (f = 1 to 33, as at decode), and many; h = 30 and
    a buffer one float off its alignment take the one-column-a-lane
    kernel.  Every case but the single in-range entry drops some."""
    dropped = _check_gather(*_gather_case(np.random.default_rng(f * 7 + h),
                                          f, h, h100, offset=offset))
    assert dropped > 0 or f == 1


@pytest.mark.cuda
def test_cuda_combine_gather_plan_switch(h100):
    """The launcher splits rows only while the entries cannot fill the
    resident warps: two chunks a row at F = warps - 1, one at F = warps,
    one float4 a lane at jamba's decode shape; each side bitwise."""
    warps = scatter_gather.gather_plan(1, 1536)["resident_warps"]
    for f, split in ((warps - 1, 2), (warps, 1)):
        plan = scatter_gather.gather_plan(f, 1536)
        assert plan["split"] == split and plan["chunk"] % 32 == 0
        assert plan["split"] * plan["chunk"] >= 384
        _check_gather(*_gather_case(np.random.default_rng(f), f, 1536,
                                    h100))
    plan = scatter_gather.gather_plan(8, 8192)
    assert (plan["split"], plan["chunk"], plan["grid"]) == (64, 32, 128)


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


# ------------------------------------------------- the LSH kernels (PR 12) --

NEAR_TIE = 1e-5


def _lsh_inputs(rng, g=3, c=200, s=24, h=36, dtype=torch.bfloat16):
    """A ragged shape (C = 200; H = 34 takes the kernels' one-column
    paths), with slot ids in the overflow bin and beyond it."""
    slots = rng.integers(0, s, size=(g, c)).astype(np.int32)
    slots[0, :7] = s
    slots[-1, 3] = s + 5
    x = torch.from_numpy(rng.standard_normal((g, c, h)).astype(np.float32))
    return torch.from_numpy(slots), x.to(dtype), s


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dtype,rot_dtype", [
    (torch.bfloat16, torch.bfloat16),       # the tensor-core kernel
    (torch.bfloat16, torch.float32), (torch.float32, torch.float32)])
@pytest.mark.parametrize("t,h,l,dr", [
    (300, 48, 6, 16), (4100, 1536, 6, 64), (70, 36, 6, 12),
    # T not a multiple of the 128-row tile, H not of the 64-deep k slice,
    # L * Dr not of the 192-column tile
    (4100, 40, 5, 16), (4100, 1096, 1, 8), (4100, 1096, 3, 16)])
def test_cuda_lsh_hash_near_tie_rule(h100, ties, dtype, rot_dtype, t, h, l,
                                     dr):
    """Equal to the plain version wherever the two largest |v| differ by
    more than NEAR_TIE; rows 0-2 all zero give vertex 0.  With ``ties``,
    columns 1, Dr / 2 and Dr - 1 of each rotation are one large column:
    wherever it holds the maximum, the three are tied exactly and the
    first, index 1 with its sign, must win on the card too."""
    rng = np.random.default_rng(20)
    x = torch.from_numpy(rng.standard_normal((t, h)).astype(np.float32))
    x[:3] = 0.0
    x = x.to(dtype)
    r = rng.standard_normal((l, h, dr)) / np.sqrt(h)
    if ties:
        r[:, :, 1] *= 30.0
        r[:, :, dr // 2] = r[:, :, 1]
        r[:, :, dr - 1] = r[:, :, 1]
    rot = torch.from_numpy(r.astype(np.float32)).to(rot_dtype)
    torch.backends.cuda.matmul.allow_tf32 = False
    before = lsh_hash.KERNEL.launches
    got = lsh_hash.lsh_hash(x.to(h100), rot.to(h100))
    again = lsh_hash.lsh_hash(x.to(h100), rot.to(h100))
    assert lsh_hash.KERNEL.launches == before + 2
    assert torch.equal(got, again)
    want = ref.lsh_hash_ref(x, rot)
    ok = lsh_hash.near_tie_margin(x, rot) > NEAR_TIE
    assert torch.equal(got.cpu()[ok], want[ok])
    assert (got.cpu()[:3] == 0).all()
    if ties:
        tied = (want // 2) == 1
        assert int(tied.sum()) > t * l // 2
        assert torch.equal(got.cpu()[tied], want[tied])
        assert set((want[tied] % 2).unique().tolist()) == {0, 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h", [36, 34])
def test_cuda_segment_centroid_and_residual_apply(h100, dtype, h):
    """Counts exact; centroids within 1e-6 of the mean magnitude (an f32
    sum in another order); residual_apply bitwise; both deterministic."""
    slots, x, s = _lsh_inputs(np.random.default_rng(21), h=h, dtype=dtype)
    cent, counts = segment_centroid.segment_centroid(slots.to(h100),
                                                     x.to(h100), s)
    cent2, _ = segment_centroid.segment_centroid(slots.to(h100), x.to(h100),
                                                 s)
    assert torch.equal(cent, cent2)
    rc, rn = ref.segment_centroid_ref(slots, x, s)
    mag, _ = ref.segment_centroid_ref(slots, x.float().abs(), s)
    assert torch.equal(counts.cpu(), rn)
    assert ((cent.cpu() - rc).abs() <= 1e-6 * mag).all()
    resid = torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
    for r in (resid, None):
        got = residual_apply.residual_apply(
            slots.to(h100), rc.to(h100), None if r is None else r.to(h100))
        assert torch.equal(got.cpu(), ref.residual_apply_ref(slots, rc, r))


@pytest.mark.cuda
@pytest.mark.parametrize("dist", ["one slot", "clamped", "many empty"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h", [40, 36, 34])
def test_cuda_segment_centroid_skewed(h100, dist, dtype, h):
    """Skewed slot sets: all rows of every group in one slot; the clamped
    overflow of residual_apply's backward (unoccupied rows in S - 1: a
    cold group, one 80% occupied, one full); many empty slots (S = 600,
    the rows in 5 of them, some out of range on both sides).  C = 1000 is
    not a multiple of the kernel's 64-row item or 8-row piece, and a slot
    of 1000 rows spans 16 items summed by the combine pass.  H = 40 takes
    the 16-byte loads, H = 36 those of f32 and bf16's one-column path,
    H = 34 the one-column path.
    Counts exact, sums within 1e-6 of the magnitude of their terms, the
    same bits on a second call."""
    rng = np.random.default_rng(22)
    g, c, s = 3, 1000, 24
    if dist == "one slot":
        slots = np.full((g, c), s - 1)
    elif dist == "clamped":
        occupied = np.arange(c)[None] < np.array([0, 800, c])[:, None]
        slots = np.minimum(
            np.where(occupied, rng.integers(0, s, size=(g, c)), s), s - 1)
    else:
        s = 600
        slots = rng.choice([0, 7, 300, 301, s - 1], size=(g, c))
        slots[0, :50], slots[1, :50] = -1, s
    slots = torch.from_numpy(slots.astype(np.int32))
    x = torch.from_numpy(rng.standard_normal((g, c, h)).astype(np.float32)
                         ).to(dtype)
    before = segment_centroid.KERNEL.launches
    cent, counts = segment_centroid.segment_centroid(slots.to(h100),
                                                     x.to(h100), s)
    assert segment_centroid.KERNEL.launches == before + 1
    cent2, counts2 = segment_centroid.segment_centroid(slots.to(h100),
                                                       x.to(h100), s)
    assert torch.equal(cent, cent2) and torch.equal(counts, counts2)
    rc, rn = ref.segment_centroid_ref(slots, x, s)
    mag, _ = ref.segment_centroid_ref(slots, x.float().abs(), s)
    assert torch.equal(counts.cpu(), rn)
    assert ((cent.cpu() - rc).abs() <= 1e-6 * mag).all()


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["segment_centroid", "residual_apply",
                                "dispatch_scatter", "combine_gather"])
def test_cuda_backward_matches_plain(h100, op):
    """Each autograd.Function backward with the kernels against the same
    Function on the CPU (the plain versions), on the same cotangent."""

    def run(dev):
        gen = torch.Generator().manual_seed(5)
        if op in ("segment_centroid", "residual_apply"):
            slots, x, s = _lsh_inputs(np.random.default_rng(23),
                                      dtype=torch.float32)
            if op == "segment_centroid":
                leaf = x.to(dev).requires_grad_(True)
                out = dispatch.segment_centroid(slots.to(dev), leaf, s)[0]
                leaves = [leaf]
            else:
                e = torch.randn(3, s, 36, generator=gen).to(dev) \
                    .requires_grad_(True)
                r = x.to(dev).requires_grad_(True)
                out = dispatch.residual_apply(slots.to(dev), e, r)
                leaves = [e, r]
        else:
            flat, pos, src, w, e, c = _plan(np.random.default_rng(24))
            if op == "dispatch_scatter":
                leaf = src.to(torch.bfloat16).to(dev).requires_grad_(True)
                out = dispatch.dispatch_scatter(flat.to(dev), pos.to(dev),
                                                leaf, e, c)
                leaves = [leaf]
            else:
                buf = torch.randn(e, c, src.shape[1], generator=gen) \
                    .to(dev).requires_grad_(True)
                wl = w.to(dev).requires_grad_(True)
                out = dispatch.combine_gather(flat.to(dev), pos.to(dev), buf,
                                              wl)
                leaves = [buf, wl]
        ct = torch.randn(out.shape, generator=gen).to(dev)
        return [g.cpu() for g in torch.autograd.grad(out, leaves, ct)]

    for got, want in zip(run(h100), run(torch.device("cpu"))):
        assert got.dtype == want.dtype
        assert ((got.float() - want.float()).abs()
                <= 1e-6 * (1 + want.float().abs())).all()


# ------------------------------------------------------ the wire kernels --

def _bits(q):
    return q.view(torch.uint8) if q.dtype == torch.float8_e4m3fn else q


def _wire_rows(rng, fmt, g=3, s=17, h=48):
    """A per-row dynamic range, an all-zero row, a subnormal row, and rows
    whose absmax is qmax * 2**k one ulp below, at and one ulp above."""
    x = rng.standard_normal((g, s, h)) * np.exp(
        3.0 * rng.standard_normal((g, s, 1)))
    x[0, 5] = 0.0
    x[2, 3] = rng.standard_normal(h) * 1e-39
    qm = wire_quant.qmax(fmt)
    for i, k in enumerate((-20, 0, 7)):
        edge = np.float32(qm * 2.0 ** k)
        for j, v in enumerate((np.nextafter(edge, np.float32(0)), edge,
                               np.nextafter(edge, np.float32(np.inf)))):
            x[i, 8 + j] = rng.uniform(-0.9, 0.9, h) * edge
            x[i, 8 + j, j] = v
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,s,h", [
    (3, 17, 48), (3, 17, 40), (3, 17, 36), (3, 17, 34), (40, 208, 1536)])
def test_cuda_wire_quantize_dequantize_bitwise(h100, fmt, dtype, g, s, h):
    """The quantize: h = 48 and 1536 take the 16-wide path, the others the
    one-column one.  The dequantize: every h but 34 the 4-wide path (36
    and 40 not the old 16-wide one), 34 the one-column path; G * S = 8320
    rows at the training shape."""
    x = _wire_rows(np.random.default_rng(30), fmt, g=g, s=s, h=h).to(dtype)
    before = (wire_quant.QUANTIZE.launches, wire_quant.DEQUANTIZE.launches)
    q, s = wire_quant.wire_quantize(x.to(h100), fmt)
    dq = wire_quant.wire_dequantize(q, s)
    assert (wire_quant.QUANTIZE.launches,
            wire_quant.DEQUANTIZE.launches) == (before[0] + 1, before[1] + 1)
    rq, rs = ref.wire_quantize_ref(x, fmt)
    assert torch.equal(_bits(q).cpu(), _bits(rq))
    assert torch.equal(s.cpu(), rs)
    assert torch.equal(dq.cpu(), ref.wire_dequantize_ref(rq, rs))
    q2, s2 = wire_quant.wire_quantize(x.to(h100), fmt)
    assert torch.equal(_bits(q2), _bits(q)) and torch.equal(s2, s)


def _subnormal_rows(fmt, scale, h):
    """q [2, 3, h]: payload values whose product with ``scale`` (2**-124
    or 2**-120) falls below 2**-126 (fp8 subnormals, 0.5, 1.0) beside
    normal ones and signed zeros, row 1 of group 1 negated; scales
    ``scale`` in rows 0 and 1 and 1.0 in row 2."""
    vals = torch.tensor(
        [0.5, 1.0, 448.0, 2.0 ** -9, -2.0 ** -9, 3 * 2.0 ** -9,
         -7 * 2.0 ** -9, 2.0 ** -6, -2.0 ** -7, 0.0, -0.0, -448.0]
        if fmt == "fp8" else [1, -1, 127, -127, 0, 3, -3, 64, -64, 2, -2, 5])
    v = vals.repeat(-(-h // vals.numel()))[:h]
    q = v.expand(2, 3, h).clone()
    q[1, 1] = -q[1, 1]
    q = q.to(wire_quant.quant_dtype(fmt))
    return q, torch.tensor([[scale, scale, 1.0]] * 2)


def _f32_bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("scale", [2.0 ** -124, 2.0 ** -120])
@pytest.mark.parametrize("h", [1536, 36, 34])
def test_cuda_dequantize_subnormal_rows_bitwise(h100, fmt, scale, h):
    """Dequantized values below 2**-126 flush to a zero of their sign in
    wire_dequantize and both fused dequantizing kernels, bitwise (signs of
    zero included) their plain versions and fused == composed on the card;
    in-range entries and slots only, weights 1, 1.5 and 2."""
    q, s = _subnormal_rows(fmt, scale, h)
    dq_, ds_ = q.to(h100), s.to(h100)
    dq = wire_quant.wire_dequantize(dq_, ds_)
    want = ref.wire_dequantize_ref(q, s)
    assert torch.equal(_f32_bits(dq).cpu(), _f32_bits(want))
    if fmt == "fp8":
        assert int((want[:, :2] == 0).sum()) > int((q[:, :2].float() == 0)
                                                   .sum())

    ids = torch.tensor([0, 0, 0, 1, 1, 1, 1, 0], dtype=torch.int32)
    pos = torch.tensor([0, 1, 2, 0, 1, 2, 1, 1], dtype=torch.int32)
    w = torch.tensor([1.0, 1.5, 2.0, 1.0, 1.5, 2.0, 1.0, 1.0])
    d = [t.to(h100) for t in (ids, pos, w)]
    out = fused_wire.dequantize_combine_gather(d[0], d[1], dq_, ds_, d[2])
    assert torch.equal(_f32_bits(out).cpu(), _f32_bits(
        ref.dequantize_combine_gather_ref(ids, pos, q, s, w)))
    assert torch.equal(_f32_bits(out), _f32_bits(
        scatter_gather.combine_gather(d[0], d[1], dq, d[2])))

    slots = torch.tensor([[0, 1, 2, 1, 0], [2, 1, 0, 1, 1]],
                         dtype=torch.int32)
    resid = torch.zeros(2, 5, h)
    resid[..., h // 2:] = 1.0
    base = torch.zeros(2, 3, h)
    base[:, 2] = 0.25
    for b in (None, base):
        db = None if b is None else b.to(h100)
        got = fused_wire.dequantize_residual_apply(
            slots.to(h100), dq_, ds_, resid.to(h100), db)
        assert torch.equal(_f32_bits(got).cpu(), _f32_bits(
            ref.dequantize_residual_apply_ref(slots, q, s, resid, b)))
        assert torch.equal(_f32_bits(got), _f32_bits(
            residual_apply.residual_apply(
                slots.to(h100), dq if db is None else dq - db,
                resid.to(h100))))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("src_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,e,c", [
    (32, 5, 16), (30, 5, 16), (36, 5, 16),
    # E * C = 321 rows, not a multiple of a block's 8, some of them empty;
    # H = 1000 the one-column path past its 512 cached columns, H = 2064
    # the 16-wide path past its 2048; the dequantize-gather's 4-wide path
    # at H = 36 (9 words, fewer than a warp's lanes), 1000 and 2064 (past
    # its 12 words a lane), its one-column path at H = 30 and 1002
    (1000, 3, 107), (2064, 3, 107), (1002, 3, 107)])
def test_cuda_fused_wire_ops_bitwise(h100, fmt, src_dtype, h, e, c):
    """The three fused kernels against their plain versions and against
    the unfused kernels they replace, on a plan with out-of-range ids and
    empty rows; the dequantize-gather also with raw ids and positions out
    of range on both sides; the scatter-quantize also with a few duplicate
    (expert, position) entries and with many, against the plain version
    on the CPU and the unfused kernels on the card (all three sum in entry
    order)."""
    rng = np.random.default_rng(31)
    flat, pos, src, w, e, c = _plan(rng, e=e, c=c, h=h)
    src = src.to(src_dtype)
    d = [t.to(h100) for t in (flat, pos, src, w)]
    before = fused_wire.SCATTER_QUANTIZE.launches
    q, s = fused_wire.dispatch_scatter_quantize(d[0], d[1], d[2], e, c, fmt)
    assert fused_wire.SCATTER_QUANTIZE.launches == before + 1
    rq, rs = ref.dispatch_scatter_quantize_ref(flat, pos, src, e, c, fmt)
    assert torch.equal(_bits(q).cpu(), _bits(rq)) and torch.equal(s.cpu(), rs)
    # empty rows: scale 1 and a zero payload
    filled = torch.zeros(e * c, dtype=torch.bool)
    filled[(flat.long() * c + pos.long())[flat < e]] = True
    assert bool((s.cpu().reshape(-1)[~filled] == 1).all())
    assert bool((_bits(q).cpu().reshape(e * c, h)[~filled] == 0).all())
    cq, cs = wire_quant.wire_quantize(
        scatter_gather.dispatch_scatter(d[0], d[1], d[2], e, c), fmt)
    assert torch.equal(_bits(q), _bits(cq)) and torch.equal(s, cs)

    out = fused_wire.dequantize_combine_gather(d[0], d[1], q, s, d[3])
    assert torch.equal(out.cpu(), ref.dequantize_combine_gather_ref(
        flat, pos, rq, rs, w))
    assert torch.equal(out, scatter_gather.combine_gather(
        d[0], d[1], wire_quant.wire_dequantize(q, s), d[3]))
    bad_ids, bad_pos = flat.clone(), pos.clone()
    bad_ids[::7], bad_ids[3::11] = -1, e + 3
    bad_pos[1::13], bad_pos[2::17] = -1, c + 2
    bad = [t.to(h100) for t in (bad_ids, bad_pos)]
    out = fused_wire.dequantize_combine_gather(bad[0], bad[1], q, s, d[3])
    assert torch.equal(out.cpu(), ref.dequantize_combine_gather_ref(
        bad_ids, bad_pos, rq, rs, w))
    assert torch.equal(out, scatter_gather.combine_gather(
        bad[0], bad[1], wire_quant.wire_dequantize(q, s), d[3]))
    dropped = ((bad_ids < 0) | (bad_ids >= e) | (bad_pos < 0)
               | (bad_pos >= c))
    assert bool((out.cpu()[dropped] == 0).all())

    slots, x, n_slots = _lsh_inputs(rng, h=h, dtype=torch.float32)
    eq, es = ref.wire_quantize_ref(torch.randn(3, n_slots, h) * 10, fmt)
    resid = torch.randn(x.shape)
    for base in (torch.randn(3, n_slots, h), None):
        dv = [t.to(h100) for t in (slots, eq, es, resid)]
        b = None if base is None else base.to(h100)
        got = fused_wire.dequantize_residual_apply(*dv, b)
        assert torch.equal(got.cpu(), ref.dequantize_residual_apply_ref(
            slots, eq, es, resid, base))
        dq = wire_quant.wire_dequantize(dv[1], dv[2])
        assert torch.equal(got, residual_apply.residual_apply(
            dv[0], dq if b is None else dq - b, dv[3]))

    # a few duplicates in the plan: entries 50, 120 and 299 land where the
    # kept entry 7 does; then many: 3000 entries into 4 x 8 rows, with ids
    # and positions out of range on both sides
    few_ids, few_pos = flat.clone(), pos.clone()
    k = int(torch.nonzero(flat < e)[0, 0])
    few_ids[[50, 120, 299]], few_pos[[50, 120, 299]] = flat[k], pos[k]
    many_ids = torch.from_numpy(rng.integers(-1, 5, size=3000)
                                .astype(np.int32))
    many_pos = torch.from_numpy(rng.integers(-1, 9, size=3000)
                                .astype(np.int32))
    for ids, dpos, dsrc, ne, nc in (
            (few_ids, few_pos, src, e, c),
            (many_ids, many_pos, torch.randn(3000, h).to(src_dtype), 4, 8)):
        dd = [t.to(h100) for t in (ids, dpos, dsrc)]
        q, s = fused_wire.dispatch_scatter_quantize(*dd, ne, nc, fmt)
        rq, rs = ref.dispatch_scatter_quantize_ref(ids, dpos, dsrc, ne, nc,
                                                   fmt)
        assert torch.equal(_bits(q).cpu(), _bits(rq))
        assert torch.equal(s.cpu(), rs)
        cq, cs = wire_quant.wire_quantize(
            scatter_gather.dispatch_scatter(*dd, ne, nc), fmt)
        assert torch.equal(_bits(q), _bits(cq)) and torch.equal(s, cs)
        q2, s2 = fused_wire.dispatch_scatter_quantize(*dd, ne, nc, fmt)
        assert torch.equal(_bits(q2), _bits(q)) and torch.equal(s2, s)


@pytest.mark.cuda
def test_cuda_checkpoint_manager_round_trip_bitwise(h100, tmp_path):
    """The smoke config's training state on the card, after one step (int8
    moments), through CheckpointManager and back onto the card: every leaf
    bit for bit, on the leaf's device (the step counter on the host)."""
    from repro_torch.checkpoint.checkpoint import (CheckpointManager,
                                                   _flatten, load_checkpoint)
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.runtime.step import (batch_to_device, init_train_state,
                                          make_train_step)
    cfg = get_smoke_config("granite-moe-3b-a800m")
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=4,
                          moment_dtype="int8")
    state = init_train_state(cfg, opt, seed=0, device=h100)
    state, _ = make_train_step(cfg, opt)(state, batch_to_device(
        SyntheticLMDataset(cfg.vocab_size, 32, 2).batch_at(0), h100))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, state)
    mgr.wait()
    fresh = init_train_state(cfg, opt, seed=1, device=h100)
    got, step, _ = load_checkpoint(str(tmp_path), fresh)
    assert step == 1
    want = {k: v for k, v in _flatten(state)}
    for k, v in _flatten(got):
        w = want.pop(k)
        assert v.device == w.device and v.dtype == w.dtype, k
        if v.dtype == torch.bfloat16:
            v, w = v.view(torch.int16), w.view(torch.int16)
        assert torch.equal(v, w), k
    assert not want
