"""The launch plans of the port's quantize (K2) and dequantize (K3)
kernels, and a numpy model of K2's and K3's arithmetic as the CUDA
kernels of ``csrc/quant.cu`` do it, held against the JAX package's numpy
oracle ``repro.kernels.quant.ref.quantize_ef_reference``, on the CPU.

The kernels themselves run only on the card (``chip_smoke.py`` phase Q
holds them bit for bit against the plain version there). What is held
here is what surrounds them: the grid, the shares, the branch (z kept on
chip or read again), the head and tail of every pointer, and the kernel's
order of work: each block's partial keys, their fold in any order, and
the channel each thread steps to without a modulo per element.

Every input is drawn from numpy with a fixed seed. Tolerances: none; the
model computes in f32, one rounding per operation, as the kernels do, and
must equal the oracle bit for bit, up to the sign of a zero: the
oracle's ``lo`` and ``hi`` take it from the order of its reduction, and
without a residual it adds zeros (-0 + 0 = +0) where the kernels take x.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.quant.ref import quantize_ef_reference as np_ref  # noqa: E402
from repro_torch.kernels.quant import ops  # noqa: E402

# [rows, C] of every MobileNetV2-CIFAR stage boundary at batch 64
BOUNDARIES = [(65536, 32), (65536, 24), (65536, 16), (16384, 32),
              (4096, 96), (4096, 64), (1024, 320), (1024, 160)]


def _view(n, dtype, phase):
    """A contiguous CPU tensor of ``n`` elements starting ``phase`` bytes
    past a 16-byte boundary."""
    size = torch.tensor([], dtype=dtype).element_size()
    buf = torch.empty(n * size + 64, dtype=torch.uint8)
    skip = (-buf.data_ptr()) % 16 + phase
    return buf[skip:skip + n * size].view(dtype)


# ------------------------------ the plans --------------------------------

@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("rows,C", BOUNDARIES)
def test_quantize_plan_at_every_boundary(rows, C, with_res):
    x = _view(rows * C, torch.float32, 0).view(rows, C)
    res = _view(rows * C, torch.float32, 0).view(rows, C) if with_res \
        else None
    plan = ops.quantize_plan(x, res, with_z=with_res)
    n, J = rows * C, C // math.gcd(C, 4)
    periods = -(-(n // 4) // J)
    assert plan.period_units == J and plan.units == n // 4
    assert (plan.head, plan.tail, plan.out_phase) == (0, 0, 0)
    # every block resident (one an SM), every period taken, no idle block
    assert 1 <= plan.grid <= ops.SMS
    assert plan.grid * plan.per_block >= periods
    assert (plan.grid - 1) * plan.per_block < periods
    assert plan.grid * C <= ops.FOLD_MAX
    # z fits on chip at every boundary: x and res are read once
    assert plan.z_on_chip and plan.keys_on_chip
    assert plan.smem == -(-8 * C // 16) * 16 + plan.per_block * J * 16
    assert plan.smem <= ops.SMEM_MAX
    want = {"x": (0, 0, 16), "q": (0, 0, 4), "res_out": (0, 0, 16)}
    if with_res:
        want.update(res=(0, 0, 16), z_out=(0, 0, 16))
    assert plan.pointers == want


def test_quantize_plan_top_shape_fills_the_card():
    x = _view(65536 * 32, torch.float32, 0).view(65536, 32)
    plan = ops.quantize_plan(x, x)
    # 65,536 periods of 8 units over 132 blocks: 497 periods (62 KB of
    # z) each
    assert (plan.grid, plan.per_block, plan.smem) == (132, 497,
                                                      256 + 497 * 8 * 16)


def test_quantize_plan_rereads_where_z_does_not_fit():
    rows, C = 1_048_576, 32
    x = _view(rows * C, torch.float32, 0).view(rows, C)
    plan = ops.quantize_plan(x, x)
    assert plan.grid == ops.SMS and not plan.z_on_chip
    assert plan.smem == 8 * C                 # the keys alone
    assert plan.grid * plan.per_block * 8 >= rows * C // 4


@pytest.mark.parametrize("rows,C,x_phase,res_phase", [
    (512, 7, 0, 0), (300, 33, 1, 1), (1000, 1, 2, 0), (5, 3, 3, 1),
    (1, 1, 1, None), (2, 1, 3, None), (4096, 20000, 0, 0)])
def test_quantize_plan_heads_and_tails(rows, C, x_phase, res_phase):
    n = rows * C
    x = _view(n, torch.float32, 4 * x_phase).view(rows, C)
    res = None if res_phase is None else _view(
        n, torch.float32, 4 * res_phase).view(rows, C)
    plan = ops.quantize_plan(x, res, with_z=True)
    head = min((4 - x_phase) % 4, n)
    assert plan.head == head and plan.out_phase == x_phase
    assert plan.units == (n - head) // 4 and plan.tail == (n - head) % 4
    assert head + 4 * plan.units + plan.tail == n
    assert plan.pointers["x"] == (head, plan.tail, 16)
    assert plan.pointers["q"] == (head, plan.tail, 4)
    if res is not None:
        width = 16 if res_phase == x_phase else 4
        assert plan.pointers["res"] == (head, plan.tail, width)
        assert plan.pointers["z_out"] == (head, plan.tail, 16)
    # a unit of x and the outputs' units start on a 16-byte boundary
    assert (x.data_ptr() + 4 * head) % 16 == 0 or plan.units == 0
    assert (x_phase + head) % 4 == 0 or plan.units == 0
    if C > ops.KEYS_MAX:                      # keys in device memory
        assert not plan.keys_on_chip and plan.grid == 1
    else:
        assert plan.keys_on_chip and plan.grid * C <= ops.FOLD_MAX
    assert plan.smem <= ops.SMEM_MAX


def _code_view(C, rows):
    """The code view ``StageExecutor._device_triple`` hands K3: byte
    offset 8C of one buffer ``lo | scale | codes``."""
    buf = _view(8 * C + rows * C, torch.uint8, 0)
    return buf[8 * C:].view(rows, C)


@pytest.mark.parametrize("rows,C", BOUNDARIES + [(64, 7), (64, 33),
                                                 (1000, 1), (3, 5)])
def test_dequantize_plan_on_the_code_view(rows, C):
    q = _code_view(C, rows)
    plan = ops.dequantize_plan(q)
    n = rows * C
    head = min(8 if C % 2 else 0, n)          # 8C is 16-aligned iff C even
    assert plan.head == head
    assert plan.units == (n - head) // 16 and plan.tail == (n - head) % 16
    assert plan.pointers == {"q": (head, plan.tail, 16),
                             "out": (head, plan.tail, 16)}
    assert (plan.out_phase + head) % 4 == 0 and plan.out_phase < 4
    J = C // math.gcd(C, 16)
    periods = -(-plan.units // J)
    assert plan.period_units == J
    assert plan.grid * plan.per_block >= periods
    assert plan.grid <= ops.K3_BLOCKS_PER_SM * ops.SMS
    if (rows, C) == BOUNDARIES[0]:
        # 65,536 periods of 2 units over at most 3 resident blocks an SM
        # (396): 166 periods a block, a unit or two a thread
        assert (plan.grid, plan.per_block) == (395, 166)


# ----------------------- a numpy model of the kernels --------------------

def key_of(z):
    """The kernels' order-preserving map f32 -> u32 (-0 below +0)."""
    u = z.view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def float_of(k):
    u = np.where(k & 0x80000000, k & 0x7fffffff, ~k).astype(np.uint32)
    return u.view(np.float32)


def unit_channels(head, width, J, C):
    """The channels of each element of unit column j (0..J-1) as a thread
    steps to them: ``(head + width*j) % C`` once, then +1 with a wrap."""
    out = np.empty((J, width), np.int64)
    for j in range(J):
        c = (head + width * j) % C
        for i in range(width):
            out[j, i] = c
            c = 0 if c + 1 == C else c + 1
    return out


def model_quantize(x, res, plan, levels, fold_order):
    """K2 as the kernel orders it: per block, per thread's unit column,
    keys into the block's partials; the head and tail by block 0; the
    fold of all blocks' partials in ``fold_order``; then q and res' with
    each thread's stepped channels. Returns (q, lo, scale, res', lo key,
    hi key, the (unit, element) -> channel table checked)."""
    n, C = x.size, x.shape[-1]
    z = (x if res is None else x + res).reshape(-1)
    J, head = plan.period_units, plan.head
    chans = unit_channels(head, 4, J, C)
    e = head + 4 * np.arange(plan.units)[:, None] + np.arange(4)
    p, j = np.divmod(np.arange(plan.units), J)
    np.testing.assert_array_equal(chans[j], e % C)      # no modulo needed
    block = p // plan.per_block
    assert block.max(initial=0) < plan.grid
    lo_part = np.full((plan.grid, C), 0xffffffff, np.uint32)
    hi_part = np.zeros((plan.grid, C), np.uint32)
    keys = key_of(z)
    for b in range(plan.grid):
        mine = block == b
        np.minimum.at(lo_part[b], chans[j[mine]].ravel(),
                      keys[e[mine]].ravel())
        np.maximum.at(hi_part[b], chans[j[mine]].ravel(),
                      keys[e[mine]].ravel())
    single = np.r_[np.arange(head), np.arange(head + 4 * plan.units, n)]
    np.minimum.at(lo_part[0], single % C, keys[single])
    np.maximum.at(hi_part[0], single % C, keys[single])
    lo_key = np.full(C, 0xffffffff, np.uint32)
    hi_key = np.zeros(C, np.uint32)
    for b in fold_order:
        lo_key = np.minimum(lo_key, lo_part[b])
        hi_key = np.maximum(hi_key, hi_part[b])
    lo, hi = float_of(lo_key), float_of(hi_key)
    scale = (hi - lo) * np.float32(1.0 / levels)
    scale = np.where(np.isfinite(scale) & (scale > 0), scale,
                     np.float32(0)).astype(np.float32)
    c = np.arange(n) % C
    l, s = lo[c], scale[c]
    safe = np.where(s > 0, s, np.float32(1))
    qf = np.where(s > 0, np.clip(np.rint((z - l) / safe), 0, levels),
                  np.float32(0)).astype(np.float32)
    r = z - (l + s * qf)
    return (qf.astype(np.uint8).reshape(x.shape), lo, scale,
            r.reshape(x.shape), lo_key, hi_key)


def _draw(rows, C, seed, special):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, C)) * 3).astype(np.float32)
    if special:
        x[:, 0] = np.float32(2.5)                     # one value
        x[:, 1] = np.where(np.arange(rows) % 2, np.float32(0.0),
                           np.float32(-0.0))          # -0.0 and +0.0 only
        x[: rows // 2, 2] = np.float32(-0.0)          # -0 / +0 at the ends
        x[rows // 2:, 2] = np.abs(x[rows // 2:, 2])
        x[rows // 3, 2] = np.float32(0.0)
    res = (rng.normal(size=(rows, C)) * 0.01).astype(np.float32)
    if special:
        res[:, :3] = np.float32(-0.0)         # z keeps the signs of zeros
    return x, res


@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("rows,C,x_phase,levels", [
    (2048, 32, 0, 255), (512, 24, 1, 255), (300, 33, 3, 4),
    (1024, 7, 2, 255), (4096, 1, 0, 255), (96, 160, 1, 255)])
def test_kernel_model_matches_the_numpy_oracle(rows, C, x_phase, levels,
                                               with_res):
    x, res = _draw(rows, C, rows + C, special=C >= 3)
    res = res if with_res else None
    xt = _view(rows * C, torch.float32, 4 * x_phase).view(rows, C)
    # a small card so that even these sizes take several blocks
    plan = ops.quantize_plan(xt, None if res is None else xt, sms=8)
    orders = [list(range(plan.grid)), list(reversed(range(plan.grid))),
              list(np.random.default_rng(1).permutation(plan.grid))]
    got = [model_quantize(x, res, plan, levels, o) for o in orders]
    for g in got[1:]:                         # the fold is order-free
        for a, b in zip(g, got[0]):
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    q, lo, scale, r, lo_key, hi_key = got[0]
    rq, rlo, rscale, rr, ok, rz = np_ref(x, res, levels=levels)
    assert ok
    np.testing.assert_array_equal(q, rq)
    np.testing.assert_array_equal(lo, rlo)    # equal as values (+0 == -0)
    np.testing.assert_array_equal(float_of(hi_key), rz.reshape(-1, C).max(0))
    np.testing.assert_array_equal(scale.view(np.uint32),
                                  rscale.view(np.uint32))
    np.testing.assert_array_equal(r, rr)
    nz = r != 0                 # bit for bit but for the sign of a zero
    np.testing.assert_array_equal(r[nz].view(np.uint32),
                                  rr[nz].view(np.uint32))
    if C >= 3:
        # the keys keep -0 below +0: a channel of both has lo -0, hi +0
        assert lo_key[1] < hi_key[1]
        assert np.signbit(lo[1]) and not np.signbit(float_of(hi_key)[1])
        assert scale[0] == 0 and np.all(q[:, 0] == 0) and lo[0] == 2.5
        np.testing.assert_array_equal(r[:, 0], np.zeros(rows, np.float32))


@pytest.mark.parametrize("rows,C,q_phase", [
    (64, 32, 0), (64, 7, 8), (40, 33, 8), (100, 1, 3), (33, 24, 8),
    (16, 320, 0), (3, 5, 8)])
def test_dequantize_model_steps_to_every_channel(rows, C, q_phase):
    """K3 as the kernel orders it: 16 codes a unit, each thread's 16
    channels stepped from ``(head + 16 j) % C``; the head (codes before
    the 16-byte boundary) and tail one at a time; equal to the oracle's
    ``lo + scale*q`` bit for bit."""
    rng = np.random.default_rng(rows * C)
    q = rng.integers(0, 256, size=(rows, C)).astype(np.uint8)
    lo = rng.normal(size=C).astype(np.float32)
    scale = np.abs(rng.normal(size=C)).astype(np.float32) * np.float32(0.01)
    plan = ops._dequantize_plan(rows * C, C, q_phase, 8)
    n, J, head = rows * C, plan.period_units, plan.head
    chans = unit_channels(head, 16, J, C)
    u = np.arange(plan.units)
    e = head + 16 * u[:, None] + np.arange(16)
    np.testing.assert_array_equal(chans[u % J], e % C)
    covered = np.zeros(n, np.int64)
    np.add.at(covered, e.ravel(), 1)
    covered[:head] += 1
    covered[head + 16 * plan.units:] += 1
    assert np.all(covered == 1)               # every code exactly once
    assert (u // J // plan.per_block).max(initial=0) < plan.grid
    flat = q.reshape(-1).astype(np.float32)
    c = np.full(n, -1)
    c[e.ravel()] = chans[u % J].ravel()
    single = np.r_[np.arange(head), np.arange(head + 16 * plan.units, n)]
    c[single] = single % C
    out = lo[c] + scale[c] * flat
    want = lo + scale * q.astype(np.float32)
    np.testing.assert_array_equal(out.reshape(rows, C).view(np.uint32),
                                  want.view(np.uint32))


def test_dequantize_store_transpose_is_contiguous_and_conflict_free():
    """K3's per-warp transpose: lane l stores its four float4 (k = 0..3,
    covering codes 16l..16l+15) at swizzled slot 4l + (k ^ ((l >> 1) & 3));
    in store k lane l reads float4 32k + l of the warp's output. Every
    float4 is read back from the lane and slot that wrote it, so each
    store writes 512 contiguous bytes, and every phase of 8 lanes (one
    128-bit shared-memory wavefront) touches 8 distinct 16-byte bank
    groups, writing and reading."""
    lanes, ks = np.meshgrid(np.arange(32), np.arange(4), indexing="ij")
    slot_w = 4 * lanes + (ks ^ ((lanes >> 1) & 3))
    assert sorted(slot_w.ravel()) == list(range(128))
    owner = np.empty((128, 2), np.int64)
    owner[slot_w.ravel()] = np.stack([lanes.ravel(), ks.ravel()], 1)
    for k in range(4):
        f = 32 * k + np.arange(32)              # the float4 lane l stores
        sl = f >> 2
        slot_r = 4 * sl + ((f & 3) ^ ((sl >> 1) & 3))
        np.testing.assert_array_equal(owner[slot_r], np.stack([sl, f & 3],
                                                              1))
        for phase in range(4):
            lane = slice(8 * phase, 8 * phase + 8)
            assert len(set(slot_r[lane] % 8)) == 8
            assert len(set(slot_w[lane, k] % 8)) == 8


# ------------------------------ packaging --------------------------------

def test_package_data_ships_every_kernel_source():
    """An installed ``repro_torch`` builds its kernels from the shipped
    ``csrc``: every source and every header a kernel includes matches
    the package data of ``pyproject.toml``."""
    import fnmatch
    import pathlib
    import tomllib

    from repro_torch.kernels import build
    root = pathlib.Path(__file__).resolve().parents[1]
    with open(root / "pyproject.toml", "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "repro_torch"]
    package = build.CSRC.parent
    needed = {path for cu in build.CSRC.glob("*.cu")
              for path in build.sources(cu.stem)}
    assert any(p.suffix == ".cuh" for p in needed)
    for path in needed:
        rel = path.relative_to(package).as_posix()
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel
