"""Host-side layouts and launch plans of kernels K3 (``ops/resblock.py``)
and K4 (``ops/qconv.py``), on the CPU at the shapes the main paths give
them.

- each packing function round-trips to the JAX-layout weights exactly
  (bit-equal: packing only moves and pads values);
- each launch plan covers every output pixel x channel exactly once, and
  every row a tile reads lies inside its staged window and inside the
  input;
- each launch plan is one the kernel's C entry point accepts (the wrapper
  passes the plan's ring, boxes, cluster size and grid; the entry point
  checks them and refuses a launch otherwise), on an H100 SXM (132 SMs)
  and an H100 PCIe (114).
"""

import numpy as np
import pytest
import torch

from alink_tpu_torch.ops import qconv as tq
from alink_tpu_torch.ops import resblock

# K4: LResNet100E-II's stage convs, batch 64 (chip_smoke.py (h)).
K4_SHAPES = [(56, 64, 64), (28, 128, 128), (14, 256, 256), (7, 512, 512),
             (14, 512, 512)]
K4_BATCH = 64
# K3: VGGFace-ResNet50's stride-1 block shapes at 224x224 (chip_smoke.py (e)).
K3_SHAPES = [(55, 64, 64, 256, True), (55, 256, 64, 256, False),
             (28, 512, 128, 512, False), (14, 1024, 256, 1024, False),
             (7, 2048, 512, 2048, False)]


def _rup(x, m):
    return -(-x // m) * m


# -- K4 ----------------------------------------------------------------------

@pytest.mark.parametrize("hw,cin,cout", K4_SHAPES)
def test_pack_conv_round_trips(hw, cin, cout):
    g = torch.Generator().manual_seed(cin + cout)
    w = torch.randint(-127, 128, (3, 3, cin, cout), generator=g,
                      dtype=torch.int8)
    vecs = [torch.rand(cout, generator=g) for _ in range(4)]
    p = tq.pack_conv(w, *vecs)
    cout_k = _rup(cout, 64)
    bn = tq.block_cols(cout_k)
    assert p.w.shape == (_rup(cin, 32) // 32, cout_k // bn, 9, bn // 8, 2, 8,
                         16)
    assert p.w.is_contiguous() and p.w.dtype == torch.int8
    # (chunk kc, column tile ct, tap, group g, half c, row r, byte b) holds
    # w[tap // 3, tap % 3, 32 kc + 16 c + b, bn ct + 8 g + r]
    kc, ct, tap, g8, c, r, b = (p.w.shape[0] - 1, p.w.shape[1] - 1, 5, 3, 1,
                                6, 9)
    assert p.w[kc, ct, tap, g8, c, r, b] == w[1, 2, 32 * kc + 16 * c + b,
                                              bn * ct + 8 * g8 + r]
    back = tq.unpack_conv(p)
    assert torch.equal(back[0], w)
    for a, b in zip(back[1:], vecs):
        assert torch.equal(a, b)
    # padded channels are zero vectors
    assert not p.scale[cout:].any()


def test_pack_conv_pads_odd_widths():
    w = torch.ones(3, 3, 20, 70, dtype=torch.int8)
    p = tq.pack_conv(w, torch.ones(70), torch.ones(70))
    assert p.w.shape == (1, 1, 9, 16, 2, 8, 16) and (p.cin, p.cout) == (20, 70)
    assert int(p.w.sum()) == 9 * 20 * 70
    assert torch.equal(p.alpha[:70], torch.ones(70))   # defaults to ones


@pytest.mark.parametrize("hw,cin,cout", K4_SHAPES)
def test_qconv_launch_plan_covers_each_output_once(hw, cin, cout):
    lo = tq.flat_layout(K4_BATCH, hw, hw)
    cout_k, ldo = _rup(cout, 64), _rup(cout, 128)
    plan = tq.launch_plan(lo, _rup(cin, 32), cout_k)
    rows = lo.n * lo.r
    npix = lo.n * lo.h * lo.w
    assert plan.tiles == -(-npix // 128) and plan.smem <= 232448
    assert plan.bn * plan.col_tiles == cout_k and 2 <= plan.stages <= 6
    # The weights stay resident where they fit: Cin 64 and 128.
    assert plan.resident == (cin <= 128) and (plan.stages >= 3
                                              or not plan.resident)
    # A window is whole TMA boxes of at most 256 rows, 8-row aligned, and
    # wastes less than a box's 8-row rounding per box.
    assert plan.box_rows % 8 == 0 and plan.box_rows <= 256
    assert 0 <= plan.nbox * plan.box_rows - plan.wmax < 8 * plan.nbox

    # Pixel rows: each pixel's row belongs to one tile, and the pixel rows
    # are exactly the rows the layout marks as pixels.
    p = torch.arange(npix)
    q = tq.pixel_rows(lo, p)
    valid = tq._valid_rows(rows, lo, "cpu")[:, 0]
    assert torch.equal(torch.sort(q).values, valid.nonzero()[:, 0])
    assert torch.equal(plan.first_row, q[::128])

    # Zero ranges tile [0, rows) without overlap, and each tile's pixels lie
    # in its own range: every row is written by exactly one tile.
    z = plan.zero
    assert int(z[0, 0]) == 0 and int(z[-1, 1]) == rows
    assert torch.equal(z[1:, 0], z[:-1, 1]) and bool((z[:, 1] > z[:, 0]).all())
    t = p // 128
    assert bool(((q >= z[t, 0]) & (q < z[t, 1])).all())

    # Every tap of every pixel reads inside its tile's window and inside
    # the input (lo.rows rows); the widest window is the planned one.
    s0, nrows = plan.window[t, 0], plan.window[t, 1]
    assert int(plan.window[:, 1].max()) == plan.wmax
    for dy in range(3):
        for dx in range(3):
            src = q + lo.lead + (dy - 1) * lo.wp + (dx - 1)
            assert bool(((src >= s0) & (src < s0 + nrows)).all())
    assert int(plan.window[:, 0].min()) >= 0
    assert int((plan.window[:, 0] + plan.window[:, 1]).max()) <= lo.rows

    # Columns: the column tiles cover [0, cout_k) once; the last one also
    # zero-fills [cout_k, ldo).
    cols = torch.zeros(ldo, dtype=torch.int64)
    for by in range(plan.col_tiles):
        cols[by * plan.bn:(by + 1) * plan.bn] += 1
    cols[cout_k:] += 1
    assert bool((cols == 1).all())

    # Persistent blocks: block bx walks tiles bx, bx + G, ...; any grid
    # width visits every tile once, the planned one included.
    assert plan.grid == min(plan.tiles, -(-132 // plan.col_tiles))
    for grid in (1, 7, plan.grid, plan.tiles):
        walked = torch.cat([torch.arange(bx, plan.tiles, grid)
                            for bx in range(min(grid, plan.tiles))])
        assert torch.equal(torch.sort(walked).values,
                           torch.arange(plan.tiles))


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("hw,cin,cout", K4_SHAPES)
def test_qconv_launch_plan_passes_the_entry_points_checks(hw, cin, cout, sms):
    """``alink_qconv`` (csrc/qconv.cu) launches the plan it is given only
    if its boxes are 8-row multiples of at most 256 rows whose window holds
    every tile's rows, its ring is 2-6 deep within the shared memory, and
    its grid has 1 to ``tiles`` blocks per column tile."""
    lo = tq.flat_layout(K4_BATCH, hw, hw)
    cin_k, cout_k = _rup(cin, 32), _rup(cout, 64)
    plan = tq.launch_plan(lo, cin_k, cout_k, sms)
    npix = lo.n * lo.h * lo.w
    # The entry point's own widest window: every tile's first to last pixel
    # row plus the taps' reach.
    wmax = max(int(tq.pixel_rows(lo, torch.tensor(min(t * 128 + 127,
                                                      npix - 1))))
               - int(tq.pixel_rows(lo, torch.tensor(t * 128)))
               + 2 * lo.wp + 3 for t in range(plan.tiles))
    assert wmax == plan.wmax
    assert 8 <= plan.box_rows <= 256 and plan.box_rows % 8 == 0
    assert plan.nbox * plan.box_rows >= wmax
    assert 2 <= plan.stages <= 6 and plan.smem <= 232448
    assert plan.smem == tq._smem(plan.bn, plan.stages, plan.resident,
                                 cin_k // 32, plan.box_rows, plan.nbox)
    assert 1 <= plan.grid <= plan.tiles
    # One block per SM: the grid fills the card, and no more.
    assert plan.grid * plan.col_tiles <= sms + plan.col_tiles - 1
    assert plan.grid == plan.tiles or plan.grid * plan.col_tiles >= sms


def test_qconv_kernel_refuses_unpacked_operands():
    lo = tq.flat_layout(1, 4, 4)
    xf = torch.zeros(lo.rows, 32, dtype=torch.int8)
    w = torch.zeros(3, 3, 32, 64, dtype=torch.int8)
    ops = tq._operands(xf, w, torch.ones(64), torch.ones(64), None, None)
    with pytest.raises(ValueError, match="pack_conv"):
        tq._check_packed(ops, torch.device("cpu"))
    p = tq.pack_conv(w, torch.ones(64), torch.ones(64))
    tq._check_packed(p, torch.device("cpu"))
    with pytest.raises(ValueError, match="pack_conv"):
        tq._check_packed(p._replace(w=p.w.reshape(1, 9, 64, 32)),
                         torch.device("cpu"))
    with pytest.raises(ValueError, match="pack_conv"):
        tq._check_packed(p._replace(scale=p.scale.double()),
                         torch.device("cpu"))


# -- K3 ----------------------------------------------------------------------

def _k3_weights(cin, cm, cout, proj, seed):
    g = torch.Generator().manual_seed(seed)
    mats = [torch.randn(s, generator=g) for s in
            ((cin, cm), (3, 3, cm, cm), (cm, cout))]
    vecs = [torch.rand(c, generator=g) for c in (cm, cm, cm, cm, cout, cout)]
    wts = resblock.BottleneckWeights(
        mats[0], *vecs[0:2], mats[1], *vecs[2:4], mats[2], *vecs[4:6])
    if proj:
        wts = wts._replace(wp=torch.randn((cin, cout), generator=g),
                           sp=torch.rand(cout, generator=g),
                           bp=torch.rand(cout, generator=g))
    return wts


@pytest.mark.parametrize("hw,cin,cm,cout,proj", K3_SHAPES)
def test_pack_bottleneck_round_trips(hw, cin, cm, cout, proj):
    kw = resblock.kernel_weights(_k3_weights(cin, cm, cout, proj, cm + cin),
                                 torch.device("cpu"))
    p = kw.packed
    assert p is not None and all(t.is_contiguous() and t.dtype ==
                                 torch.bfloat16 for t in p if t is not None)
    n1, n3 = min(cm, 128), min(cout, 128)
    assert p.w1.shape == (cm // n1, cin // 32, n1, 32)
    assert p.w3.shape == (cm // n1, 9, cm // 32, n1, 32)
    assert p.w2.shape == (cout // n3, cm // 32, n3, 32)
    assert (p.wp is None) == (not proj)
    # Slab (pass q, K-slab s) row n, physical 16-byte chunk c holds
    # w1[32 s + 8 (c ^ ((n >> 1) & 3)) + e, n1 q + n], e < 8.
    q, sl, n, c = cm // n1 - 1, 1, 13, 2
    logical = c ^ ((n >> 1) & 3)
    assert torch.equal(p.w1[q, sl, n, 8 * c:8 * c + 8],
                       kw.w1[32 * sl + 8 * logical:32 * sl + 8 * logical + 8,
                             n1 * q + n])
    back = resblock.unpack_bottleneck(p)
    for got, want in zip(back, (kw.w1, kw.w3, kw.w2, kw.wp)):
        assert (got is None and want is None) or torch.equal(got, want)


@pytest.mark.parametrize("batch", [32, 256])
@pytest.mark.parametrize("hw,cin,cm,cout,proj", K3_SHAPES)
def test_bottleneck_launch_plan_covers_each_output_once(hw, cin, cm, cout,
                                                        proj, batch):
    plan = resblock.launch_plan(batch, hw, hw, cin, cm, cout, proj)
    assert plan.smem <= 232448 and 2 <= plan.slots <= 4
    assert plan.tiles == batch * plan.tiles_x * plan.tiles_y
    # A cluster shares a tile only where the tiles are fewer than half the
    # SMs: at 7x7, batch 32 (32 tiles, 4 blocks each); never at batch 256.
    assert plan.split == (4 if (hw, batch) == (7, 32) else 1)
    # Short tiles (Cm <= 128) outnumbering the SMs are walked by one
    # persistent block per SM; otherwise one block per tile.
    persistent = cm <= 128 and plan.tiles > 132
    assert plan.blocks == (132 if persistent else plan.tiles * plan.split)
    # Block b walks tiles b, b + blocks / split, ...: every tile once.
    step = plan.blocks // plan.split
    walked = torch.cat([torch.arange(b, plan.tiles, step)
                        for b in range(step)])
    assert torch.equal(torch.sort(walked).values, torch.arange(plan.tiles))
    # The 8 x 8 tiles of one image cover each output pixel once.
    hits = torch.zeros(plan.tiles_y * 8, plan.tiles_x * 8, dtype=torch.int64)
    for ty in range(plan.tiles_y):
        for tx in range(plan.tiles_x):
            hits[8 * ty:8 * ty + 8, 8 * tx:8 * tx + 8] += 1
    assert bool((hits[:hw, :hw] == 1).all())
    # The 3x3's 80 flat rows (8 rows of the 10-wide halo) read y1 rows
    # r + 10 dy + dx, inside the 102 rows of y1 (guard row included).
    r = torch.arange(80)
    reads = torch.stack([r + 10 * dy + dx for dy in range(3)
                         for dx in range(3)])
    assert int(reads.min()) >= 0 and int(reads.max()) < 102
    # Over the blocks of a tile, the schedules visit every (K slab, column
    # pass) of W1, of each tap of W3, of W2 and of Wp once, each block in
    # pairs of slabs (one ring entry), and end each pass with its epilogue.
    assert len(plan.schedule) == plan.split
    seen = {}
    for sched in plan.schedule:
        assert len(sched) % 2 == 0
        for (s0, q0, t0, *_), (s1, q1, t1, *_) in zip(sched[::2],
                                                      sched[1::2]):
            assert (s0, q0, t0) == (s1, q1, t1)
        for stage, pas, tap, k0, pr, last in sched:
            key = (stage, pas, tap, k0, pr)
            seen[key] = seen.get(key, 0) + 1
    assert set(seen.values()) == {1}
    n1, n3 = min(cm, 128), min(cout, 128)
    want = ({(1, q, 0, k, False) for q in range(cm // n1)
             for k in range(0, cin, 32)}
            | {(2, q, t, k, False) for q in range(cm // n1) for t in range(9)
               for k in range(0, cm, 32)}
            | {(3, q, 0, k, False) for q in range(cout // n3)
               for k in range(0, cm, 32)}
            | {(3, q, 0, k, True) for q in range(cout // n3)
               for k in range(0, cin if proj else 0, 32)})
    assert set(seen) == want
    ends = [(s, q) for sched in plan.schedule
            for s, q, *_, last in sched if last]
    assert len(ends) == len(set(ends)) == 2 * (cm // n1) + cout // n3


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("batch", [32, 64, 256])
@pytest.mark.parametrize("hw,cin,cm,cout,proj", K3_SHAPES)
def test_bottleneck_launch_plan_passes_the_entry_points_checks(
        hw, cin, cm, cout, proj, batch, sms):
    """``alink_bottleneck`` (csrc/bottleneck.cu) launches the plan it is
    given only if its ring has 2-4 entries within the shared memory, its
    cluster size is 1, 2 or 4 and divides the passes of every stage, and a
    cluster shares exactly one tile (its y1/y2 barriers complete once)."""
    plan = resblock.launch_plan(batch, hw, hw, cin, cm, cout, proj, sms)
    n1, n3 = min(cm, 128), min(cout, 128)
    assert 2 <= plan.slots <= 4 and plan.smem <= 232448
    assert plan.smem == resblock._smem(cm, plan.slots)
    assert plan.split in (1, 2, 4)
    assert (cm // n1) % plan.split == 0 and (cout // n3) % plan.split == 0
    assert plan.blocks >= 1
    if plan.split > 1:
        assert plan.blocks == plan.tiles * plan.split <= sms
    # Clusters only where the tiles are fewer than half the SMs, as large as
    # the card holds: 7x7 at batch 32 on 132 SMs takes clusters of 4, on
    # 114 (128 blocks would not fit) of 2; batch 64 takes 2 on 132 only.
    want = {(7, 32, 132): 4, (7, 32, 114): 2, (7, 64, 132): 2}
    assert plan.split == want.get((hw, batch, sms), 1)
    # Persistent blocks, one per SM, where short tiles outnumber the SMs.
    persistent = cm <= 128 and plan.tiles > sms
    assert plan.blocks == (sms if persistent else plan.tiles * plan.split)


def test_bottleneck_kernel_refuses_unpacked_weights():
    wts = resblock.kernel_weights(_k3_weights(64, 64, 256, True, 0),
                                  torch.device("cpu"))
    resblock._check_packed(wts, torch.device("cpu"))
    with pytest.raises(ValueError, match="kernel_weights"):
        resblock._check_packed(wts._replace(packed=None), torch.device("cpu"))
    bad = wts.packed._replace(w2=wts.packed.w2[:1].contiguous())
    with pytest.raises(ValueError, match="packed w2"):
        resblock._check_packed(wts._replace(packed=bad), torch.device("cpu"))
    # Widths the kernel does not tile are not packed, and are refused.
    odd = resblock.kernel_weights(_k3_weights(32, 16, 64, True, 1),
                                  torch.device("cpu"))
    assert odd.packed is None and not resblock.kernel_takes(32, 16, 64)
    # Cin is staged in pairs of 32-channel slabs: 64 at a time.
    assert not resblock.kernel_takes(96, 64, 64)
    assert resblock.kernel_takes(128, 64, 64)
