"""Host-side layouts and launch plans of kernels K1 (``ops/pairwise.py``),
K2 (``ops/image.py``), K3 (``ops/resblock.py``) and K4 (``ops/qconv.py``),
on the CPU at the shapes the main paths give them.

- each packing function round-trips to the JAX-layout weights exactly
  (bit-equal: packing only moves and pads values);
- each launch plan covers every output pixel x channel exactly once, and
  every row a tile reads lies inside its staged window and inside the
  input;
- K3's zero padding to the widths it tiles is exact;
- each launch plan is one the kernel's C entry point accepts (the wrapper
  passes the plan's ring, boxes, cluster size and grid; the entry point
  checks them and refuses a launch otherwise), on an H100 SXM (132 SMs)
  and an H100 PCIe (114);
- K3's plans at RetinaFace-R50's shapes (160^2 to 20^2, batch 1 to 256)
  are valid, and those at VGGFace-ResNet50's are the ones they were.
"""

import numpy as np
import pytest
import torch

from alink_tpu_torch.models import SiameseHead
from alink_tpu_torch.ops import image, pairwise
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
    n1, n3 = min(cm, 128), 64 if proj else min(cout, 128)
    assert p.w1.shape == (cm // n1, cin // 16, n1 // 8, 2, 8, 8)
    assert p.w3.shape == (cm // n1, 9, cm // 16, n1 // 8, 2, 8, 8)
    assert p.w2.shape == (cout // n3, cm // 16, n3 // 8, 2, 8, 8)
    assert (p.wp is None) == (not proj)
    # The kernel's B operand: K slice s of pass q starts s * n1 * 32 bytes
    # into the pass; in it, column n's 8-row group n // 8 lies 256 bytes
    # apart (the descriptor's stride offset), the slice's two 8-row K
    # halves 128 bytes apart (leading offset), then 16 bytes a column and 2
    # a K row: element (k, n) of the slice at byte 256 (n // 8) + 128 (k //
    # 8) + 16 (n % 8) + 2 (k % 8).
    flat = p.w1[cm // n1 - 1].reshape(-1)
    for s_, k, n in ((1, 13, 37), (cin // 16 - 1, 2, n1 - 1), (0, 9, 8)):
        byte = s_ * n1 * 32 + 256 * (n // 8) + 128 * (k // 8) + 16 * (
            n % 8) + 2 * (k % 8)
        assert torch.equal(flat[byte // 2],
                           kw.w1[16 * s_ + k, n1 * (cm // n1 - 1) + n])
    back = resblock.unpack_bottleneck(p)
    for got, want in zip(back, (kw.w1, kw.w3, kw.w2, kw.wp)):
        assert (got is None and want is None) or torch.equal(got, want)


# Widths the kernel does not tile: identity and projected.
K3_ODD = [(96, 48, 96, False), (32, 80, 200, True), (200, 48, 200, False)]


@pytest.mark.parametrize("cin,cm,cout,proj", K3_ODD)
def test_pack_bottleneck_pads_odd_widths(cin, cm, cout, proj):
    """``kernel_weights`` packs the weights zero-padded to the widths the
    kernel runs (64 or a multiple of 128): the packing round-trips to
    ``pad_bottleneck``'s matrices, which hold the weights in their leading
    rows and columns and zeros elsewhere; pad scales and shifts are 0."""
    kw = resblock.kernel_weights(_k3_weights(cin, cm, cout, proj, cin + cm),
                                 torch.device("cpu"))
    ci, cmp_, co = (resblock.padded_width(c) for c in (cin, cm, cout))
    assert ci % 64 == 0 and cmp_ in (64, 128, 256) and co % 128 == 0
    assert (ci == co) or proj          # identity pads Cin and Cout alike
    resblock._check_packed(kw, torch.device("cpu"))
    pw = resblock.pad_bottleneck(kw)
    back = resblock.unpack_bottleneck(kw.packed)
    for got, want, small in zip(back, (pw.w1, pw.w3, pw.w2, pw.wp),
                                (kw.w1, kw.w3, kw.w2, kw.wp)):
        if want is None:
            assert got is None and small is None
            continue
        assert torch.equal(got, want)
        lead = tuple(slice(0, k) for k in small.shape)
        assert torch.equal(got[lead], small)
        rest = got.clone()
        rest[lead] = 0
        assert not rest.any()
    for v, small in zip(kw.vecs, (kw.s1, kw.b1, kw.s2, kw.b2, kw.s3, kw.b3,
                                  kw.sp, kw.bp)):
        if small is None:
            assert v is None
            continue
        assert v.dtype == torch.float32 and v.is_contiguous()
        assert torch.equal(v[:small.shape[0]], small)
        assert not v[small.shape[0]:].any()


@pytest.mark.parametrize("cin,cm,cout,proj", K3_ODD)
def test_padded_plain_block_equals_unpadded(cin, cm, cout, proj):
    """The plain block on the weights and input padded by the function the
    kernel path uses, pad channels sliced off, equals the plain block on
    the unpadded ones bit for bit, and its pad channels are 0.  Dyadic data
    (integer activations, weights in {-1, 0, 1}, power-of-two BN) keep every
    f32 sum exact, so summing more zeros in another blocking cannot round
    differently: what is tested is the padding alone."""
    g = torch.Generator().manual_seed(cin * cm + cout)

    def mat(*shape):
        return torch.randint(-1, 2, shape, generator=g).float()

    def bn(c):
        return (torch.randint(1, 3, (c,), generator=g) * 0.125,
                torch.randint(-3, 4, (c,), generator=g) * 0.125)

    wts = resblock.BottleneckWeights(mat(cin, cm), *bn(cm), mat(3, 3, cm, cm),
                                     *bn(cm), mat(cm, cout), *bn(cout))
    if proj:
        wts = wts._replace(wp=mat(cin, cout), sp=bn(cout)[0], bp=bn(cout)[1])
    x = torch.randint(-2, 3, (2, 5, 7, cin), generator=g).float()
    want = resblock.bottleneck_s1_reference(x, wts)
    pw = resblock.pad_bottleneck(wts)
    xp = torch.nn.functional.pad(x, (0, pw.w1.shape[0] - cin))
    got = resblock.bottleneck_s1_reference(xp, pw)
    assert got.shape[-1] == resblock.padded_width(cout)
    assert torch.equal(got[..., :cout], want)
    assert not got[..., cout:].float().any()
    assert float((want != 0).float().mean()) > 0.2


# Cm that pads past 512: y1 and y2 in the kernel's global scratch.
K3_WIDE = [(64, 576, 64, True), (512, 576, 1024, True),
           (1024, 1024, 1024, False)]


@pytest.mark.parametrize("cin,cm,cout,proj", K3_WIDE)
def test_pack_bottleneck_wide_cm_round_trips(cin, cm, cout, proj):
    """A Cm past 512 is taken (no width raises): packed at its padded
    width, round-tripping to ``pad_bottleneck``'s matrices, pad scales and
    shifts 0."""
    assert resblock.kernel_takes(cin, cm, cout)
    assert resblock.padded_width(cm) == {576: 640, 1024: 1024}[cm]
    kw = resblock.kernel_weights(_k3_weights(cin, cm, cout, proj, cm + cout),
                                 torch.device("cpu"))
    resblock._check_packed(kw, torch.device("cpu"))
    pw = resblock.pad_bottleneck(kw)
    cmp_ = resblock.padded_width(cm)
    assert kw.packed.w3.shape == (cmp_ // 128, 9, cmp_ // 16, 16, 2, 8, 8)
    for got, want in zip(resblock.unpack_bottleneck(kw.packed),
                         (pw.w1, pw.w3, pw.w2, pw.wp)):
        assert (got is None and want is None) or torch.equal(got, want)
    assert torch.equal(kw.vecs.s2[:cm], kw.s2) and not kw.vecs.s2[cm:].any()


def _k3_entry_accepts(plan, n, h, w, cin, cm, cout, proj, sms) -> bool:
    """The checks of ``alink_bottleneck`` (csrc/bottleneck.cu) on the plan
    the wrapper passes: a tile within a TMA box whose stages fit 3 and 2
    64-row products, a ring of 2-4 entries within the shared memory, a
    cluster size of 1, 2 or 4 that divides the passes of every stage and
    shares exactly one tile, no cluster with global y1/y2."""
    t = plan.tile
    geom = resblock.bottleneck_tile(t.th, t.tw)
    entry, total = resblock._smem(cm, geom, plan.slots, plan.global_act)
    n1, n3 = min(cm, 128), 64 if proj else min(cout, 128)
    tiles = n * -(-h // t.th) * -(-w // t.tw)
    return (geom == t and 1 <= t.th <= h and 1 <= t.tw <= w
            and t.th + 2 <= 256 and t.tw + 2 <= 256 and t.mt1 <= 3
            and t.mt2 <= 2 and 2 <= plan.slots <= 4 and total <= 232448
            and (entry, total) == (plan.entry, plan.smem)
            and not (plan.global_act and plan.split != 1)
            and plan.split in (1, 2, 4) and (cm // n1) % plan.split == 0
            and (cout // n3) % plan.split == 0 and plan.blocks >= 1
            and tiles == plan.tiles
            and (plan.split == 1 or plan.blocks == tiles * plan.split))


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("batch,hw", [(32, 14), (32, 28), (1, 7)])
@pytest.mark.parametrize("cin,cm,cout,proj", K3_WIDE)
def test_bottleneck_launch_plan_wide_cm_uses_global_scratch(
        cin, cm, cout, proj, batch, hw, sms):
    """Past Cm 512, y1 and y2 of a tile do not fit shared memory beside a
    2-entry ring: the plan keeps them in global scratch (halo + 64 mt2
    rows a block), without clusters, on at most one block per SM (block b
    walks tiles b, b + blocks, ...: every tile once), and holds the ring
    and barriers only; the entry point's checks pass, at batch 1,024 too.
    VGGFace-ResNet50's shapes keep shared memory at every batch."""
    ci, cmp_, co = (resblock.padded_width(c) for c in (cin, cm, cout))
    for n in (batch, 1024):
        plan = resblock.launch_plan(n, hw, hw, ci, cmp_, co, proj, sms)
        t = plan.tile
        assert plan.global_act and plan.split == 1
        assert 2 <= plan.slots <= 4
        assert plan.act_rows == t.halo + 64 * t.mt2
        assert plan.smem == resblock._smem(cmp_, t, plan.slots, True)[1]
        assert plan.smem == plan.slots * plan.entry + 80 + 1024 <= 232448
        assert plan.blocks == min(plan.tiles, sms)
        assert _k3_entry_accepts(plan, n, hw, hw, ci, cmp_, co, proj, sms)
        walked = torch.cat([torch.arange(b, plan.tiles, plan.blocks)
                            for b in range(plan.blocks)])
        assert torch.equal(torch.sort(walked).values,
                           torch.arange(plan.tiles))
        for shape in K3_SHAPES:
            hw0, cin0, cm0, cout0, proj0 = shape
            assert not resblock.launch_plan(n, hw0, hw0, cin0, cm0, cout0,
                                            proj0, sms).global_act


def test_padded_plain_block_equals_unpadded_wide_cm():
    """The zero padding is exact at a Cm that pads past 512 too."""
    test_padded_plain_block_equals_unpadded(64, 576, 64, True)


@pytest.mark.parametrize("cin,cm,cout,proj", K3_ODD)
def test_bottleneck_launch_plan_covers_padded_widths(cin, cm, cout, proj):
    """The launch plan at the padded widths passes the entry point's checks
    (a tile of whole 64-row products, 2-4 ring entries in shared memory, a
    cluster size dividing the passes) at 132 and 114 SMs, at batch 1, 32
    and 1,024."""
    ci, cmp_, co = (resblock.padded_width(c) for c in (cin, cm, cout))
    for sms in (132, 114):
        for n in (1, 32, 1024):
            plan = resblock.launch_plan(n, 28, 28, ci, cmp_, co, proj, sms)
            assert 2 <= plan.slots <= 4 and plan.smem <= 232448
            assert not plan.global_act
            n1, n3 = min(cmp_, 128), 64 if proj else min(co, 128)
            assert (cmp_ // n1) % plan.split == 0
            assert (co // n3) % plan.split == 0
            assert _k3_entry_accepts(plan, n, 28, 28, ci, cmp_, co, proj,
                                     sms)


def test_bottleneck_kernel_names_the_width_it_refuses():
    """No Cm is refused: a Cm that pads past 512 is packed at its padded
    width (y1 and y2 in global scratch); what the wrapper refuses is an
    input whose channels match neither Cin nor its padded width, and it
    names that width."""
    wts = resblock.kernel_weights(_k3_weights(64, 576, 64, True, 3),
                                  torch.device("cpu"))
    resblock._check_packed(wts, torch.device("cpu"))
    assert wts.packed.w3.shape == (5, 9, 40, 16, 2, 8, 8)
    with pytest.raises(ValueError, match="x has 48 channels"):
        resblock.bottleneck_s1_kernel(torch.zeros(1, 4, 4, 48), wts)
    with pytest.raises(ValueError, match="CUDA"):
        resblock.bottleneck_s1_kernel(torch.zeros(1, 4, 4, 64), wts)


# The tiles launch_plan picks at VGGFace-ResNet50's five shapes (th, tw):
# 4 x 28 at 55^2 (2 x 14 tiles, one column past the image) and 28^2, 7 x
# 14 at 14^2, the whole image at 7^2.
K3_TILES = {55: (4, 28), 28: (4, 28), 14: (7, 14), 7: (7, 7)}


@pytest.mark.parametrize("batch", [1, 32, 256, 1024])
@pytest.mark.parametrize("hw,cin,cm,cout,proj", K3_SHAPES)
def test_bottleneck_launch_plan_covers_each_output_once(hw, cin, cm, cout,
                                                        proj, batch):
    plan = resblock.launch_plan(batch, hw, hw, cin, cm, cout, proj)
    t = plan.tile
    assert (t.th, t.tw) == K3_TILES[hw]
    assert plan.smem <= 232448 and 2 <= plan.slots <= 4
    assert plan.tiles == batch * plan.tiles_x * plan.tiles_y
    # A cluster shares a tile only where 2 or 4 blocks a tile still fit the
    # SMs: 7x7 at batch 32 (32 tiles, 4 blocks each), 14x14 at batch 32
    # (64 tiles, 2 each; 256 columns of y1 are 2 passes), and those two
    # at batch 1 (28^2's tiles, 7, and 55^2's single pass of 64 columns
    # take none).
    want_split = {(7, 32): 4, (14, 32): 2, (7, 1): 4, (14, 1): 2}
    assert plan.split == want_split.get((hw, batch), 1)
    # Tiles outnumbering the SMs are walked by one persistent block per
    # SM; otherwise one block (or cluster) per tile.
    persistent = plan.split == 1 and plan.tiles > 132
    assert plan.blocks == (132 if persistent else plan.tiles * plan.split)
    # Block b walks tiles b, b + blocks / split, ...: every tile once.
    step = plan.blocks // plan.split
    walked = torch.cat([torch.arange(b, plan.tiles, step)
                        for b in range(step)])
    assert torch.equal(torch.sort(walked).values, torch.arange(plan.tiles))
    # The th x tw tiles of one image cover each output pixel once.
    hits = torch.zeros(plan.tiles_y * t.th, plan.tiles_x * t.tw,
                       dtype=torch.int64)
    for ty in range(plan.tiles_y):
        for tx in range(plan.tiles_x):
            hits[t.th * ty:t.th * (ty + 1), t.tw * tx:t.tw * (tx + 1)] += 1
    assert bool((hits[:hw, :hw] == 1).all())
    # The 3x3's 64 mt2 flat rows read y1 rows q + hs dy + dx: a kept row
    # (column < tw, row < th) reads inside the halo; every read lies inside
    # y1 and y2 (halo + 64 mt2 rows), which follow one another.  The
    # projection's reads (q + hs + 1) lie inside the ring's x rows.
    q = torch.arange(64 * t.mt2)
    kept = (q % t.hs < t.tw) & (q // t.hs < t.th)
    reads = torch.stack([q + t.hs * dy + dx for dy in range(3)
                         for dx in range(3)])
    assert int(reads[:, kept].max()) < t.halo
    assert int(reads.max()) < t.halo + 64 * t.mt2
    assert 64 * t.mt2 + t.hs + 1 <= t.xrows and t.halo <= 64 * t.mt1
    assert 64 * t.mt1 <= t.xrows
    # Over the blocks of a tile, the ring entries visit every (64-row K
    # chunk, column pass) of W1, of each tap of W3, of W2 and of Wp once;
    # an entry holds one chunk with its x (stage 1, the projection) or up
    # to 4 consecutive chunks of one pass within its bytes; each pass ends
    # with its epilogue.
    assert len(plan.schedule) == plan.split
    n1, n3 = min(cm, 128), 64 if proj else min(cout, 128)
    seen = {}
    for sched in plan.schedule:
        for entry in sched:
            stages = {(c[0], c[1], c[4]) for c in entry}
            assert len(stages) == 1 and 1 <= len(entry) <= 4
            stage, pas, pr = stages.pop()
            np_ = n3 if stage == 3 else n1
            if stage == 1 or pr:
                assert len(entry) == 1
            assert len(entry) * np_ * 64 * 2 <= plan.entry
            for chunk in entry:
                seen[chunk[:5]] = seen.get(chunk[:5], 0) + 1
    assert set(seen.values()) == {1}
    want = ({(1, q, 0, k, False) for q in range(cm // n1)
             for k in range(0, cin, 64)}
            | {(2, q, t_, k, False) for q in range(cm // n1)
               for t_ in range(9) for k in range(0, cm, 64)}
            | {(3, q, 0, k, False) for q in range(cout // n3)
               for k in range(0, cm, 64)}
            | {(3, q, 0, k, True) for q in range(cout // n3)
               for k in range(0, cin if proj else 0, 64)})
    assert set(seen) == want
    ends = [(c[0], c[1]) for sched in plan.schedule for entry in sched
            for c in entry if c[5]]
    assert len(ends) == len(set(ends)) == 2 * (cm // n1) + cout // n3


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("batch", [1, 32, 64, 256, 1024])
@pytest.mark.parametrize("hw,cin,cm,cout,proj", K3_SHAPES)
def test_bottleneck_launch_plan_passes_the_entry_points_checks(
        hw, cin, cm, cout, proj, batch, sms):
    """``alink_bottleneck`` (csrc/bottleneck.cu) launches the plan it is
    given only if its tile fits a TMA box and 3 and 2 64-row products, its
    ring has 2-4 entries within the shared memory, its cluster size is 1,
    2 or 4 and divides the passes of every stage, and a cluster shares
    exactly one tile (its y1/y2 barriers complete once)."""
    plan = resblock.launch_plan(batch, hw, hw, cin, cm, cout, proj, sms)
    assert _k3_entry_accepts(plan, batch, hw, hw, cin, cm, cout, proj, sms)
    assert not plan.global_act
    if plan.split > 1:
        assert plan.blocks == plan.tiles * plan.split <= sms
    # Clusters where 2 or 4 blocks a tile still fit the card, as large as
    # divides the passes: 7x7 at batch 32 on 132 SMs takes clusters of 4,
    # on 114 (128 blocks would not fit) of 2; batch 64 takes 2 on 132
    # only; 14x14 (2 passes of y1) at most 2, at batch 32 on 132 only.
    want = {(7, 32, 132): 4, (7, 32, 114): 2, (7, 64, 132): 2,
            (14, 32, 132): 2}
    if batch == 1:
        want_split = {55: 1, 28: 1, 14: 2, 7: 4}[hw]
    else:
        want_split = want.get((hw, batch, sms), 1)
    assert plan.split == want_split
    # Persistent blocks, one per SM, where the tiles outnumber the SMs.
    persistent = plan.split == 1 and plan.tiles > sms
    assert plan.blocks == (sms if persistent else plan.tiles * plan.split)


@pytest.mark.parametrize("batch", [1, 32, 1024])
@pytest.mark.parametrize("hw,cin,cm,cout,proj", K3_SHAPES)
def test_bottleneck_tile_stages_fill_64_row_products(hw, cin, cm, cout,
                                                     proj, batch):
    """Every stage's computed rows are whole 64-row wgmma products (stage 1
    on the halo, stages 2 and 3 on the tile's flat rows), within the 3 and
    2 products a warpgroup's accumulators hold, and the block's shared
    memory (y1, y2, ring, barriers, alignment) stays within the H100's 227
    KB.  The tile holds the 49 outputs of a 7x7 image and, past 7x7, more
    than the 64 of an 8x8 tile, and computes under 1.35 rows of the 3x3
    and the expand a kept output."""
    plan = resblock.launch_plan(batch, hw, hw, cin, cm, cout, proj)
    t = plan.tile
    rows1, rows23 = 64 * t.mt1, 64 * t.mt2
    assert rows1 % 64 == 0 and rows23 % 64 == 0
    assert rows1 >= t.halo == (t.th + 2) * (t.tw + 2)
    assert rows23 >= t.th * t.hs and t.hs == t.tw + 2
    assert t.mt1 <= 3 and t.mt2 <= 2
    assert plan.smem == resblock._smem(cm, t, plan.slots)[1] <= 232448
    outputs = t.th * t.tw
    assert outputs >= (49 if hw == 7 else 65)
    assert rows23 / outputs < 1.35


def _flat_row_3x3(y: torch.Tensor, w3: torch.Tensor, th: int,
                  tw: int) -> torch.Tensor:
    """The kernel's 3x3 on the CPU: per tile, y's halo in flat rows of
    stride tw + 2 (zeros outside the image, NaN in every row past the halo
    and in y2's rows that follow it), the 9 taps as row offsets over whole
    64-row products, kept rows only written."""
    n, h, w, c = y.shape
    t = resblock.bottleneck_tile(th, tw)
    out = torch.full((n, h, w, w3.shape[-1]), float("nan"),
                     dtype=torch.float64)
    for img in range(n):
        for ty0 in range(0, h, th):
            for tx0 in range(0, w, tw):
                buf = torch.full((t.halo + 64 * t.mt2, c), float("nan"),
                                 dtype=torch.float64)
                for r in range(t.halo):
                    py, px = ty0 - 1 + r // t.hs, tx0 - 1 + r % t.hs
                    inside = 0 <= py < h and 0 <= px < w
                    buf[r] = y[img, py, px] if inside else 0.0
                acc = sum(buf[t.hs * dy + dx:t.hs * dy + dx + 64 * t.mt2]
                          @ w3[dy, dx] for dy in range(3) for dx in range(3))
                for q in range(64 * t.mt2):
                    oy, ox = ty0 + q // t.hs, tx0 + q % t.hs
                    if q // t.hs < th and q % t.hs < tw and oy < h and ox < w:
                        out[img, oy, ox] = acc[q]
    return out


# RetinaFace-R50's stride-1 block shapes at 640x640 (160^2 to 20^2) and the
# tiles launch_plan picks there: 5 x 23 at 160^2 (7 x 32 tiles, one column
# past the image), 4 x 27 at 80^2, 8 x 14 at 40^2, and 5 x 10 at 20^2, where
# the cheapest tile (5 x 20) would keep y1 and y2 in global scratch.
RETINA_K3_SHAPES = [(160, 64, 64, 256, True), (160, 256, 64, 256, False),
                    (80, 512, 128, 512, False), (40, 1024, 256, 1024, False),
                    (20, 2048, 512, 2048, False)]
RETINA_K3_TILES = {160: (5, 23), 80: (4, 27), 40: (8, 14), 20: (5, 10)}


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("batch", [1, 32, 256])
@pytest.mark.parametrize("hw,cin,cm,cout,proj", RETINA_K3_SHAPES)
def test_bottleneck_launch_plan_at_retinaface_shapes(hw, cin, cm, cout, proj,
                                                     batch, sms):
    """At the detector's shapes every plan is one the entry point accepts,
    keeps y1 and y2 in shared memory, walks every tile once and covers
    every output pixel once."""
    plan = resblock.launch_plan(batch, hw, hw, cin, cm, cout, proj, sms)
    t = plan.tile
    assert (t.th, t.tw) == RETINA_K3_TILES[hw]
    assert _k3_entry_accepts(plan, batch, hw, hw, cin, cm, cout, proj, sms)
    assert not plan.global_act
    persistent = plan.split == 1 and plan.tiles > sms
    assert plan.blocks == (sms if persistent else plan.tiles * plan.split)
    step = plan.blocks // plan.split
    walked = torch.cat([torch.arange(b, plan.tiles, step)
                        for b in range(step)])
    assert torch.equal(torch.sort(walked).values, torch.arange(plan.tiles))
    hits = torch.zeros(plan.tiles_y * t.th, plan.tiles_x * t.tw,
                       dtype=torch.int64)
    for ty in range(plan.tiles_y):
        for tx in range(plan.tiles_x):
            hits[t.th * ty:t.th * (ty + 1), t.tw * tx:t.tw * (tx + 1)] += 1
    assert bool((hits[:hw, :hw] == 1).all())


# sha256 of each VGGFace-shape plan (every field, the ring schedule
# included) as launch_plan gave it before RetinaFace's shapes were added.
VGG_K3_PLANS = {
    (55, 64, 32): "ffc9c2ede9144c32", (55, 64, 256): "d40f755b7f3f5da5",
    (55, 64, 1024): "61d07d1ed96ffedc", (55, 256, 32): "731f268b28c4e749",
    (55, 256, 256): "58cd530c8bdbcc4f", (55, 256, 1024): "2393bd4ad42810ac",
    (28, 512, 32): "bbdedb17d921146c", (28, 512, 256): "e47575b62a323928",
    (28, 512, 1024): "16974bfcb3cd6963", (14, 1024, 32): "05d73bab08b2ff19",
    (14, 1024, 256): "e2e8922f47b21c75", (14, 1024, 1024): "a132602da0dd6a10",
    (7, 2048, 32): "5c83b33b0bc08bd4", (7, 2048, 256): "02789c0a65214734",
    (7, 2048, 1024): "af934101498404a6"}


@pytest.mark.parametrize("batch", [32, 256, 1024])
@pytest.mark.parametrize("hw,cin,cm,cout,proj", K3_SHAPES)
def test_bottleneck_launch_plans_at_vgg_shapes_unchanged(hw, cin, cm, cout,
                                                         proj, batch):
    import hashlib

    plan = resblock.launch_plan(batch, hw, hw, cin, cm, cout, proj, 132)
    digest = hashlib.sha256(repr(tuple(plan)).encode()).hexdigest()[:16]
    assert digest == VGG_K3_PLANS[(hw, cin, batch)]


@pytest.mark.parametrize("hw,cin,cm,cout,proj", RETINA_K3_SHAPES[1:])
def test_bottleneck_flat_row_3x3_at_retinaface_tiles(hw, cin, cm, cout,
                                                     proj):
    """The flat-row 3x3 at the detector's tiles equals a SAME convolution
    (one image, 4 channels, float64)."""
    t = resblock.launch_plan(256, hw, hw, cin, cm, cout, proj).tile
    g = torch.Generator().manual_seed(hw)
    y = torch.randn((1, hw, hw, 4), generator=g, dtype=torch.float64)
    w3 = torch.randn((3, 3, 4, 3), generator=g, dtype=torch.float64)
    got = _flat_row_3x3(y, w3, t.th, t.tw)
    want = torch.nn.functional.conv2d(
        y.permute(0, 3, 1, 2), w3.permute(3, 2, 0, 1),
        padding=1).permute(0, 2, 3, 1)
    assert not got.isnan().any()
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("hw,cin,cm,cout,proj", K3_SHAPES)
def test_bottleneck_flat_row_3x3_equals_same_conv(hw, cin, cm, cout, proj):
    """The tile's flat-row 3x3 (tap offsets on the row stride tw + 2, the
    dropped columns, the zero halo) at the tile ``launch_plan`` picks for
    each VGGFace shape equals a SAME 3x3 convolution, on small random
    inputs of that image size (4 channels) in float64; rows that only
    dropped outputs read hold NaN and none reaches the result."""
    t = resblock.launch_plan(32, hw, hw, cin, cm, cout, proj).tile
    g = torch.Generator().manual_seed(hw)
    y = torch.randn((2, hw, hw, 4), generator=g, dtype=torch.float64)
    w3 = torch.randn((3, 3, 4, 3), generator=g, dtype=torch.float64)
    got = _flat_row_3x3(y, w3, t.th, t.tw)
    want = torch.nn.functional.conv2d(
        y.permute(0, 3, 1, 2), w3.permute(3, 2, 0, 1),
        padding=1).permute(0, 2, 3, 1)
    assert not got.isnan().any()
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_bottleneck_kernel_refuses_unpacked_weights():
    wts = resblock.kernel_weights(_k3_weights(64, 64, 256, True, 0),
                                  torch.device("cpu"))
    resblock._check_packed(wts, torch.device("cpu"))
    with pytest.raises(ValueError, match="kernel_weights"):
        resblock._check_packed(wts._replace(packed=None), torch.device("cpu"))
    bad = wts.packed._replace(w2=wts.packed.w2[:1].contiguous())
    with pytest.raises(ValueError, match="packed w2"):
        resblock._check_packed(wts._replace(packed=bad), torch.device("cpu"))
    # Widths the kernel does not tile run zero-padded (packed at the padded
    # widths), a Cm that pads past 512 too (y1 and y2 in global scratch).
    odd = resblock.kernel_weights(_k3_weights(32, 16, 64, True, 1),
                                  torch.device("cpu"))
    assert odd.packed is not None and resblock.kernel_takes(32, 16, 64)
    resblock._check_packed(odd, torch.device("cpu"))
    assert odd.packed.w1.shape == (1, 4, 8, 2, 8, 8)
    assert resblock.kernel_takes(96, 64, 64)
    assert resblock.kernel_takes(128, 512, 64)
    assert resblock.kernel_takes(64, 513, 256)
    assert not resblock.kernel_takes(0, 64, 64)
    wide = resblock.kernel_weights(_k3_weights(64, 576, 64, True, 2),
                                   torch.device("cpu"))
    resblock._check_packed(wide, torch.device("cpu"))
    assert wide.vecs.s1.shape == (640,)


# -- K1 ----------------------------------------------------------------------

# (D, head widths, head kind): the DFW head over ArcFace embeddings and over
# VGGFace features, the SmallRes-sized head, a sigmoid head, a wide H1 and
# an H2 that narrows the pass.
K1_HEADS = [(512, (512, 64), "softmax"), (2048, (512, 64), "softmax"),
            (512, (128, 32), "softmax"), (100, (512, 64), "sigmoid"),
            (2048, (1024, 64), "softmax"), (96, (300, 200), "sigmoid")]
# (N, M, D): the serving grid, a ragged one, the training one.
K1_GRIDS = [(1000, 1000, 512), (37, 53, 100), (300, 300, 2048)]
# (np1, h2p) pairs csrc/pair_score.cu is built for (ALINK_PAIR_LAUNCH).
K1_BUILT = {(256, 32), (256, 64), (128, 32), (128, 64), (128, 128), (64, 256)}


def _head(d, widths, kind, seed=0):
    return SiameseHead(d, widths, head=kind, dtype=torch.float32,
                       generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("d,widths,kind", K1_HEADS)
def test_pack_head_round_trips(d, widths, kind):
    """``pack_head`` holds the head's weights, bf16-rounded, in the layout
    the kernel stages; ``unpack_head`` gives back ``head_weights``.  A
    sigmoid head's output enters as [0, logit]."""
    head = _head(d, widths, kind)
    p = pairwise.pack_head(head)
    np1, h2p, h1p = pairwise.head_tiling(*widths)
    assert (p.np1, p.h2p) in K1_BUILT and h1p % np1 == 0
    assert p.w1.shape == (h1p // np1, -(-d // 64), 4, np1 // 8, 2, 8, 8)
    assert p.w2.shape == (h1p // np1, np1 // 16, h2p // 8, 2, 8, 8)
    assert p.w1.dtype == p.w2.dtype == torch.bfloat16
    assert all(t.is_contiguous() for t in p[:6])
    # Slab k, slice s, column group gr, half hf, row r, element e holds
    # W1[64 k + 16 s + _K_PERM[8 hf + e], np1 pass + 8 gr + r].
    w1 = head.hidden[0].weight.t().detach()
    q, k, s, gr, hf, r, e = 0, 1 % p.w1.shape[1], 2, 3, 1, 5, 6
    row = 64 * k + 16 * s + pairwise._K_PERM[8 * hf + e]
    if row < d:
        assert p.w1[q, k, s, gr, hf, r, e] == w1[row, 8 * gr + r].to(
            torch.bfloat16)
    for (w, b), (wh, bh) in zip(pairwise.unpack_head(p),
                                pairwise.head_weights(head)):
        assert torch.equal(w, wh.detach().to(torch.bfloat16).float())
        assert torch.equal(b, bh.detach().float())
    # Padding is zeros: columns past H1 and H2, rows past D.
    assert not p.b1[widths[0]:].any() and not p.b2[widths[1]:].any()
    assert not p.wo[widths[1]:].any()


def test_packed_head_follows_in_place_training():
    """The packed copy is cached on the head, keyed on each parameter's
    identity and version: an optimizer step repacks, and the next score
    through the packed weights follows the plain version's; moving the
    module or loading a state drops the cache."""
    head = _head(48, (64, 32), "softmax", seed=3)
    rng = np.random.default_rng(3)
    rows = torch.from_numpy(rng.normal(size=(7, 48)).astype(np.float32))
    cols = torch.from_numpy(rng.normal(size=(9, 48)).astype(np.float32))

    def packed_scores():
        layers = pairwise.unpack_head(pairwise.packed_head(head, "cpu"))
        return pairwise._apply_head(torch.abs(rows[:, None] - cols[None]),
                                    layers)

    p0 = pairwise.packed_head(head, "cpu")
    assert pairwise.packed_head(head, "cpu") is p0       # cached
    before = packed_scores()
    assert torch.equal(before, pairwise.score_matrix_reference(head, rows,
                                                               cols))
    opt = torch.optim.SGD(head.parameters(), lr=0.5)
    loss = head(rows, cols[:7])[:, 1].sum()
    loss.backward()
    opt.step()
    assert pairwise.packed_head(head, "cpu") is not p0
    after = packed_scores()
    assert not torch.equal(after, before)
    assert torch.equal(after, pairwise.score_matrix_reference(head, rows,
                                                              cols))
    p1 = pairwise.packed_head(head, "cpu")
    head.load_state_dict(_head(48, (64, 32), "softmax", seed=4).state_dict())
    assert head._packed is None
    assert pairwise.packed_head(head, "cpu") is not p1
    head.to(torch.float32)
    assert head._packed is None


def _k1_entry_checks(plan, n, m, d):
    """The checks of ``alink_pair_score`` (csrc/pair_score.cu) on a plan."""
    assert d > 0 and d % 4 == 0 and n > 0 and m > 0
    assert (plan.np1, plan.h2p) in K1_BUILT
    assert plan.h1p > 0 and plan.h1p % plan.np1 == 0
    assert 2 <= plan.stages <= 8 and plan.group >= 1
    assert plan.tiles_i == -(-n // 8) and plan.tiles_j == -(-m // 16)
    assert 1 <= plan.grid <= plan.tiles_i * plan.tiles_j
    assert plan.stage_bytes % 1024 == 0
    # Ring, scores, barriers and, with 256-wide passes, the layer-2
    # accumulator's stash (256 threads x h2p / 2 f32).
    stash = 256 * plan.h2p * 2 if plan.np1 == 256 else 0
    assert plan.smem == plan.stages * plan.stage_bytes + 512 + 128 + stash
    assert plan.smem <= 232448
    # The kernel's stage holds a slab of both feature tiles and of W1's
    # pass, or one pass of W2.
    assert plan.stage_bytes >= max(6144 + plan.np1 * 128,
                                   plan.np1 * plan.h2p * 2)
    # Two accumulators a consumer thread, within its 232 registers.
    assert plan.np1 // 2 + plan.h2p // 2 <= 160


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n,m,d", K1_GRIDS)
def test_pair_score_launch_plan_covers_each_pair_once(n, m, d, sms):
    """Block b walks tiles b, b + grid, ...: every 8 x 16 tile once, so
    every pair once; every copy the producer starts (W1 slabs, W2 passes,
    feature boxes) and every bias and output-layer read lies inside its
    tensor."""
    h1, h2 = (512, 64) if d != 2048 else (1024, 64)
    plan = pairwise.launch_plan(n, m, d, h1, h2, sms)
    assert plan.grid == min(plan.tiles, sms)
    hits = torch.zeros(plan.tiles_i * 8, plan.tiles_j * 16, dtype=torch.int64)
    for b in range(plan.grid):
        for t in range(b, plan.tiles, plan.grid):
            ti, tj = pairwise.tile_coords(plan, t)
            assert 0 <= ti < plan.tiles_i and 0 <= tj < plan.tiles_j
            hits[8 * ti:8 * ti + 8, 16 * tj:16 * tj + 16] += 1
    assert bool((hits == 1).all())
    # Reads: W1 slab (pass p, slab k) and W2 pass p, in elements.
    w1_numel = plan.passes * plan.nslab * plan.np1 * 64
    w2_numel = plan.passes * plan.np1 * plan.h2p
    p, k = plan.passes - 1, plan.nslab - 1
    assert (p * plan.nslab + k) * plan.np1 * 64 + plan.np1 * 64 == w1_numel
    assert p * plan.np1 * plan.h2p + plan.np1 * plan.h2p == w2_numel
    packed = pairwise.pack_head(_head(d, (h1, h2), "softmax"))
    assert packed.w1.numel() == w1_numel and packed.w2.numel() == w2_numel
    # Feature boxes start inside the padded slab range and at a tile's rows.
    assert (plan.nslab - 1) * 64 + 32 < plan.dp and plan.dp - d < 64
    assert (plan.tiles_i - 1) * 8 < n and (plan.tiles_j - 1) * 16 < m
    # b1 (pass, column pair), b2 and wo (2 per H2 column) reads.
    assert plan.passes * plan.np1 == plan.h1p == packed.b1.numel()
    assert packed.b2.numel() == plan.h2p and packed.wo.numel() == 2 * plan.h2p


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n,m,d", K1_GRIDS)
def test_pair_score_launch_plan_passes_the_entry_points_checks(n, m, d, sms):
    for h1, h2 in ((512, 64), (128, 32), (1024, 64), (300, 200)):
        _k1_entry_checks(pairwise.launch_plan(n, m, d, h1, h2, sms), n, m, d)


def test_pair_score_head_tiling_limits():
    """Any H1 (passes); H2 up to 256, a wide H2 narrowing the pass."""
    assert pairwise.head_tiling(512, 64) == (256, 64, 512)
    assert pairwise.head_tiling(128, 32) == (128, 32, 128)
    assert pairwise.head_tiling(4096, 64) == (256, 64, 4096)
    assert pairwise.head_tiling(512, 256) == (64, 256, 512)
    assert pairwise.head_tiling(300, 100) == (128, 128, 384)
    with pytest.raises(ValueError, match="H2"):
        pairwise.head_tiling(512, 257)


# Heads wider than 256 in H2: a launch per chunk of at most 256 columns.
K1_WIDE = [(320, (0, 256, 320)), (512, (0, 256, 512)),
           (1024, (0, 256, 512, 768, 1024))]


def _biased_head(d, widths, kind, seed):
    """``_head`` with random non-zero biases."""
    head = _head(d, widths, kind, seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for lin in (*head.hidden, head.out):
            lin.bias.copy_(torch.randn(lin.bias.shape, generator=g) * 0.1)
    return head


@pytest.mark.parametrize("h2,edges", K1_WIDE)
def test_pair_score_h2_chunks_cover_each_column_once(h2, edges):
    """``head_chunks`` cuts H2 into launches of at most 256 columns that
    cover every output column once; the modes are first, middle..., last;
    each chunk's plan is one the entry point takes; the packed chunks
    round-trip to the head's weights, the output bias in the first."""
    chunks = pairwise.head_chunks(h2)
    assert [c0 for c0, _ in chunks] + [chunks[-1][1]] == list(edges)
    cover = torch.zeros(h2, dtype=torch.int64)
    for c0, c1 in chunks:
        assert 0 < c1 - c0 <= 256
        cover[c0:c1] += 1
    assert bool((cover == 1).all())
    modes = [pairwise.chunk_mode(k, len(chunks)) for k in range(len(chunks))]
    assert modes == [1] + [2] * (len(chunks) - 2) + [3]
    assert pairwise.head_chunks(64) == ((0, 64),)
    assert pairwise.chunk_mode(0, 1) == 0
    head = _biased_head(96, (300, h2), "softmax", seed=h2)
    packed = pairwise.packed_head(head, "cpu")
    assert len(packed) == len(chunks)
    for (c0, c1), pk in zip(chunks, packed):
        assert pk.h2 == c1 - c0 and (pk.np1, pk.h2p) in K1_BUILT
        assert bool(pk.bo.any()) == (c0 == 0)
        for n, m, d in K1_GRIDS:
            _k1_entry_checks(pairwise.launch_plan(n, m, d, pk.h1, pk.h2),
                             n, m, d)
    for (w, b), (wh, bh) in zip(pairwise.unpack_head(packed),
                                pairwise.head_weights(head)):
        assert torch.equal(w, wh.detach().to(torch.bfloat16).float())
        assert torch.equal(b, bh.detach().float())


@pytest.mark.parametrize("kind", ["softmax", "sigmoid"])
@pytest.mark.parametrize("h2,edges", K1_WIDE)
def test_pair_score_chunks_sum_to_unchunked_logits(h2, edges, kind):
    """The chunks' logit differences, each from its packed weights on the
    plain arithmetic, the output bias in the first only, sum to the whole
    head's logit difference (f32 sums in another order: 1e-5 of the
    largest), and their sigmoid gives the plain scorer's scores."""
    head = _biased_head(64, (128, h2), kind, seed=h2 + 1)
    rng = np.random.default_rng(h2)
    rows = torch.from_numpy(rng.normal(size=(9, 64)).astype(np.float32))
    cols = torch.from_numpy(rng.normal(size=(11, 64)).astype(np.float32))
    x = torch.abs(rows[:, None] - cols[None])

    def logit_diff(layers):
        h = x
        for w, b in layers[:-1]:
            h = torch.relu(pairwise._bf16(h) @ pairwise._bf16(w) + b)
        wo, bo = layers[-1]
        lg = pairwise._bf16(h) @ pairwise._bf16(wo) + bo
        return lg[..., 1] - lg[..., 0]

    with torch.no_grad():
        whole = logit_diff(tuple((w.detach().float(), b.detach().float())
                                 for w, b in pairwise.head_weights(head)))
        parts = sum(logit_diff(pairwise.unpack_head(pk))
                    for pk in pairwise.packed_head(head, "cpu"))
        want = pairwise.score_matrix_reference(head, rows, cols)
    assert float((parts - whole).abs().max()) <= 1e-5 * float(
        whole.abs().max())
    assert float((torch.sigmoid(parts) - want).abs().max()) <= 1e-6


# -- K2 ----------------------------------------------------------------------

def _kernel_inverse(Ms: np.ndarray) -> np.ndarray:
    """Python mirror of csrc/affine_warp.cu's block prologue: the inverse
    map of each forward affine [a b bx; c d by] in f32, op by op:
    det = a*d - b*c (two rounded products, a rounded difference), then
    d/det, -b/det, -c/det, a/det (IEEE divisions)."""
    m = Ms.reshape(-1, 6).astype(np.float32)
    a, b, bx, c, d, by = (m[:, i] for i in range(6))
    with np.errstate(all="ignore"):
        det = np.float32(a * d) - np.float32(b * c)
        return np.stack([d / det, -b / det, -c / det, a / det, bx, by], 1)


def test_warp_kernel_inverse_mirror_matches_warp_params():
    """The kernel derives the inverse the plain version computes with
    ``_warp_params``, bit for bit: near-identity and similarity transforms,
    tiny and huge scales, and singular ones (0/0 -> NaN, x/0 -> inf)."""
    rng = np.random.default_rng(5)
    s = rng.uniform(0.5, 1.6, 200)
    th = rng.uniform(-np.pi, np.pi, 200)
    Ms = np.stack([np.stack([s * np.cos(th), -s * np.sin(th),
                             rng.uniform(-80, 80, 200)], -1),
                   np.stack([s * np.sin(th), s * np.cos(th),
                             rng.uniform(-80, 80, 200)], -1)], 1)
    Ms = np.concatenate([Ms, rng.normal(size=(50, 2, 3)) * 1e-3,
                         rng.normal(size=(50, 2, 3)) * 1e3, np.array([
                             [[0.0, 0.0, 56.0], [0.0, 0.0, 60.0]],
                             [[1.0, 1.0, 0.0], [1.0, 1.0, 10.0]],
                             [[2.0, -4.0, 1.0], [-1.0, 2.0, 3.0]],
                             [[0.01, 0.0, 50.0], [0.0, 0.01, 50.0]],
                             [[-1.0, 0.0, 111.0], [0.0, 1.0, 0.0]]])])
    Ms = Ms.astype(np.float32)
    want = image._warp_params(torch.from_numpy(Ms)).numpy()
    got = _kernel_inverse(Ms)
    assert got.shape == want.shape == (len(Ms), 6)
    nan = np.isnan(want)
    assert np.array_equal(nan, np.isnan(got)) and nan[-5, :4].all()
    assert np.isinf(want[-4, :4]).all() and np.isinf(want[-3, :4]).all()
    assert np.array_equal(got[~nan].view(np.uint32),
                          want[~nan].view(np.uint32))


# bf16 photos against the JAX warp, which computes in bf16: its tap weights
# are rounded to bf16 (at most 0.5 on the 0-255 scale), both round the
# result to bf16 (a step of 1.0 between 128 and 256), so the two may differ
# by that step plus the weights' rounding: 1.5, the JAX package's own warp
# budget (tests/test_geometry.py:419).  The nearest interpolation has
# one-hot weights on both sides and must agree exactly.
K2_BF16_LIMIT = 1.5


@pytest.mark.parametrize("interp", ["linear", "nearest"])
@pytest.mark.parametrize("border", ["zero", "nearest"])
def test_warp_plain_bf16_matches_jax(border, interp):
    """The plain version (the kernel's reference on the card) warps bf16
    images as JAX's ``affine_warp_batch`` does, within K2_BF16_LIMIT, and
    returns bf16."""
    import jax.numpy as jnp

    from alink_tpu.ops import image as jimage

    rng = np.random.default_rng(21)
    imgs = rng.uniform(0, 255, (3, 40, 48, 3)).astype(np.float32)
    s = rng.uniform(0.7, 1.3, 3)
    th = rng.uniform(-0.5, 0.5, 3)
    Ms = np.stack([np.stack([s * np.cos(th), -s * np.sin(th),
                             rng.uniform(-5, 15, 3)], -1),
                   np.stack([s * np.sin(th), s * np.cos(th),
                             rng.uniform(-5, 15, 3)], -1)], 1)
    Ms = Ms.astype(np.float32)
    jb = jnp.asarray(imgs).astype(jnp.bfloat16)
    want = np.asarray(jimage.affine_warp_batch(
        jb, jnp.asarray(Ms), (32, 36), border=border, interp=interp
    ).astype(jnp.float32))
    tb = torch.from_numpy(np.asarray(jb.astype(jnp.float32))).to(
        torch.bfloat16)
    got = image.affine_warp_batch_reference(tb, torch.from_numpy(Ms),
                                            (32, 36), border, interp)
    assert got.dtype == torch.bfloat16 and got.shape == (3, 32, 36, 3)
    diff = np.abs(got.float().numpy() - want)
    limit = K2_BF16_LIMIT if interp == "linear" else 0.0
    assert diff.max() <= limit
    assert diff.mean() < 0.1
