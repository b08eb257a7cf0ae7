"""Time kernels K1 (fused all-pairs scorer), K2 (alignment warp), K3 (fused
bottleneck) and K4 (int8 3x3 conv) on the card at the shapes their paths
give them.

    python -m alink_tpu_torch.tools.bench_kernels        # ~2 min on one H100
    python -m alink_tpu_torch.tools.bench_kernels --compare PARENT_TREE

Prints, per shape (last line JSON):

- K1 under the DFW head (512, 64) at 1000 x 1000 pairs of 512-d features
  (serving: ArcFace embeddings) and of 2,048-d ones (training: VGGFace
  features), then the 7,771 x 7,771 x 2,048 DFW evaluation grid once;
- K2 warping 64 photos of 160 x 160 x 3 to 112 x 112 chips (f32), as
  ``align_faces`` does at batch 64;
- K3 at the five stride-1 block shapes of VGGFace-ResNet50 at 224x224, at
  batch 32 (``chip_smoke.py`` (e)'s batch) and 256 (``featurize_stacks``
  and the one-pixel DE's ``EVAL_BATCH``): the kernel's launch alone
  (weights from ``kernel_weights``) and, as a reference only, the same
  block as an unfused bf16 cuDNN sequence (``unfused_block``: three or
  four ``F.conv2d`` calls plus the elementwise BN, ReLU and add);
- K4 at LResNet100E-II's five stage shapes, batch 64: the kernel's launch
  on operands already packed, the op path ``conv3x3_s1_int8`` (NHWC in and
  out, packing included) and bf16 ``F.conv2d`` on the same integer data.

All times are CUDA-event means over back-to-back calls after a warm-up,
in windows of at least 25 ms (``cuda_ms``).  A kernel's time and the
cuDNN yardsticks are device time per call (``graph_ms``: 20 calls
captured in one CUDA graph and replayed, each capture checked to have
run the work); the time per call from Python, the wrapper's host work
included, is printed beside the kernel's (``kernel_ms`` gives both).
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch
import torch.nn.functional as F

SEED = 0
# (H, Cin, Cm, Cout, projection, blocks of this shape in one forward)
K3_SHAPES = ((55, 64, 64, 256, True, 1), (55, 256, 64, 256, False, 2),
             (28, 512, 128, 512, False, 3), (14, 1024, 256, 1024, False, 5),
             (7, 2048, 512, 2048, False, 2))
K3_BATCHES = (32, 256)
# (H, Cin, Cout) at batch 64 (benchmarks/bench_qconv.py:57-59)
K4_SHAPES = ((56, 64, 64), (28, 128, 128), (14, 256, 256), (7, 512, 512),
             (14, 512, 512))
K4_BATCH = 64
# K1: (N, M, D) under the DFW head; the DFW evaluation grid.
K1_SHAPES = ((1000, 1000, 512), (1000, 1000, 2048))
K1_HEAD = (512, 64)
K1_DFW = (7771, 7771, 2048)
# K2: batch, photo side, channels, chip side.
K2_SHAPE = (64, 160, 3, 112)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3,
            min_window_ms: float = 25.0) -> float:
    """Mean milliseconds per call from CUDA events around back-to-back
    calls after ``warmup`` calls: at least ``iters`` calls in a window of
    at least ``min_window_ms``, lengthening the window (the shorter ones
    only warm the card's clocks up) so that a kernel of a few microseconds
    is not timed over a fraction of a millisecond."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    n = iters
    while True:
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        if ms >= min_window_ms or n >= 20000:
            return ms / n
        n = min(20000, max(2 * n, int(1.2 * n * min_window_ms / max(ms, 1e-3))))


def _same(got: torch.Tensor, want: torch.Tensor, exact: bool) -> bool:
    if exact:
        return torch.equal(got, want)
    got, want = got.float(), want.float()
    return bool(torch.isfinite(got).all()) and float(
        (got - want).abs().max()) <= 1e-2 * float(want.abs().max())


def graph_ms(fn, calls: int = 20, counter: str | None = None,
             exact: bool = True, per_call: int = 1) -> float:
    """Device milliseconds per call: ``calls`` calls of ``fn`` (which returns
    a tensor) captured in one CUDA graph and replayed back to back
    (``cuda_ms`` around the replay), so that the host's work per call (the
    wrapper's checks, the ctypes launch) is not timed, only the kernels and
    the gaps between them.

    Raises unless the graph runs the work: the launch counter ``counter``
    of ``utils.profiling.counters`` (e.g. ``"launches.k3"``) must rise by
    ``per_call`` x ``calls`` during the capture (``per_call``: the
    launches of one call, e.g. a chain of blocks or a head in H2 chunks),
    and one replay must rewrite the last call's output, filled with a
    sentinel first, to what an eager call gives (bit-equal when ``exact``,
    else within 1e-2 of its largest magnitude).  ``counters()`` is read
    before and after the capture: the trees ``--compare`` runs this file
    on may lack ``profiling.counting``."""
    from alink_tpu_torch.utils.profiling import counters

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            want = fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    want = want.clone()
    graph = torch.cuda.CUDAGraph()
    before = counters()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            got = fn()
    if counter is not None:
        launched = counters()[counter] - before[counter]
        if launched != per_call * calls:
            raise RuntimeError(f"graph_ms: {counter} rose by {launched} in "
                               f"a capture of {calls} calls of {per_call}")
    got.fill_(float("nan") if got.is_floating_point() else 77)
    graph.replay()
    torch.cuda.synchronize()
    if not _same(got, want, exact):
        raise RuntimeError("graph_ms: the replayed graph did not compute "
                           "what an eager call computes")
    ms = cuda_ms(graph.replay, iters=3, warmup=2) / calls
    del graph, got
    return ms


def kernel_ms(fn, counter: str, calls: int = 20,
              per_call: int = 1) -> tuple[float, float]:
    """(device ms per call, ``graph_ms`` over ``calls`` captured calls; ms
    per call from Python, ``cuda_ms``) of a kernel wrapper's call ``fn``
    that launches the kernel of launch counter ``counter``.
    Raises where the device time is below a hundredth of the time per call
    from Python, which no kernel launched from Python reaches: a capture
    that timed nothing."""
    ms = graph_ms(fn, calls=calls, counter=counter, per_call=per_call)
    call = cuda_ms(fn, iters=calls, warmup=min(3, calls))
    if ms * 100 < call:
        raise RuntimeError(f"kernel_ms: {counter} {ms:.6f} ms on the "
                           f"device against {call:.4f} ms per call")
    return ms, call


def bench_k1(dev, dfw: bool = False) -> dict:
    """K1's launch under the DFW head (512, 64), weights packed once, at
    ``K1_SHAPES`` on seeded normal features; with ``dfw``, the DFW grid
    too, its device time over one captured call."""
    from alink_tpu_torch.models import SiameseHead
    from alink_tpu_torch.ops import pairwise

    g = torch.Generator().manual_seed(SEED)
    k1 = pairwise.score_matrix_kernel
    shapes = K1_SHAPES + ((K1_DFW,) if dfw else ())
    rows = []
    for n, m, d in shapes:
        head = SiameseHead(d, K1_HEAD, generator=g, device=dev)
        left = torch.randn((n, d), generator=g).to(dev)
        right = torch.randn((m, d), generator=g).to(dev)
        ms, call = kernel_ms(lambda: k1(head, left, right), "launches.k1",
                             calls=1 if (n, m, d) == K1_DFW else 20)
        ops = 2.0 * n * m * (d * K1_HEAD[0] + K1_HEAD[0] * K1_HEAD[1])
        print(f"K1 {n}x{m}x{d} head {K1_HEAD}: kernel {ms:.4f} ms "
              f"({call:.4f} per call from Python; {ops / ms / 1e9:.1f} "
              "TFLOP/s in the two hidden layers)", flush=True)
        rows.append({"shape": f"{n}x{m}x{d}", "ms": ms, "call_ms": call})
        del left, right
    torch.cuda.empty_cache()
    return {"shapes": rows}


def k2_case(dev, g=None):
    """Seeded photos (uniform 0-255 f32) and similarity transforms that
    map a face of 0.7-1.1 x the chip's scale, turned by up to 0.35 rad,
    into the chip."""
    n, side, c, chip = K2_SHAPE
    g = g or torch.Generator().manual_seed(SEED)
    imgs = (torch.rand((n, side, side, c), generator=g) * 255).to(dev)
    s = torch.rand(n, generator=g) * 0.4 + 0.7
    th = (torch.rand(n, generator=g) - 0.5) * 0.7
    a, b = s * torch.cos(th), s * torch.sin(th)
    # chip centre <- photo centre (plus jitter)
    cx = side / 2 + (torch.rand(n, generator=g) - 0.5) * 20
    cy = side / 2 + (torch.rand(n, generator=g) - 0.5) * 20
    tx = chip / 2 - (a * cx - b * cy)
    ty = chip / 2 - (b * cx + a * cy)
    Ms = torch.stack([torch.stack([a, -b, tx], -1),
                      torch.stack([b, a, ty], -1)], 1)
    return imgs, Ms.to(dev).contiguous(), (chip, chip)


def bench_k2(dev) -> dict:
    """K2's launch at ``K2_SHAPE``, f32: device time and time per call."""
    from alink_tpu_torch.ops import image

    imgs, Ms, size = k2_case(dev)
    k2 = image.affine_warp_batch_kernel
    ms, call = kernel_ms(lambda: k2(imgs, Ms, size), "launches.k2")
    n, side, c, chip = K2_SHAPE
    print(f"K2 {n}x{side}x{side}x{c} -> {chip}x{chip} f32: kernel {ms:.4f} ms "
          f"({call:.4f} per call from Python)", flush=True)
    return {"ms": ms, "call_ms": call}


_TURN = """
import importlib.util, json, sys
sys.path.insert(0, {root!r})
spec = importlib.util.spec_from_file_location("bench_turn", {this!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
import torch
dev = torch.device("cuda:0")
print("TURN " + json.dumps({{"k1": mod.bench_k1(dev), "k2": mod.bench_k2(dev)}}),
      flush=True)
"""


def compare(parent: str) -> dict:
    """K1 and K2 of the tree at ``parent`` and of this one, in turns:
    parent, this, this, parent (one fresh interpreter each)."""
    import os
    from pathlib import Path

    this_root = str(Path(__file__).resolve().parents[2])
    turns = []
    for name, root in (("parent", parent), ("change", this_root),
                       ("change", this_root), ("parent", parent)):
        root = str(Path(root).resolve())
        res = subprocess.run(
            [sys.executable, "-c", _TURN.format(root=root,
                                                this=str(Path(__file__)
                                                         .resolve()))],
            cwd=root, env={**os.environ, "PYTHONPATH": root},
            capture_output=True, text=True, check=False)
        sys.stdout.write("".join(f"[{name}] {ln}\n" for ln in
                                 res.stdout.splitlines()
                                 if not ln.startswith("TURN ")))
        if res.returncode != 0:
            raise RuntimeError(f"{name} turn failed:\n{res.stderr[-4000:]}")
        line = next(ln for ln in res.stdout.splitlines()
                    if ln.startswith("TURN "))
        turns.append((name, json.loads(line[5:])))
    summary = {}
    for key in ("k1", "k2"):
        for i in range(len(turns[0][1]["k1"]["shapes"]) if key == "k1" else 1):
            label = (turns[0][1]["k1"]["shapes"][i]["shape"] if key == "k1"
                     else "64x160x160x3->112")
            pick = (lambda r: r["k1"]["shapes"][i]) if key == "k1" else \
                (lambda r: r["k2"])
            row = {f: [(name, pick(r)[f]) for name, r in turns]
                   for f in ("ms", "call_ms")}
            summary[f"{key} {label}"] = row
            p = [v for n_, v in row["ms"] if n_ == "parent"]
            c = [v for n_, v in row["ms"] if n_ == "change"]
            print(f"{key.upper()} {label}: device ms parent {p}, change {c} "
                  f"({min(p) / max(c):.2f}x to {max(p) / min(c):.2f}x); per "
                  f"call from Python parent "
                  f"{[v for n_, v in row['call_ms'] if n_ == 'parent']}, "
                  f"change {[v for n_, v in row['call_ms'] if n_ == 'change']}",
                  flush=True)
    return summary


def k3_float_weights(cin, cm, cout, proj, g):
    """Random folded-BN bottleneck weights (f32, CPU, JAX layouts)."""
    from alink_tpu_torch.ops.resblock import BottleneckWeights

    def mat(shape, fan_in):
        return torch.randn(shape, generator=g) * fan_in ** -0.5

    def bn(c):
        return (torch.rand(c, generator=g) + 0.5,
                torch.randn(c, generator=g) * 0.1)

    wts = [mat((cin, cm), cin), *bn(cm), mat((3, 3, cm, cm), 9 * cm),
           *bn(cm), mat((cm, cout), cm), *bn(cout)]
    if proj:
        wts += [mat((cin, cout), cin), *bn(cout)]
    return BottleneckWeights(*wts)


def unfused_block(wts, dev):
    """The bottleneck as bf16 cuDNN convolutions plus elementwise BN, ReLU
    and add on channels-last NCHW views of NHWC tensors: a yardstick for
    K3, not its arithmetic (BN runs in bf16 here)."""
    bf = torch.bfloat16

    def k1x1(m):                       # (in, out) -> (out, in, 1, 1)
        return m.t()[:, :, None, None].to(dev, bf).contiguous(
            memory_format=torch.channels_last)

    def vec(v):
        return v.to(dev, bf)[None, :, None, None]

    w1, w2 = k1x1(wts.w1), k1x1(wts.w2)
    w3 = wts.w3.permute(3, 2, 0, 1).to(dev, bf).contiguous(
        memory_format=torch.channels_last)
    wp = None if wts.wp is None else k1x1(wts.wp)
    s1, b1, s2, b2, s3, b3 = (vec(v) for v in (wts.s1, wts.b1, wts.s2,
                                              wts.b2, wts.s3, wts.b3))
    sp, bp = (None, None) if wp is None else (vec(wts.sp), vec(wts.bp))

    def run(x):                         # x (N, H, W, C) bf16 contiguous
        xc = x.permute(0, 3, 1, 2)
        y = torch.relu(F.conv2d(xc, w1) * s1 + b1)
        y = torch.relu(F.conv2d(y, w3, padding=1) * s2 + b2)
        y = F.conv2d(y, w2) * s3 + b3
        sc = xc if wp is None else F.conv2d(xc, wp) * sp + bp
        return torch.relu(y + sc).permute(0, 2, 3, 1)

    return run


def bench_k3(dev, batches=K3_BATCHES, g=None) -> dict:
    """K3's launch alone and the unfused cuDNN sequence, per shape and
    summed over the 13 blocks of one forward, at each batch."""
    from alink_tpu_torch.ops import resblock

    g = g or torch.Generator().manual_seed(SEED)       # weights
    gd = torch.Generator(device=dev).manual_seed(SEED)  # activations
    out: dict = {}
    for batch in batches:
        rows, ms_fwd, call_fwd, ref_fwd = [], 0.0, 0.0, 0.0
        for hw, cin, cm, cout, proj, count in K3_SHAPES:
            wts = k3_float_weights(cin, cm, cout, proj, g)
            kw = resblock.kernel_weights(wts, dev)
            x = torch.relu(torch.randn((batch, hw, hw, cin), generator=gd,
                                       device=dev)).to(torch.bfloat16)
            ms, call = kernel_ms(
                lambda: resblock.bottleneck_s1_kernel(x, kw), "launches.k3")
            ref = graph_ms(lambda f=unfused_block(wts, dev): f(x),
                           exact=False)
            name = f"{hw}x{hw} {cin}->{cm}->{cout}{' proj' if proj else ''}"
            print(f"K3 {name} batch {batch}: kernel {ms:.4f} ms ({call:.4f} "
                  f"per call from Python), unfused bf16 cuDNN sequence "
                  f"{ref:.4f} ms", flush=True)
            rows.append({"shape": name, "count": count, "ms": ms,
                         "call_ms": call, "unfused_ms": ref})
            ms_fwd += count * ms
            call_fwd += count * call
            ref_fwd += count * ref
            del x, kw
        print(f"K3 13 blocks of one forward, batch {batch}: kernel "
              f"{ms_fwd:.4f} ms ({call_fwd:.4f} per call from Python), "
              f"unfused bf16 cuDNN sequence {ref_fwd:.4f} ms", flush=True)
        out[str(batch)] = {"shapes": rows, "ms": ms_fwd, "call_ms": call_fwd,
                           "unfused_ms": ref_fwd}
    return out


def k4_case(hw, cin, cout, g, dev):
    """Seeded int8 data and weights and f32 vectors for one K4 shape."""
    from alink_tpu_torch.ops import qconv

    x = torch.randint(-127, 128, (K4_BATCH, hw, hw, cin), generator=g,
                      dtype=torch.int8)
    w = torch.randint(-20, 21, (3, 3, cin, cout), generator=g,
                      dtype=torch.int8)

    def vec(lo, hi):
        return (torch.rand(cout, generator=g) * (hi - lo) + lo).to(dev)

    scale, bias = vec(0.001, 0.01), vec(-1.0, 1.0)
    alpha, qs = vec(0.1, 0.4), vec(0.5, 2.0)
    lo = qconv.flat_layout(K4_BATCH, hw, hw)
    return x.to(dev), w.to(dev), scale, bias, alpha, qs, lo


def k4_launch(x, w, scale, bias, alpha, qs, lo):
    """A closure that launches K4 alone on operands prepared here once: the
    flat input and the packed weights."""
    from alink_tpu_torch.ops import qconv

    xf = qconv.nhwc_to_flat(x, lo)
    packed = qconv.pack_conv(w, scale, bias, alpha, qs)
    return lambda: qconv.conv3x3_s1_int8_flat_kernel(xf, packed, lo)


def bench_k4(dev, g=None) -> dict:
    """K4's launch alone, its op path and bf16 ``F.conv2d`` per shape."""
    from alink_tpu_torch.ops import qconv

    g = g or torch.Generator().manual_seed(SEED)
    rows = []
    for hw, cin, cout in K4_SHAPES:
        x, w, scale, bias, alpha, qs, lo = k4_case(hw, cin, cout, g, dev)
        ms, call = kernel_ms(k4_launch(x, w, scale, bias, alpha, qs, lo),
                             "launches.k4")
        op = cuda_ms(lambda: qconv.conv3x3_s1_int8(x, w, scale, bias))
        xc = x.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        wc = w.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        lib = graph_ms(lambda: F.conv2d(xc, wc, padding=1), exact=False)
        name = f"{hw}x{hw} {cin}->{cout}"
        print(f"K4 {name} batch {K4_BATCH}: launch {ms:.4f} ms ({call:.4f} "
              f"per call from Python), op path {op:.4f} ms, bf16 F.conv2d "
              f"{lib:.4f} ms", flush=True)
        rows.append({"shape": name, "ms": ms, "call_ms": call, "op_ms": op,
                     "conv2d_ms": lib})
    total = {k: sum(r[k] for r in rows)
             for k in ("ms", "call_ms", "op_ms", "conv2d_ms")}
    print(f"K4 five shapes summed: launch {total['ms']:.4f} ms "
          f"({total['call_ms']:.4f} per call from Python), op path "
          f"{total['op_ms']:.4f} ms, bf16 F.conv2d {total['conv2d_ms']:.4f} "
          "ms", flush=True)
    return {"shapes": rows, **total}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", metavar="PARENT_TREE",
                    help="time K1 and K2 of this tree against another's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    smi = card()
    print(smi, flush=True)
    if args.compare:
        report = {"card": smi, "compare": compare(args.compare)}
    else:
        report = {"card": smi, "k1": bench_k1(dev, dfw=True),
                  "k2": bench_k2(dev), "k3": bench_k3(dev),
                  "k4": bench_k4(dev)}
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
