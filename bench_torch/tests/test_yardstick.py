"""CPU self-checks of the yardstick: operation and byte counts against
hand-computed values, percentiles and whole-window rates, the Poisson
schedule, and that nothing of the benchmark imports JAX or the JAX
package.

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import math
import re
import statistics
from pathlib import Path

import pytest

from bench_torch import roofline as R
from bench_torch import stats

BENCH = Path(__file__).resolve().parents[1]


def test_arcface_r100_flops_at_112():
    c3 = lambda r, a, b: 2 * r * r * a * b * 9  # noqa: E731
    c1 = lambda r, a, b: 2 * r * r * a * b      # noqa: E731
    hand = (c3(112, 3, 64)
            + c3(112, 64, 64) + c3(56, 64, 64) + c1(56, 64, 64)
            + 2 * 2 * c3(56, 64, 64)
            + c3(56, 64, 128) + c3(28, 128, 128) + c1(28, 64, 128)
            + 12 * 2 * c3(28, 128, 128)
            + c3(28, 128, 256) + c3(14, 256, 256) + c1(14, 128, 256)
            + 29 * 2 * c3(14, 256, 256)
            + c3(14, 256, 512) + c3(7, 512, 512) + c1(7, 256, 512)
            + 2 * 2 * c3(7, 512, 512)
            + 2 * 512 * 7 * 7 * 512)
    assert hand == 24_179_212_288
    assert R.arcface_flops() == hand


def test_vggface2_r50_flops_at_224():
    def block(r, cin, f, proj):
        return 2 * r * r * (cin * f + 9 * f * f + f * 4 * f
                            + (cin * 4 * f if proj else 0))

    hand = (2 * 112 * 112 * 3 * 64 * 49
            + block(55, 64, 64, True) + 2 * block(55, 256, 64, False)
            + block(28, 256, 128, True) + 3 * block(28, 512, 128, False)
            + block(14, 512, 256, True) + 5 * block(14, 1024, 256, False)
            + block(7, 1024, 512, True) + 2 * block(7, 2048, 512, False))
    assert hand == 7_664_566_272
    assert R.vgg_r50_flops() == hand


def test_k3_block_shapes_and_flops():
    blocks = R.vgg_stride1_blocks()
    assert len(blocks) == 13
    assert sorted(set(blocks)) == sorted({
        (55, 64, 64, 256, True), (55, 256, 64, 256, False),
        (28, 512, 128, 512, False), (14, 1024, 256, 1024, False),
        (7, 2048, 512, 2048, False)})
    # 2 * n * hw^2 * (cin cm + 9 cm^2 + cm cout [+ cin cout]) at batch 32
    assert R.k3_flops(32, 55, 64, 64, 256, True) == \
        2 * 32 * 3025 * (4096 + 36864 + 16384 + 16384)
    assert R.k3_flops(32, 7, 2048, 512, 2048, False) == \
        2 * 32 * 49 * (1048576 + 2359296 + 1048576)


def test_k2_bytes_and_bound():
    n = R.k2_bytes(64, 160, 160, 3, 112, 112)
    assert n == 64 * 160 * 160 * 3 * 4 + 64 * 112 * 112 * 3 * 4 == 29_294_592
    bound, by = R.bound_s(R.k2_flops(64, 112, 112, 3), R.H100_F32_TFLOPS, n)
    assert by == "bytes"
    assert bound == pytest.approx(29_294_592 / 3.35e12)


def test_cascade_counts():
    assert R.pyramid_sizes(160, 160, 40, 0.709) == [
        (48, 48), (35, 35), (25, 25), (18, 18), (13, 13)]
    # R-Net: 22x22x28 <- 3x3x3, 9x9x48 <- 3x3x28, 3x3x64 <- 2x2x48,
    # 576 -> 128 -> 6.
    assert R.rnet_flops() == 2 * (22 * 22 * 28 * 27 + 81 * 48 * 252
                                  + 9 * 64 * 192 + 576 * 128 + 128 * 6)


def test_percentile_and_rate():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile(xs, 50) == pytest.approx(50.5)
    assert stats.percentile([3.0], 95) == 3.0
    # A failed request counts as later than any limit.
    assert stats.percentile(xs[:99] + [math.inf], 100) == math.inf
    assert stats.percentile(xs[:95] + [math.inf] * 5, 95) == math.inf
    assert stats.rate(640, 0.32) == pytest.approx(2000.0)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_spread():
    xs = [1, 2, 3, 4, 5, 6]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / q2) == 1.0
    assert stats.spread_without_farthest([10, 10, 10, 11, 10, 100]) == \
        stats.spread([10, 10, 10, 11, 10])


def test_poisson_schedule_from_a_seed():
    a = stats.poisson_gaps(200.0, 2400, 5)
    b = stats.poisson_gaps(200.0, 2400, 5)
    c = stats.poisson_gaps(200.0, 2400, 6)
    assert a == b                               # the same seed, the same
    assert a != c and sorted(a) == sorted(c)    # same gaps, another order
    assert len(a) == 2400
    assert sum(a) / len(a) == pytest.approx(1 / 200.0, rel=0.01)
    # the exponential's median gap: ln 2 / rate
    assert statistics.median(a) == pytest.approx(math.log(2) / 200.0,
                                                 rel=0.01)


def test_nothing_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|alink_tpu|benchmarks)\b"
                     r"(?!_torch)", re.M)
    hits = [str(p) for p in BENCH.rglob("*.py") if pat.search(p.read_text())]
    assert hits == []
