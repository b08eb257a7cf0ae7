"""The port's int8 flat-layout conv (``ops/qconv.py``, kernel K4's plain
version) against the JAX package, on the CPU.

Tolerances, each with its reason:

- layout helpers (``flat_layout``, ``nhwc_to_flat``, ``add_lead``,
  ``flat_to_nhwc``, ``quantize``): bit-equal;
- the conv against ``conv3x3_s1_int8_reference``: relative 1e-5, the bound
  of ``tests/test_qconv.py`` (both accumulate exactly; XLA may contract
  ``acc * scale + bias`` into one FMA, the port rounds the multiply and the
  add apart);
- the conv against the JAX kernel in interpret mode: the same bound, on
  the rows that hold pixels and on every other row (0 on both sides);
- int8 outputs of ``prelu_quant``: bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alink_tpu.ops import qconv as jq
from alink_tpu_torch.ops import qconv as tq
from alink_tpu_torch.utils.profiling import counting


def _case(shape, seed=0, n=2):
    h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (n, h, w, cin)).astype(np.int8)
    wt = rng.integers(-20, 21, (3, 3, cin, cout)).astype(np.int8)
    scale = rng.uniform(0.001, 0.01, cout).astype(np.float32)
    bias = rng.normal(size=cout).astype(np.float32)
    return x, wt, scale, bias


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("nhw", [(3, 6, 7), (1, 1, 1), (2, 14, 14),
                                 (2, 9, 11)])
def test_layout_helpers_match_jax(nhw):
    n, h, w = nhw
    lo, jlo = tq.flat_layout(n, h, w), jq.flat_layout(n, h, w)
    assert tuple(lo) == tuple(jlo) and lo.rows == jlo.rows
    x = np.random.default_rng(1).integers(-127, 128, (n, h, w, 5)).astype(
        np.int8)
    f = tq.nhwc_to_flat(torch.from_numpy(x), lo)
    jf = jq.nhwc_to_flat(jnp.asarray(x), jlo)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    head = f[lo.lead:]
    np.testing.assert_array_equal(tq.add_lead(head, lo).numpy(),
                                  np.asarray(jq.add_lead(jf[jlo.lead:], jlo)))
    np.testing.assert_array_equal(tq.flat_to_nhwc(head, lo).numpy(),
                                  np.asarray(jq.flat_to_nhwc(jf[jlo.lead:],
                                                             jlo)))
    np.testing.assert_array_equal(tq.flat_to_nhwc(head, lo).numpy(), x)
    v = np.random.default_rng(2).normal(size=(64,)).astype(np.float32) * 3
    np.testing.assert_array_equal(
        tq.quantize(torch.from_numpy(v), 0.02).numpy(),
        np.asarray(jq.quantize(jnp.asarray(v), 0.02)))


def _close(got, want, rtol=1e-5):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("shape", [(5, 5, 8, 16), (9, 11, 4, 4),
                                   (6, 7, 130, 20), (4, 4, 64, 200)])
@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_conv_matches_jax_reference(shape, out):
    x, wt, scale, bias = _case(shape)
    tdt, jdt = ((torch.float32, jnp.float32) if out == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    want = np.asarray(jq.conv3x3_s1_int8_reference(
        *_j(x, wt, scale, bias), out_dtype=jdt).astype(jnp.float32))
    got = tq.conv3x3_s1_int8(*_t(x, wt, scale, bias), out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    # bf16 outputs: 1e-5 of f32 sums can round to the neighbouring bf16.
    _close(got, want, 1e-5 if out == "f32" else 2 ** -8)
    _close(tq.conv3x3_s1_int8_reference(*_t(x, wt, scale, bias),
                                        out_dtype=tdt), want,
           1e-5 if out == "f32" else 2 ** -8)


@pytest.mark.parametrize("shape", [(5, 5, 8, 16), (9, 11, 4, 4)])
@pytest.mark.parametrize("epilogue", ["affine", "prelu_quant"])
def test_flat_conv_matches_jax_kernel_in_interpret_mode(shape, epilogue):
    x, wt, scale, bias = _case(shape, seed=3)
    cout = shape[3]
    rng = np.random.default_rng(4)
    alpha = rng.uniform(0.1, 0.5, cout).astype(np.float32)
    qs = rng.uniform(5.0, 15.0, cout).astype(np.float32)
    n, h, w = x.shape[:3]
    lo = tq.flat_layout(n, h, w)
    jlo = jq.flat_layout(n, h, w)
    xf = np.asarray(jq.nhwc_to_flat(jnp.asarray(x), jlo))
    kw = dict(epilogue=epilogue)
    want = np.asarray(jq.conv3x3_s1_int8_flat(
        *_j(xf, wt, scale, bias), jlo, alpha=jnp.asarray(alpha),
        quant_scale=jnp.asarray(qs), out_dtype=jnp.float32, interpret=True,
        **kw))
    got = tq.conv3x3_s1_int8_flat(
        *_t(xf, wt, scale, bias), lo, alpha=torch.from_numpy(alpha),
        quant_scale=torch.from_numpy(qs), out_dtype=torch.float32,
        vmem_budget_bytes=1 << 20, interpret=True, **kw)
    rows = lo.n * lo.r
    assert got.shape == (rows, 128) and want.shape[0] >= rows
    if epilogue == "prelu_quant":
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want[:rows])
        assert (got != 0).any()
    else:
        _close(got, want[:rows])
    valid = tq._valid_rows(rows, lo, "cpu")[:, 0].numpy()
    assert (got.float().numpy()[~valid] == 0).all()


def test_prelu_quant_chain_matches_jax_steps():
    """conv -> PReLU + requantise -> add_lead -> conv on the flat layout,
    against the same computation done step by step in the JAX package's
    NHWC reference (``tests/test_qconv.py``'s chain, with Cin = Cout = 20,
    not a multiple of 128)."""
    n, h, w, c = 2, 6, 6, 20
    rng = np.random.default_rng(2)
    x = rng.integers(-50, 51, (n, h, w, c)).astype(np.int8)
    w1 = rng.integers(-10, 11, (3, 3, c, c)).astype(np.int8)
    w2 = rng.integers(-10, 11, (3, 3, c, c)).astype(np.int8)
    scale = np.full((c,), 0.01, np.float32)
    bias = np.linspace(-0.5, 0.5, c).astype(np.float32)
    alpha = np.full((c,), 0.25, np.float32)
    qs = np.full((c,), 11.0, np.float32)
    lo = tq.flat_layout(n, h, w)
    q2 = tq.conv3x3_s1_int8_flat(
        tq.nhwc_to_flat(torch.from_numpy(x), lo), *_t(w1, scale, bias), lo,
        alpha=torch.from_numpy(alpha), quant_scale=torch.from_numpy(qs),
        epilogue="prelu_quant")
    out = tq.conv3x3_s1_int8_flat(tq.add_lead(q2, lo), *_t(w2, scale, bias),
                                  lo, out_dtype=torch.float32)
    got = tq.flat_to_nhwc(out, lo)[..., :c]

    z = jq.conv3x3_s1_int8_reference(*_j(x, w1, scale, bias),
                                     out_dtype=jnp.float32)
    d = jnp.where(z >= 0, z, jnp.asarray(alpha) * z)
    q2_ref = jnp.clip(jnp.round(d * jnp.asarray(qs)), -127, 127).astype(
        jnp.int8)
    np.testing.assert_array_equal(tq.flat_to_nhwc(q2, lo)[..., :c].numpy(),
                                  np.asarray(q2_ref))
    want = jq.conv3x3_s1_int8_reference(q2_ref, *_j(w2, scale, bias),
                                        out_dtype=jnp.float32)
    _close(got, np.asarray(want))


def test_wrappers_check_their_inputs():
    x, wt, scale, bias = _case((5, 5, 8, 16))
    lo = tq.flat_layout(2, 5, 5)
    xf = tq.nhwc_to_flat(torch.from_numpy(x), lo)
    with pytest.raises(ValueError, match="epilogue"):
        tq.conv3x3_s1_int8_flat(xf, *_t(wt, scale, bias), lo, epilogue="x")
    with pytest.raises(ValueError, match="channels"):
        tq.conv3x3_s1_int8_flat(xf[:, :5], *_t(wt, scale, bias), lo)
    ops = tq._operands(xf, *_t(wt, scale, bias), None, None)
    with counting() as made, pytest.raises(ValueError, match="CUDA"):
        tq.conv3x3_s1_int8_flat_kernel(xf, tq.pack_conv(*_t(wt, scale, bias)),
                                       lo)
    assert made["launches.k4"] == 0
    # A shorter input reads as zero rows past its end, as in JAX.
    a = tq.conv3x3_s1_int8_flat_reference(ops._replace(x=ops.x[:lo.rows]),
                                          lo)
    assert a.shape == (lo.n * lo.r, 128)


@pytest.mark.parametrize("shape", [(8, 8, 64, 64), (5, 7, 64, 20)])
@pytest.mark.parametrize("epilogue", ["affine", "prelu_quant"])
def test_64_channel_input_matches_padded_call_and_jax(shape, epilogue):
    """A 64-channel flat input (the kernel's K = 64, no padding) gives the
    same rows as the same input padded to 128 channels, and the JAX
    function's (in interpret mode) on the padded layout."""
    x, wt, scale, bias = _case(shape, seed=5)
    cout = shape[3]
    rng = np.random.default_rng(6)
    alpha = rng.uniform(0.1, 0.5, cout).astype(np.float32)
    qs = rng.uniform(5.0, 15.0, cout).astype(np.float32)
    n, h, w = x.shape[:3]
    lo, jlo = tq.flat_layout(n, h, w), jq.flat_layout(n, h, w)
    xf = tq.nhwc_to_flat(torch.from_numpy(x), lo)
    assert xf.shape[1] == 64
    kw = dict(alpha=torch.from_numpy(alpha), quant_scale=torch.from_numpy(qs),
              epilogue=epilogue, out_dtype=torch.float32)
    got = tq.conv3x3_s1_int8_flat(xf, *_t(wt, scale, bias), lo, **kw)
    padded = tq.conv3x3_s1_int8_flat(
        torch.nn.functional.pad(xf, (0, 64)), *_t(wt, scale, bias), lo, **kw)
    assert torch.equal(got, padded)
    want = np.asarray(jq.conv3x3_s1_int8_flat(
        jq.nhwc_to_flat(jnp.asarray(x), jlo), *_j(wt, scale, bias), jlo,
        alpha=jnp.asarray(alpha), quant_scale=jnp.asarray(qs),
        epilogue=epilogue, out_dtype=jnp.float32, interpret=True))
    rows = lo.n * lo.r
    if epilogue == "prelu_quant":
        np.testing.assert_array_equal(got.numpy(), want[:rows])
    else:
        _close(got, want[:rows])
