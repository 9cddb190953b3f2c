"""Parity of the port's dynamic int8 trunk (``diart_tpu_torch.ops.quant``, the
``int8_trunk`` switch) with diart_tpu's, on the CPU.

The counterparts of ``tests/test_quant.py``: the quantizers and the int32
accumulators bitwise against the JAX module's (``preferred_element_type=
int32``), the dequantized outputs within one ulp of the output dtype, the
straight-through gradient, the switch's default, batch independence and
scoped engagement; then each of the five embedding families with the
switch on against JAX's, and the engine's text. On CPU tensors the port
runs the plain version (``csrc/int8_conv.cu`` runs on the card only).

Why JAX runs its fused routes here: on the TPU, JAX runs ECAPA's
SE-Res2Blocks and the x-vector families' final 1500-channel TDNN inside
their Pallas kernels whatever ``int8_trunk`` says, so int8 reaches only
ECAPA's stem and MFA and TDNN 0-3; its CPU path runs those layers as
``QuantizableConv`` and quantizes them too. The port takes those layers
into its kernels (``se_res2``, ``linear_stats``) on every device, so it
matches JAX on the TPU: the tests switch ``pallas_res2`` / ``pallas_head``
(and ``pallas_attn``, whose plain version the port's heads run) on in
JAX's interpret mode through a monkeypatched ``precision.enabled``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diart_tpu.precision as jax_precision
from diart_tpu.models import EmbeddingModel as JaxEmbeddingModel
from diart_tpu.models import SegmentationModel as JaxSegmentationModel
from diart_tpu.ops import quant as jax_quant
from diart_tpu.parallel import MultiStreamEngine as JaxMultiStreamEngine
from diart_tpu.parallel import MultiStreamSession as JaxMultiStreamSession
from diart_tpu_torch import EmbeddingModel, MultiStreamEngine, MultiStreamSession, SegmentationModel
from diart_tpu_torch import precision
from diart_tpu_torch.models.common import QuantizableConv
from diart_tpu_torch.ops import quant

from test_torch_families import jax_registry

INT8 = precision.Precision(int8_trunk=True)
FAMILIES = {
    "xvector": (dict(embedding_dim=16), {"pallas_head"}, 8000),
    "ecapa": (dict(embedding_dim=16, channels=64), {"pallas_res2", "pallas_attn"}, 4800),
    "resnet34": (dict(embedding_dim=32, base_channels=8), set(), 8000),
    "titanet": (dict(embedding_dim=32, channels=32), {"pallas_attn"}, 8000),
    "xvect-sb": (dict(embedding_dim=32, tdnn_specs=((5, 1, 16), (3, 2, 16), (3, 3, 16), (1, 1, 16),
                                                     (1, 1, 48))), {"pallas_head"}, 8000),
}
# the QuantizableConv sites of the JAX families the port quantizes with
# their fused routes on (item 9 of the module docstring), at these widths
SITES = {"xvector": 4, "ecapa": 2, "resnet34": 35, "titanet": 14, "xvect-sb": 4}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _nhwc(x):
    """The port's channels-first (B, C, S...) as JAX's channels-last."""
    return np.moveaxis(x, 1, -1)


def _hwio(w):
    """The port's (C_out, C_in, k...) weight as JAX's (k..., C_in, C_out)."""
    return np.moveaxis(w, (0, 1), (-1, -2))


# ----------------------------------------------------------------------- #
# the quantizers and the accumulators, bitwise


@pytest.mark.parametrize("shape,dtype", [((3, 17, 9, 5), np.float32), ((4, 60, 33), np.float32),
                                         ((2, 8, 40), "bf16")])
def test_quantize_per_sample_bitwise_jax(shape, dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=shape) * rng.uniform(0.1, 10, (shape[0],) + (1,) * (len(shape) - 1)))
    x = x.astype(np.float32)
    # a value on a rounding tie of its sample's scale: half to even on both sides
    x[0].flat[0] = 2.5 * np.abs(x[0]).max() / 127.0
    xt = torch.from_numpy(x)
    xj = jnp.asarray(_nhwc(x))
    if dtype == "bf16":
        xt, xj = xt.to(torch.bfloat16), xj.astype(jnp.bfloat16)
    q, s = quant.quantize_per_sample(xt)
    jq, js = jax_quant.quantize_per_sample(xj)
    assert q.dtype == torch.int8 and s.shape == (shape[0],) + (1,) * (len(shape) - 1)
    np.testing.assert_array_equal(_nhwc(q.numpy()), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().reshape(-1), np.asarray(js).reshape(-1))
    # the kernel's channels-last layout of the same values (plain version
    # here), its channels padded to a multiple of 32 with zeros
    rows, scale = quant.quantize_rows(xt)
    c = shape[1]
    assert rows.shape == (shape[0], int(np.prod(shape[2:])), quant.padded_channels(c))
    np.testing.assert_array_equal(rows[..., :c].numpy(), q.flatten(2).transpose(1, 2).numpy())
    assert not rows[..., c:].any()
    np.testing.assert_array_equal(scale.numpy(), s.numpy().reshape(-1))


@pytest.mark.parametrize("shape", [(16, 8, 3, 3), (24, 60, 5), (32, 512, 1)])
def test_quantize_weight_bitwise_jax(shape):
    rng = np.random.default_rng(1)
    w = (rng.normal(size=shape) * rng.uniform(0.01, 5, (shape[0],) + (1,) * (len(shape) - 1)))
    w = w.astype(np.float32)
    q, s = quant.quantize_weight(torch.from_numpy(w))
    jq, js = jax_quant.quantize_weight(jnp.asarray(_hwio(w)))
    np.testing.assert_array_equal(_hwio(q.numpy()), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (np.abs(q.numpy()).reshape(shape[0], -1).max(axis=1) == 127).all()


# (name, x shape, C_out, kernel, stride, padding, dilation): test_quant.py's
# 2-D cases (3x3 pad 1 stride 1, 3x3 valid stride 2), ResNet34's three
# kinds, and the 1-D TDNN geometries, TDNN 0's K = 60 * 5 = 300 included
CONV_CASES = [
    ("3x3-s1-p1", (2, 16, 20, 12), 32, (3, 3), 1, 1, 1),
    ("3x3-s2-valid", (2, 16, 20, 12), 32, (3, 3), 2, 0, 1),
    ("3x3-s2-p1", (2, 16, 21, 13), 32, (3, 3), 2, 1, 1),
    ("1x1-s2", (2, 16, 21, 13), 32, (1, 1), 2, 0, 1),
    ("tdnn0-k5", (3, 60, 40), 24, (5,), 1, 0, 1),
    ("tdnn-k3-d2", (3, 32, 40), 24, (3,), 1, 0, 2),
    ("tdnn-k3-d3", (3, 32, 40), 24, (3,), 1, 0, 3),
    ("pointwise", (3, 48, 40), 24, (1,), 1, 0, 1),
]


def _jax_conv(x, w, stride, pad, dil, **kw):
    dims = x.ndim - 2
    spec = ("NHWC", "HWIO", "NHWC") if dims == 2 else ("NHC", "HIO", "NHC")
    return jax.lax.conv_general_dilated(x, w, (stride,) * dims, [(pad, pad)] * dims,
                                        rhs_dilation=(dil,) * dims, dimension_numbers=spec, **kw)


@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_int32_accumulators_bitwise_jax(case):
    _, shape, c_out, kernel, stride, pad, dil = case
    rng = np.random.default_rng(2)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(c_out, shape[1], *kernel)) * 0.1).astype(np.float32)
    q_x, _ = quant.quantize_per_sample(torch.from_numpy(x))
    q_w, _ = quant.quantize_weight(torch.from_numpy(w))
    acc = quant.int8_accumulate(q_x, q_w, stride, pad, dil)
    jq_x, _ = jax_quant.quantize_per_sample(jnp.asarray(_nhwc(x)))
    jq_w, _ = jax_quant.quantize_weight(jnp.asarray(_hwio(w)))
    want = _jax_conv(jq_x, jq_w, stride, pad, dil, preferred_element_type=jnp.int32)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(_nhwc(acc.numpy()), np.asarray(want))


def _ulps(got: np.ndarray, want: np.ndarray, dtype) -> float:
    """The largest difference in units of the last place of ``dtype`` at
    the wanted value."""
    eps = 2.0**-23 if dtype == "f32" else 2.0**-7
    unit = np.maximum(np.abs(want), np.finfo(np.float32).tiny) * eps
    return float(np.max(np.abs(got - want) / unit))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_int8_conv_matches_jax_within_an_ulp(case, dtype):
    """JAX's ``int8_conv`` then ``+ bias`` in the output dtype (its
    ``QuantizableConv``): bitwise or within one ulp (XLA may fuse the
    epilogue's product and the bias add)."""
    _, shape, c_out, kernel, stride, pad, dil = case
    rng = np.random.default_rng(3)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(c_out, shape[1], *kernel)) * 0.1).astype(np.float32)
    b = rng.normal(size=c_out).astype(np.float32)
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "f32" else (torch.bfloat16, jnp.bfloat16)
    got = quant.int8_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), stride, pad,
                          dil, tdt)
    dims = len(kernel)
    want = jax_quant.int8_conv(jnp.asarray(_nhwc(x)), jnp.asarray(_hwio(w)), (stride,) * dims,
                               [(pad, pad)] * dims, jdt, (dil,) * dims)
    want = want + jnp.asarray(b).astype(jdt)
    assert got.dtype == tdt
    assert _ulps(_nhwc(got.float().numpy()), np.asarray(want.astype(jnp.float32)), dtype) <= 1.0


def test_int8_operands_layout():
    """The kernel's weight rows: taps (k1, k2) x C_pad channels, each tap's
    channels zero-padded to a multiple of 32, the quantized values and
    scales of :func:`quantize_weight`."""
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.normal(size=(24, 60, 5)).astype(np.float32))
    ops = quant.prepare_int8_operands(w, torch.ones(24))
    q, s = quant.quantize_weight(w)
    assert ops.q_w.shape == (24, 5 * 64) and ops.kernel == (5, 1) and ops.in_channels == 60
    taps = ops.q_w.view(24, 5, 64)
    np.testing.assert_array_equal(taps[..., :60].numpy(), q.permute(0, 2, 1).numpy())
    assert not taps[..., 60:].any()
    assert torch.equal(ops.s_w, s) and ops.bias.dtype == torch.float32
    w2 = torch.from_numpy(rng.normal(size=(8, 4, 3, 3)).astype(np.float32))
    ops2 = quant.prepare_int8_operands(w2)
    q2, _ = quant.quantize_weight(w2)
    assert ops2.q_w.shape == (8, 9 * 32) and ops2.bias is None
    taps2 = ops2.q_w.view(8, 3, 3, 32)
    np.testing.assert_array_equal(taps2[..., :4].numpy(), q2.permute(0, 2, 3, 1).numpy())
    assert not taps2[..., 4:].any()
    assert quant.padded_channels(32) == 32 and quant.padded_channels(33) == 64


def _layout_sums(q_x, q_w, size, kernel, stride, pad, dil):
    """The int32 sums the kernel computes from its operands, replayed in
    float64 on the CPU: ``q_x`` (B, S1 * S2, C_pad) channels-last, ``q_w``
    (C_out, k1 * k2 * C_pad); for each tap (i, j) and output position (o1,
    o2) the input row at o * stride + tap * dilation - padding on each axis
    (zeros outside), as the tensor map's boxes read it. -> (B, C_out, O1,
    O2) int32."""
    (s1, s2), (k1, k2) = size, kernel
    (st1, st2), (p1, p2), (d1, d2) = stride, pad, dil
    batch, _, c_pad = q_x.shape
    c_out = q_w.shape[0]
    o1 = (s1 + 2 * p1 - d1 * (k1 - 1) - 1) // st1 + 1
    o2 = (s2 + 2 * p2 - d2 * (k2 - 1) - 1) // st2 + 1
    x = q_x.double().view(batch, s1, s2, c_pad)
    w = q_w.double().view(c_out, k1, k2, c_pad)
    acc = torch.zeros(batch, o1, o2, c_out, dtype=torch.float64)
    for i in range(k1):
        for j in range(k2):
            r1 = torch.arange(o1) * st1 + i * d1 - p1
            r2 = torch.arange(o2) * st2 + j * d2 - p2
            ok = ((r1 >= 0) & (r1 < s1))[:, None] & ((r2 >= 0) & (r2 < s2))[None, :]
            rows = x[:, r1.clamp(0, s1 - 1)][:, :, r2.clamp(0, s2 - 1)] * ok[None, :, :, None]
            acc += rows @ w[:, i, j].T
    return acc.permute(0, 3, 1, 2).to(torch.int32)


# CONV_CASES and a strided, padded, dilated case in both ranks
LAYOUT_CASES = CONV_CASES + [
    ("3x3-s2-p1-d3", (2, 40, 23, 17), 24, (3, 3), 2, 1, 3),
    ("k3-s2-p1-d3", (3, 33, 41), 16, (3,), 2, 1, 3),
]


@pytest.mark.parametrize("case", LAYOUT_CASES, ids=[c[0] for c in LAYOUT_CASES])
def test_layout_sums_bitwise_jax(case):
    """The kernel's operand layouts, made by the wrapper's CPU-side helpers
    (:func:`quantize_rows` (B, S, C_pad), :func:`prepare_int8_operands`
    (C_out, taps x C_pad)), give JAX's int32 accumulators bit for bit when
    summed tap by tap as the kernel reads them."""
    _, shape, c_out, kernel, stride, pad, dil = case
    dims = len(kernel)
    rng = np.random.default_rng(9)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(c_out, shape[1], *kernel)) * 0.1).astype(np.float32)
    q_x, _ = quant.quantize_rows(torch.from_numpy(x))
    ops = quant.prepare_int8_operands(torch.from_numpy(w))
    c_pad = quant.padded_channels(shape[1])
    assert q_x.shape == (shape[0], int(np.prod(shape[2:])), c_pad)
    assert ops.q_w.shape == (c_out, int(np.prod(kernel)) * c_pad)
    pair = lambda v, rest: (v,) * dims + (rest,) * (2 - dims)
    size = tuple(shape[2:]) + (1,) * (2 - dims)
    got = _layout_sums(q_x, ops.q_w, size, ops.kernel, pair(stride, 1), pair(pad, 0), pair(dil, 1))
    jq_x, _ = jax_quant.quantize_per_sample(jnp.asarray(_nhwc(x)))
    jq_w, _ = jax_quant.quantize_weight(jnp.asarray(_hwio(w)))
    want = np.asarray(_jax_conv(jq_x, jq_w, stride, pad, dil, preferred_element_type=jnp.int32))
    got = _nhwc(got.numpy())
    np.testing.assert_array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("scale", [1e-9, 3e-3, 0.7, 11.0, 4e5])
def test_kernel_rounding_equals_the_division(scale):
    """``quantize_rows``' rounding in the kernel (``csrc/int8_conv.cu``
    ``quantize``), replayed in numpy f32: rint(v * (1 / s_x)), and the
    exact division where v * (1 / s_x) lies within 1e-4 of a half-integer,
    gives rint(v / s_x) for every value, ties of the scale included."""
    rng = np.random.default_rng(10)
    amax = np.float32(scale)
    sx = np.float32(amax / np.float32(127))
    rx = np.float32(np.float32(1) / sx)
    ties = ((rng.integers(-127, 127, 20000) + 0.5) * sx).astype(np.float32)
    v = np.concatenate([rng.uniform(-1, 1, 200000).astype(np.float32) * amax, ties,
                        np.nextafter(ties, np.float32(np.inf)), np.nextafter(ties, np.float32(-np.inf)),
                        np.float32([amax, -amax, 0.0])]).astype(np.float32)
    v = np.clip(v, -amax, amax)
    y = (v * rx).astype(np.float32)
    r = np.rint(y)
    near = np.abs(y - r) > np.float32(0.5) - np.float32(1e-4)
    got = np.clip(np.where(near, np.rint(v / sx), r), -127, 127)
    want = quant.quantize_per_sample(torch.from_numpy(v)[None, None])[0].numpy().reshape(-1)
    np.testing.assert_array_equal(got.astype(np.int8), want)
    assert near.mean() < 0.3  # the division stays the exception


# (C_out, O1, O2, stride, C_pad) of the quantizable sites of the five
# families at full width (B = 64; chip_smoke.py's phase 9) and of CONV_CASES
PLAN_SITES = [
    (512, 289, 1, 1, 64), (512, 285, 1, 1, 512), (512, 279, 1, 1, 512), (512, 501, 1, 1, 96),
    (1536, 501, 1, 1, 1536), (32, 498, 80, 1, 32), (64, 249, 40, 2, 32), (64, 249, 40, 1, 64),
    (128, 125, 20, 2, 64), (128, 125, 20, 1, 128), (256, 63, 10, 2, 128), (256, 63, 10, 1, 256),
    (1024, 501, 1, 1, 96), (1024, 501, 1, 1, 1024), (3072, 501, 1, 1, 1024), (512, 501, 1, 1, 32),
    (512, 497, 1, 1, 512), (512, 495, 1, 1, 512), (32, 20, 12, 1, 32), (32, 9, 5, 2, 32),
    (32, 11, 7, 2, 32), (24, 36, 1, 1, 64), (24, 36, 1, 1, 32), (24, 40, 1, 1, 64),
]


@pytest.mark.parametrize("site", PLAN_SITES, ids=[str(s) for s in PLAN_SITES])
def test_conv_plan_covers_the_output(site):
    """The launch plan at every site: a wgmma N the kernel has, a box of
    box1 x box2 == N positions within the tensor memory's 256 elements an
    axis at the stride, a K slice that divides C_pad, and tiles that cover
    every output channel and position (with less than one tile of padding
    along each axis)."""
    c_out, o1, o2, stride, c_pad = site
    s2 = stride if o2 > 1 else 1
    plan = quant.conv_plan(c_out, o1, o2, stride, s2, c_pad)
    nw = 2 // plan.mw
    assert plan.n in quant.TILE_N and plan.box1 * plan.box2 == plan.n
    assert plan.box1 * stride <= quant.BOX_MAX and plan.box2 * s2 <= quant.BOX_MAX
    assert plan.mw == (1 if c_out <= 64 else 2)
    assert plan.bk in (32, 64, 128) and c_pad % plan.bk == 0
    assert plan.bk == max(b for b in (32, 64, 128) if c_pad % b == 0)
    mt, t1, t2 = plan.tiles
    rows, cols = plan.box1 * nw, plan.box2
    assert mt * 64 * plan.mw >= c_out > (mt - 1) * 64 * plan.mw
    assert t1 * rows >= o1 > (t1 - 1) * rows and t2 * cols >= o2 > (t2 - 1) * cols
    if o2 == 1:
        assert plan.box2 == 1


def test_int8_conv_checks_its_inputs():
    x = torch.zeros(2, 8, 10)
    with pytest.raises(ValueError, match="input channels"):
        quant.int8_conv(x, torch.zeros(4, 6, 3))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        quant.int8_conv(x.double(), torch.zeros(4, 8, 3))
    with pytest.raises(ValueError):
        quant.int8_conv(x, torch.zeros(4, 8, 3, 3))
    with pytest.raises(ValueError, match="grouped"):
        QuantizableConv(8, 8, 3, groups=8)


# The straight-through gradient: the exact f32 convolution's VJP at the
# unquantized operands, with the cotangent of the quantized forward. The
# forwards agree bitwise and the VJPs are f32 convolutions summed in
# another order: within 1e-5.
@pytest.mark.parametrize("case", [CONV_CASES[0], CONV_CASES[4]], ids=["2d", "1d"])
def test_straight_through_gradient_matches_jax(case):
    _, shape, c_out, kernel, stride, pad, dil = case
    rng = np.random.default_rng(6)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(c_out, shape[1], *kernel)) * 0.1).astype(np.float32)
    dims = len(kernel)
    xt, wt = (torch.tensor(a, requires_grad=True) for a in (x, w))
    (quant.int8_conv(xt, wt, None, stride, pad, dil) ** 2).sum().div(100).backward()
    loss = lambda a, b: jnp.sum(jax_quant.int8_conv(a, b, (stride,) * dims, [(pad, pad)] * dims,
                                                   jnp.float32, (dil,) * dims) ** 2) / 100
    gx, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(_nhwc(x)), jnp.asarray(_hwio(w)))
    np.testing.assert_allclose(_nhwc(xt.grad.numpy()), np.asarray(gx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_hwio(wt.grad.numpy()), np.asarray(gw), rtol=1e-5, atol=1e-5)
    assert np.abs(xt.grad.numpy()).max() > 0
    # the plain version's own autograd would give zero: rounding has no gradient
    xr = torch.tensor(x, requires_grad=True)
    q, s = quant.quantize_per_sample(xr)
    assert not q.requires_grad


def test_int8_trunk_default_off():
    assert precision.Precision().int8_trunk is False
    assert precision.enabled("int8_trunk", "cpu") is False
    assert precision.Precision().resolved("cuda")["int8_trunk"] is False
    # not CUDA-only: on, it applies on every device, as in JAX
    assert INT8.resolved("cpu")["int8_trunk"] is True
    assert precision.Precision.parse("int8_trunk").int8_trunk is True
    assert precision.Precision.portable().int8_trunk is False


# ----------------------------------------------------------------------- #
# the five families under int8


@pytest.fixture(scope="module")
def family_pairs():
    out = {}
    for name, (kw, _, samples) in FAMILIES.items():
        jemb = jax_registry(JaxEmbeddingModel, f"tpu/{name}", init_samples=samples, **kw)
        tree = jax.tree_util.tree_map(np.asarray, jemb.params)
        out[name] = (jemb, EmbeddingModel.from_registry(f"tpu/{name}", device="cpu", flax_params=tree, **kw))
    return out


def _waves(samples, batch=2, seed=3):
    return np.random.default_rng(seed).normal(scale=0.2, size=(batch, 1, samples)).astype(np.float32)


# Embeddings within 1e-4 x max(1, |emb|): the trunks' f32 sums run in another
# order on the two sides, and an activation within rounding of a
# quantization tie can take the neighbouring int8 value, which moves the
# pooled embedding by ~1e-6 of its size. ResNet34 is held block by block
# below: through its 35 quantized convolutions such flips cascade.
@pytest.mark.parametrize("name", sorted(set(FAMILIES) - {"resnet34"}))
def test_family_int8_matches_jax(name, family_pairs, monkeypatch):
    jemb, pemb = family_pairs[name]
    _, fused, samples = FAMILIES[name]
    wave = _waves(samples)
    with precision.use(INT8):
        got = pemb.module(torch.from_numpy(wave)).numpy()
    base = pemb.module(torch.from_numpy(wave)).numpy()
    monkeypatch.setattr(jax_precision, "enabled", lambda f: f in fused | {"int8_trunk"})
    want = np.asarray(jemb.module.apply(jemb.params, jnp.asarray(wave)))
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert not np.allclose(got, base, rtol=0, atol=tol), "the int8 path did not engage"


def test_resnet34_int8_matches_jax_block_by_block(family_pairs, monkeypatch):
    """ResNet34 with the switch on, each BasicBlock fed JAX's input to it:
    its output within 1e-4 x max(1, |out|) of JAX's (the int8 products are
    exact and the epilogues equal; what is left is f32 rounding). Whole
    trunks drift apart: the stem's f32 sums run in another order, an
    activation within rounding of a quantization tie takes the neighbouring
    int8 value, and through 35 quantized convolutions those flips cascade to
    the size of the quantization noise itself (measured: 3% of the trunk's
    largest value from identical features). So the whole model is held to
    JAX's int8 embedding only at the int8 fidelity bound (cosine > 0.999,
    ``tests/test_quant.py``'s)."""
    jemb, pemb = family_pairs["resnet34"]
    wave = _waves(8000)
    monkeypatch.setattr(jax_precision, "enabled", lambda f: f == "int8_trunk")
    feats = jemb.module.apply(jemb.params, jnp.asarray(wave), method="features")
    _, inter = jemb.module.apply(jemb.params, feats, method="trunk_from_features",
                                 capture_intermediates=True, mutable=["intermediates"])
    inter = inter["intermediates"]
    x = jax.nn.relu(inter["bn1"]["__call__"][0])
    engaged = False
    with precision.use(INT8):
        for name in pemb.module.blocks:
            want = np.asarray(inter[name]["__call__"][0])
            block = getattr(pemb.module, name)
            xin = torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))
            got = np.moveaxis(block(xin).numpy(), 1, -1)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(1.0, float(np.abs(want).max())),
                                       err_msg=name)
            with precision.use(precision.Precision()):
                engaged |= not np.allclose(np.moveaxis(block(xin).numpy(), 1, -1), want, atol=1e-4)
            x = want
    assert engaged, "the int8 path did not engage"
    with precision.use(INT8):
        got = pemb.module(torch.from_numpy(wave)).numpy()
    full = np.asarray(jemb.module.apply(jemb.params, jnp.asarray(wave)))
    cos = np.sum(got * full, -1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(full, axis=-1))
    assert (cos > 0.999).all(), cos


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_int8_sites(name, family_pairs, monkeypatch):
    """The int8 calls of one forward are the JAX families' QuantizableConv
    sites outside the fused kernels: TitaNet's depthwise convolutions and
    ResNet34's stem are plain convolutions in JAX and stay unquantized."""
    _, pemb = family_pairs[name]
    _, _, samples = FAMILIES[name]
    calls = []
    orig = quant.int8_conv_reference
    monkeypatch.setattr(quant, "int8_conv_reference", lambda *a, **k: calls.append(1) or orig(*a, **k))
    with precision.use(INT8):
        pemb.module(torch.from_numpy(_waves(samples, batch=1)))
    assert len(calls) == SITES[name]
    convs = [m for m in pemb.module.modules() if isinstance(m, QuantizableConv)]
    plain = [m for m in convs if not m.quantizable]
    if name == "titanet":
        assert plain and all(m.groups > 1 for m in plain)
    elif name == "resnet34":
        assert plain == [pemb.module.conv1]
    else:
        assert not plain


def test_plain_sites_untouched_by_the_switch(family_pairs):
    """TitaNet's depthwise convolution and ResNet34's stem give the same
    bits with the switch on and off."""
    rng = np.random.default_rng(5)
    _, titanet = family_pairs["titanet"]
    _, resnet = family_pairs["resnet34"]
    dw = next(m for m in titanet.module.modules() if isinstance(m, QuantizableConv) and m.groups > 1)
    x = torch.from_numpy(rng.normal(size=(2, dw.weight.shape[0], 30)).astype(np.float32))
    s = torch.from_numpy(rng.normal(size=(2, 1, 30, 80)).astype(np.float32))
    with precision.use(INT8):
        on = dw(x), resnet.module.conv1(s)
    off = dw(x), resnet.module.conv1(s)
    assert all(torch.equal(a, b) for a, b in zip(on, off))


@pytest.mark.parametrize("case", [CONV_CASES[0], CONV_CASES[4]], ids=["2d", "1d"])
def test_int8_batch_independence(case):
    """A stream's int8 convolution does not depend on which streams share
    its batch: the activation scales are per sample, so a quiet stream
    alone and beside a loud one gives the same bits. (Held at the
    convolution: through a whole trunk, another batch size lets the f32
    layers between the sites sum in another order, and quantization ties
    then cascade, as the ResNet34 test above shows.)"""
    _, shape, c_out, kernel, stride, pad, dil = case
    rng = np.random.default_rng(8)
    quiet = (rng.normal(size=(1,) + shape[1:]) * 0.01).astype(np.float32)
    loud = (rng.normal(size=(1,) + shape[1:]) * 5.0).astype(np.float32)
    w = torch.from_numpy((rng.normal(size=(c_out, shape[1], *kernel)) * 0.1).astype(np.float32))
    alone = quant.int8_conv(torch.from_numpy(quiet), w, None, stride, pad, dil)
    batched = quant.int8_conv(torch.from_numpy(np.concatenate([quiet, loud])), w, None, stride, pad, dil)
    assert torch.equal(batched[:1], alone)


def test_int8_policy_scoped_engagement(family_pairs):
    """A ``precision.use`` scope turns the path on and, closed, off again."""
    _, pemb = family_pairs["resnet34"]
    wave = torch.from_numpy(_waves(8000, batch=1, seed=4))
    base = pemb.module(wave)
    with precision.use(INT8):
        quantized = pemb.module(wave)
    assert not torch.allclose(quantized, base)
    assert torch.equal(pemb.module(wave), base)
    cos = torch.nn.functional.cosine_similarity(quantized, base)
    assert (cos > 0.999).all(), cos


# ----------------------------------------------------------------------- #
# the engine (test_quant.py's test_int8_trunk_through_engine)


def test_int8_engine_text_matches_jax(monkeypatch):
    """The x-vector engine with ``int8_trunk`` on emits JAX's int8 engine's
    RTTM text at every hop (JAX with its fused head, as above)."""
    seg_kw = dict(lstm_hidden=16, lstm_layers=1, linear_dims=(16,))
    jseg = jax_registry(JaxSegmentationModel, "tpu/pyannet", init_samples=32000, **seg_kw)
    jemb = jax_registry(JaxEmbeddingModel, "tpu/xvector", init_samples=32000, embedding_dim=32)
    tree = lambda m: jax.tree_util.tree_map(np.asarray, m.params)
    pseg = SegmentationModel.from_registry("tpu/pyannet", device="cpu", flax_params=tree(jseg), **seg_kw)
    pemb = EmbeddingModel.from_registry("tpu/xvector", device="cpu", flax_params=tree(jemb),
                                        embedding_dim=32)
    kw = dict(duration=2.0, step=0.5, latency=0.5, sample_rate=16000, tau_active=0.2, max_speakers=4,
              batch_size=2)
    monkeypatch.setattr(jax_precision, "enabled", lambda f: f in {"pallas_head", "int8_trunk"})
    jses = JaxMultiStreamSession(JaxMultiStreamEngine(jseg, jemb, **kw), tau_active=0.2, collect_audio=False)
    pses = MultiStreamSession(MultiStreamEngine(pseg, pemb, precision=INT8, **kw), tau_active=0.2,
                              collect_audio=False)
    rng = np.random.default_rng(3)
    texts, want = [], []
    for _ in range(10):
        blk = rng.normal(scale=0.3, size=(2, 8000)).astype(np.float32)
        texts.append(pses.push_rttm(blk))
        want.append(jses.push_rttm(blk))
    assert any(t for hop in want for t in hop)
    assert texts == want
