"""SincNet's first stage (``ops/sinc_frontend.py``, ``csrc/sinc_frontend.cu``)
held on the CPU: the op's CPU route is the composition the models ran
before (bitwise), a replay of the kernel's arithmetic (the fold about the
centre tap, its k order, one fused multiply-add a step in f32, the pool in
the epilogue) against the plain f32 version within the card's tolerance,
the bf16 rounding after the max, the launch plan's coverage, the held
operands, and the (anti)symmetric layout the kernel's fold reads. The
kernel itself is held against the plain version on the card by
chip_smoke.py (``check_sinc``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diart_tpu_torch import precision
from diart_tpu_torch.models.sincnet import SincConv, SincNet, frontend_pool, sinc_filters
from diart_tpu_torch.ops import sinc_frontend as sf

CSRC = Path(sf.__file__).resolve().parents[1] / "csrc" / "sinc_frontend.cu"

# The card's tolerance (chip_smoke.py SINC_TOL): f32 sums in another order,
# relative to the outputs' scale.
SINC_TOL = 1e-5


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _wave(batch, samples, seed=0):
    """A standardized waveform (B, 1, S), as SincNet's instance norm gives."""
    x = np.random.default_rng(seed).normal(size=(batch, 1, samples)).astype(np.float32)
    x = torch.from_numpy(x)
    return (x - x.mean(-1, keepdim=True)) * torch.rsqrt(x.var(-1, keepdim=True, correction=0) + 1e-5)


def _bank(seed=None):
    """SincNet's filterbank: the mel init, or cutoffs moved at random."""
    sinc = SincConv()
    if seed is not None:
        rng = np.random.default_rng(seed)
        with torch.no_grad():
            sinc.low_hz.mul_(torch.from_numpy(rng.uniform(0.9, 1.1, 40).astype(np.float32)))
            sinc.band_hz.mul_(torch.from_numpy(rng.uniform(0.9, 1.1, 40).astype(np.float32)))
    with torch.no_grad():
        return sinc.filters()


def _stacked(seed=1):
    """The engine's stacked bank: two banks with their norm scales folded
    in, and their norm biases as a bias (``MultiStreamEngine._stacked_frontend``)."""
    fs, fe = _bank(), _bank(seed)
    bias = torch.cat([0.1 * fs.sum(dim=1), -0.2 * fe.sum(dim=1)])
    return torch.cat([fs * 1.5, fe * 0.75]), bias


def _cases():
    f80 = _bank(3)
    f160, b160 = _stacked()
    return {"F80": (f80, None, 1), "F80_bias": (f80, torch.linspace(-0.5, 0.5, 80), 1),
            "F160": (f160, None, 2), "F160_bias": (f160, b160, 2)}


# ----------------------------------------------------------------------- #
# the CPU route is the composition the models ran before


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16_frontend"])
@pytest.mark.parametrize("case", ["F80", "F80_bias", "F160", "F160_bias"])
def test_cpu_route_is_the_plain_composition(monkeypatch, case, bf16):
    """Raw filters or their prepared operands: bitwise ``frontend_pool`` of
    the f32 convolution; with ``bf16_frontend`` forced on a CPU tensor (the
    policy gates it to CUDA) the pre-pool rounding runs too."""
    filters, bias, banks = _cases()[case]
    real = precision.enabled
    monkeypatch.setattr(precision, "enabled",
                        lambda field, device: bf16 if field == "bf16_frontend" else real(field, device))
    x = _wave(2, 4000)
    want = frontend_pool(F.conv1d(x, filters[:, None, :], bias, stride=10))
    got_raw = sf.sinc_frontend(x, filters, 10, bias)
    got_ops = sf.sinc_frontend(x, None, 10, operands=sf.prepare_sinc_operands(filters, bias, banks))
    assert got_raw.shape == (2, filters.shape[0], ((4000 - 251) // 10 + 1) // 3)
    assert torch.equal(got_raw, want) and torch.equal(got_ops, want)
    if bf16:
        assert torch.equal(want, want.to(torch.bfloat16).float())


def test_sincnet_forward_is_unchanged_on_the_cpu():
    """SincNet's trunk through the op (held operands) against the trunk with
    the old first stage, bitwise, and in a call that trains the cutoffs."""
    torch.manual_seed(0)
    net = SincNet()
    x = _wave(2, 16000)
    with torch.no_grad():
        xn = (x - x.mean(-1, keepdim=True)) * torch.rsqrt(x.var(-1, keepdim=True, correction=0) + 1e-5)
        pooled = frontend_pool(net.sinc(xn * net.wav_norm_scale + net.wav_norm_bias))
        want = net(x, pooled=pooled)
        got = net(x)
    assert torch.equal(got, want)
    trained = net(x)
    trained.sum().backward()
    assert torch.equal(trained.detach(), want)
    assert net.sinc.low_hz.grad is not None and torch.isfinite(net.sinc.low_hz.grad).all()


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16_frontend"])
def test_function_backward_keeps_the_forwards_policy(monkeypatch, bf16):
    """``SincFrontendFunction``'s backward recomputes the plain version under
    the forward's ``bf16_frontend``, on whatever thread autograd runs it (a
    CUDA backward runs on autograd's own thread, whose policy is the
    default): its gradients are the plain version's autograd, bitwise. The
    kernel is stood in for by the replay, the device gate by the policy."""
    import threading

    monkeypatch.setattr(precision, "enabled",
                        lambda field, device: getattr(precision.active(), field))
    monkeypatch.setattr(sf, "_launch", lambda wave, ops, flag: replay(wave, ops, flag))
    filters, bias, banks = _cases()["F80_bias"]
    ops = sf.prepare_sinc_operands(filters, bias, banks)
    g = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 80, 100)).astype(np.float32))
    grads = {}
    with precision.use(precision.Precision(bf16_frontend=bf16), force=True):
        for how in ("plain", "function"):
            x, f, b = (t.clone().requires_grad_(True) for t in (_wave(2, 3251), filters, bias))
            if how == "plain":
                out = sf.sinc_frontend_reference(x, f, 10, b)
                out.backward(g)
            else:
                out = sf.SincFrontendFunction.apply(x, f, b, ops, bf16)
                worker = threading.Thread(target=out.backward, args=(g,))  # the default policy there
                worker.start()
                worker.join(timeout=60)
                assert not worker.is_alive()
            grads[how] = (x.grad, f.grad, b.grad)
    assert all(torch.equal(a, c) for a, c in zip(grads["plain"], grads["function"]))


# ----------------------------------------------------------------------- #
# the kernel's arithmetic, replayed


def replay(wave, ops, bf16=False):
    """``csrc/sinc_frontend.cu``'s arithmetic in plain PyTorch: per pooled
    frame p, frame j and pair step k = 10 a + r (r outer, a inner; the
    centre at r = 5, a = 12), s = x[30 p + 10 j + k] + x[30 p + 10 j + 250
    - k] and d = the difference in f32, and each column's sum takes one
    fused multiply-add a step (the product exact in f64, one rounding to
    f32) of its coefficient with s (symmetric) or d (antisymmetric); then
    the bias, |.|, the max over j and, under bf16, one rounding."""
    x = wave[:, 0].float()
    batch, samples = x.shape
    pooled = sf.num_pooled(samples)
    groups = ops.taps.shape[0]
    base = 30 * torch.arange(pooled)[:, None] + 10 * torch.arange(3)[None, :]  # (P, 3)
    acc = torch.zeros(batch, pooled, 3, groups, sf.GROUP)
    for r in range(10):
        for a in range(13 if r <= 5 else 12):
            k = 10 * a + r
            u, v = x[:, base + k], x[:, base + 250 - k]
            pair = torch.stack([u + v, u - v], dim=-1)  # (B, P, 3, 2), f32
            operand = pair[..., None, :].repeat_interleave(sf.GROUP // 2, dim=-1)  # (B, P, 3, 1, 20)
            acc = (acc.double() + ops.taps[:, k, :].double() * operand.double()).float()
    y = (acc + ops.shift).abs()
    m = y.max(dim=2).values  # (B, P, G, 20)
    if bf16:
        m = m.to(torch.bfloat16).float()
    out = torch.empty(batch, groups * sf.GROUP, pooled)
    out[:, ops.rows.reshape(-1).long(), :] = m.reshape(batch, pooled, -1).permute(0, 2, 1)
    return out


@pytest.mark.parametrize("case", ["F80", "F80_bias", "F160", "F160_bias"])
def test_replay_holds_the_f32_tolerance(case):
    filters, bias, banks = _cases()[case]
    ops = sf.prepare_sinc_operands(filters, bias, banks)
    x = _wave(2, 5000, seed=4)
    want = sf.sinc_frontend_reference(x, filters, 10, bias)
    got = replay(x, ops)
    tol = SINC_TOL * want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= tol, (err, tol)
    assert err > 0  # the fold rounds otherwise than the direct sum: the replay is not the plain version


def test_replay_at_a_full_window():
    """One stream of 5 s (80000 samples, 2658 pooled frames), the bank of
    the perturbed embedding, under bf16: the replay's bf16 outputs lie
    within one bf16 rounding of the plain version's."""
    filters = _bank(5)
    ops = sf.prepare_sinc_operands(filters)
    x = _wave(1, 80000, seed=6)
    want = sf.sinc_frontend_reference(x, filters, 10)
    got = replay(x, ops)
    assert (got - want).abs().max().item() <= SINC_TOL * want.abs().max().item()
    got16, want16 = replay(x, ops, bf16=True), want.to(torch.bfloat16).float()
    assert ((got16 - want16).abs() <= want16.abs() * 2.0**-7).all()


def test_bf16_rounding_commutes_with_the_pooled_max():
    """``max |bf16(y)| == bf16(max |y|)`` bit for bit (round to nearest even
    is monotone and symmetric in sign): ties between neighbours that round
    together or apart, both signs, zeros of both signs, infinities."""
    half = 2.0**-8  # half a bf16 step at 1: a tie
    vals = [1.0, 1.0 + half, -(1.0 + half), 1.0 + 3 * half, -(1.0 + 3 * half), 1.0 + half * 0.999,
            -0.0, 0.0, 3.0e38, -3.4e38, float("inf"), -float("inf"), 1e-40, -1e-40, 2.0, -2.0 + half]
    rng = np.random.default_rng(0)
    n = 4096 * 3 - len(vals)
    y = torch.tensor(vals + list(rng.normal(size=n) * 10.0 ** rng.integers(-3, 3, n)), dtype=torch.float32)
    perms = [y, y.flip(0), y[torch.from_numpy(rng.permutation(y.numel()))]]
    for v in perms:
        v = v.view(4, 3, -1)
        first = F.max_pool1d(v.to(torch.bfloat16).abs(), 3).float()
        last = F.max_pool1d(v.abs(), 3).to(torch.bfloat16).float()
        assert torch.equal(first.view(torch.int32), last.view(torch.int32))


# ----------------------------------------------------------------------- #
# the launch plan and the kernel's indexing


def _source_constants():
    text = CSRC.read_text()
    return {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int (k\w+) = (\d+);", text)}


def test_constants_match_the_source():
    c = _source_constants()
    assert (c["kTaps"], c["kStride"], c["kPool"]) == (sf.KERNEL_SIZE, sf.STRIDE, sf.POOL)
    assert (c["kSteps"], c["kGroup"], c["kThreads"]) == (sf.STEPS, sf.GROUP, sf.THREADS)
    assert 32 * c["kPerThread"] == sf.WARP_POOLED and c["kThreads"] // 32 == sf.WARPS
    assert c["kBlocksPerSm"] == sf.BLOCKS_PER_SM


def _coverage(plan, batch):
    """How often the kernel stores each (stream, row slot, pooled frame):
    the grid-stride walk over items, each warp's (group, 32-frame sub-tile),
    each lane's frames 32 apart, kept where p < pooled. Returns the
    counts per item and per (group, frame of a tile)."""
    grid, items, tile, groups = plan["grid"], plan["items"], plan["tile"], plan["groups"]
    walked = np.concatenate([np.arange(blk, items, grid) for blk in range(grid)])
    per_item = np.bincount(walked, minlength=items)
    per_frame = np.zeros((groups, tile), int)
    for warp in range(sf.WARPS):
        g, first = warp % groups, (warp // groups) * sf.WARP_POOLED
        for lane in range(32):
            for q in range(sf.WARP_POOLED // 32):
                per_frame[g, first + lane + 32 * q] += 1
    return per_item, per_frame


@pytest.mark.parametrize("filters", [80, 160])
@pytest.mark.parametrize("batch", [1, 2, 128, 256, 528])
def test_launch_plan_writes_every_output_once(batch, filters):
    plan = sf.launch_plan(batch, 80000, filters, sms=132)
    assert plan["pooled"] == 2658 and plan["groups"] == filters // 20
    per_item, per_frame = _coverage(plan, batch)
    assert (per_item == 1).all() and (per_frame == 1).all()
    assert plan["tiles"] * plan["tile"] >= plan["pooled"] > (plan["tiles"] - 1) * plan["tile"]
    assert plan["items"] == batch * plan["tiles"] and 1 <= plan["grid"] <= 2 * 132
    assert 2 * plan["smem"] <= 228 * 1024  # two blocks an SM
    # the strip holds every sample a tile's frames read: frame 3 p + j, tap k
    reach = 30 * (plan["tile"] - 1) + 10 * 2 + 250
    assert plan["strip"] == reach + 1
    ops = sf.prepare_sinc_operands(*(_stacked() if filters == 160 else (_bank(), None)),
                                   banks=filters // 80)
    assert sorted(ops.rows.reshape(-1).tolist()) == list(range(filters))


def test_plan_at_other_lengths():
    for samples, pooled in ((251, 0), (271, 1), (301, 2), (16000, 525)):
        plan = sf.launch_plan(3, samples, 80, sms=132)
        assert plan["pooled"] == pooled == sf.num_pooled(samples)
        assert plan["items"] == 3 * plan["tiles"]


# ----------------------------------------------------------------------- #
# the operands


def _symmetric(filters, banks):
    """Whether each bank's first half of rows is exactly symmetric about the
    centre tap and its second half exactly antisymmetric with a zero centre."""
    per = filters.shape[0] // banks
    for b in range(banks):
        cos = filters[b * per: b * per + per // 2]
        sin = filters[b * per + per // 2: (b + 1) * per]
        if not (torch.equal(cos, cos.flip(1)) and torch.equal(sin, -sin.flip(1))
                and (sin[:, 125] == 0).all()):
            return False
    return True


def test_registry_and_stacked_banks_have_the_folded_layout():
    """The layout ``prepare_sinc_operands`` reads (left halves and centre
    taps only) holds bit for bit for the mel init that every registry
    SincNet starts from, for cutoffs moved in place (the benchmark's
    perturbed embedding, ``chip_smoke.py``'s ``perturb_sincnet``), for
    random cutoffs up to the Nyquist clip, and for the stacked bank; and the
    operands restate those halves exactly."""
    banks = [_bank(), _bank(11), _bank(12)]
    rng = np.random.default_rng(13)
    wide = sinc_filters(torch.from_numpy(rng.uniform(0, 8000, 40).astype(np.float32)),
                        torch.from_numpy(rng.uniform(0, 4000, 40).astype(np.float32)))
    for f in banks + [wide]:
        assert _symmetric(f, 1)
    stacked, bias = _stacked()
    assert _symmetric(stacked, 2)
    ops = sf.prepare_sinc_operands(stacked, bias, banks=2)
    taps = ops.taps.transpose(1, 2).reshape(-1, sf.STEPS)  # (F, 126) in column order
    rows = ops.rows.reshape(-1).long()
    even = torch.tensor([c % 20 < 10 for c in range(160)])
    assert torch.equal(taps[:, :125], stacked[rows, :125])
    assert torch.equal(taps[even, 125] * 2, stacked[rows[even], 125])
    assert (taps[~even, 125] == 0).all()
    assert (rows[even] % 80 < 40).all() and (rows[~even] % 80 >= 40).all()
    assert torch.equal(ops.shift.reshape(-1), bias[rows])


def test_malformed_calls_are_refused():
    """A bias beside prepared operands, a width the kernel does not take,
    fewer samples than taps, a device the op has no route for."""
    x = _wave(1, 4000)
    with pytest.raises(ValueError, match="prepared operands carry the bias"):
        sf.sinc_frontend(x, None, 10, torch.zeros(80), operands=sf.prepare_sinc_operands(_bank()))
    with pytest.raises(ValueError, match="bank"):
        sf.prepare_sinc_operands(_bank()[:60])
    with pytest.raises(ValueError, match="taps"):
        sf.sinc_frontend(_wave(1, 200), _bank(), 10)
    with pytest.raises(ValueError, match="unsupported device"):
        sf.sinc_frontend(x.to("meta"), _bank().to("meta"), 10)
