"""The port's precision policy against diart_tpu's on the CPU: the
``DIART_TPU_*`` variables of the five shared switches, their spellings,
``use(..., force=True)`` and nested scopes, and ``Precision.resolved``.

On the CPU the JAX package's TPU-only switches (``bf16_lstm``,
``bf16_frontend``) resolve to off whatever the variable says, as the
port's CUDA-only ones do for CPU tensors; the other three follow the
variable, then the policy, in both packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

from diart_tpu import precision as jax_precision
from diart_tpu_torch import EmbeddingModel, MultiStreamEngine, Precision, SegmentationModel, precision
from diart_tpu_torch.models.common import int8_trunk_enabled

SWITCHES = ("bf16_lstm", "bf16_frontend", "fbank_ring", "int8_trunk", "stack_frontend")
VARIABLES = {f: f"DIART_TPU_{f.upper()}" for f in SWITCHES}
SPELLINGS = ("0", "false", "off", "", "1", "on", " OFF ", "yes")
JAX_ONLY = ("DIART_TPU_PALLAS_LSTM", "DIART_TPU_PALLAS_HEAD", "DIART_TPU_PALLAS_ATTN",
            "DIART_TPU_PALLAS_RES2", "DIART_TPU_LSTM_BLOCK", "DIART_TPU_LSTM_BLOCK_K",
            "DIART_TPU_FAST_FBANK", "DIART_TPU_PHASED_RING")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in list(VARIABLES.values()) + list(JAX_ONLY):
        monkeypatch.delenv(name, raising=False)


def _pair(**switches):
    """The same policy in both packages (the JAX one's other switches at
    their defaults)."""
    return Precision(**switches), dataclasses.replace(jax_precision.Precision(), **switches)


def test_port_switches_are_the_shared_ones():
    assert tuple(f.name for f in dataclasses.fields(Precision)) == SWITCHES
    assert all(jax_precision._ENV_VARS[f] == VARIABLES[f] for f in SWITCHES)
    assert precision._ENV_VARS == VARIABLES


@pytest.mark.parametrize("field", SWITCHES)
@pytest.mark.parametrize("spelling", SPELLINGS)
def test_variable_resolves_as_jax(monkeypatch, field, spelling):
    """Under each spelling, with the policy's switch on and off, the port's
    ``enabled(field, "cpu")`` equals JAX's ``enabled(field)`` on the CPU."""
    monkeypatch.setenv(VARIABLES[field], spelling)
    for value in (False, True):
        port, jax = _pair(**{field: value})
        with precision.use(port), jax_precision.use(jax):
            got, want = precision.enabled(field, "cpu"), jax_precision.enabled(field)
        assert got == want, (field, repr(spelling), value)
        if field not in ("bf16_lstm", "bf16_frontend"):
            assert got == (spelling.strip().lower() not in ("0", "false", "off", ""))


@pytest.mark.parametrize("field", SWITCHES)
def test_unset_variable_leaves_the_policy(field):
    for value in (False, True):
        port, jax = _pair(**{field: value})
        with precision.use(port), jax_precision.use(jax):
            assert precision.enabled(field, "cpu") == jax_precision.enabled(field)


@pytest.mark.parametrize("field", SWITCHES)
def test_force_ignores_the_variable(monkeypatch, field):
    """``use(policy, force=True)`` ignores the variable in both packages;
    a nested scope without force reads it again, and leaving it restores
    the forced state."""
    monkeypatch.setenv(VARIABLES[field], "1")
    port, jax = _pair(**{field: False})
    with precision.use(port, force=True), jax_precision.use(jax, force=True):
        assert precision.enabled(field, "cpu") is False and jax_precision.enabled(field) is False
        inner_port, inner_jax = _pair(**{field: False})
        with precision.use(inner_port), jax_precision.use(inner_jax):
            assert precision.enabled(field, "cpu") == jax_precision.enabled(field)
            assert precision.enabled(field, "cpu") is (field not in ("bf16_lstm", "bf16_frontend"))
        assert precision.enabled(field, "cpu") is False and jax_precision.enabled(field) is False
    assert precision.enabled(field, "cpu") == jax_precision.enabled(field)


def test_scopes_nest_and_restore():
    base = precision.active()
    outer_policy, inner_policy = Precision(stack_frontend=True), Precision.portable()
    with precision.use(outer_policy, force=True) as outer:
        assert precision.active() is outer and precision._STATE.force
        with precision.use(inner_policy) as inner:
            assert precision.active() is inner and not precision._STATE.force
        assert precision.active() is outer and precision._STATE.force
    assert precision.active() is base and not getattr(precision._STATE, "force", False)
    with pytest.raises(RuntimeError):
        with precision.use(outer_policy, force=True):
            raise RuntimeError("leaves the scope")
    assert precision.active() is base and not getattr(precision._STATE, "force", False)


def test_unknown_switch_raises():
    with pytest.raises(KeyError):
        precision.enabled("pallas_lstm", "cpu")
    with pytest.raises(KeyError):
        jax_precision.enabled("not_a_switch")


def test_resolved_reports_the_variables(monkeypatch):
    """``Precision.resolved`` applies the device gate and the variables,
    as JAX's does its backend gate; under force it reports the policy."""
    monkeypatch.setenv("DIART_TPU_INT8_TRUNK", "1")
    monkeypatch.setenv("DIART_TPU_FBANK_RING", "off")
    monkeypatch.setenv("DIART_TPU_BF16_LSTM", "1")
    got = Precision().resolved("cpu")
    want = jax_precision.Precision().resolved()
    assert got == {f: want[f] for f in SWITCHES}
    assert got == dict(bf16_lstm=False, bf16_frontend=False, fbank_ring=False, int8_trunk=True,
                       stack_frontend=False)
    cuda = Precision().resolved("cuda")
    assert cuda["bf16_lstm"] and cuda["bf16_frontend"] and cuda["int8_trunk"] and not cuda["fbank_ring"]
    with precision.use(Precision(), force=True):
        assert Precision().resolved("cuda") == Precision().as_dict()
    assert int8_trunk_enabled("cpu") and int8_trunk_enabled(torch.device("cpu"))


@pytest.mark.parametrize("variable", JAX_ONLY)
def test_jax_only_variables_are_not_read(monkeypatch, variable):
    """The JAX-only switches' variables change nothing in the port."""
    want = {d: Precision().resolved(d) for d in ("cpu", "cuda")}
    for value in ("0", "1"):
        monkeypatch.setenv(variable, value)
        assert {d: Precision().resolved(d) for d in ("cpu", "cuda")} == want


# ---------------------------------------------------------------------- #
# the variables where the engine and the models resolve the policy
# ---------------------------------------------------------------------- #
SEG_KW = dict(num_speakers=3, lstm_hidden=8, lstm_layers=1, linear_dims=(8,))
ENGINE_KW = dict(duration=2.0, step=0.5, latency=0.5, tau_active=0.5, rho_update=0.1, delta_new=0.7,
                 max_speakers=8, sample_rate=16000, batch_size=2)


def _models(emb_name, **emb_kw):
    seg = SegmentationModel.from_registry("tpu/pyannet", device="cpu", seed=0, **SEG_KW)
    emb = EmbeddingModel.from_registry(emb_name, device="cpu", seed=1, **emb_kw)
    if emb_name == "tpu/xvector":  # a filterbank of its own, so the two SincNets stack
        with torch.no_grad():
            emb.module.sincnet.wav_norm_scale.mul_(1.5)
    return seg, emb


def _scores(engine, hops=6):
    rng = np.random.default_rng(3)
    state, outs = engine.init_state(), []
    for i in range(hops):
        block = (0.1 * rng.normal(size=(2, 8000))).astype(np.float32)
        state, out = engine.step(state, block, run_mask=np.full(2, i >= 3))
        outs.append(out.aggregated.clone())
    return outs


@pytest.mark.parametrize("field, value, emb", [
    ("fbank_ring", "0", ("tpu/ecapa", dict(embedding_dim=16, channels=32))),
    ("stack_frontend", "1", ("tpu/xvector", dict(embedding_dim=16))),
    ("int8_trunk", "1", ("tpu/xvector", dict(embedding_dim=16))),
])
def test_engine_honours_the_variable(monkeypatch, field, value, emb):
    """An engine built under ``DIART_TPU_<FIELD>`` with the default policy
    gives bitwise the scores of one built with the matching ``Precision``
    and no variable (the engine resolves ``fbank_ring`` and
    ``stack_frontend`` at construction, the models ``int8_trunk`` at each
    call)."""
    seg, model = _models(emb[0], **emb[1])
    policy = dataclasses.replace(Precision(), **{field: value == "1"})
    want_engine = MultiStreamEngine(seg, model, precision=policy, **ENGINE_KW)
    want = _scores(want_engine)
    default_engine = MultiStreamEngine(seg, model, precision=Precision(), **ENGINE_KW)
    default = _scores(default_engine)
    monkeypatch.setenv(VARIABLES[field], value)
    got_engine = MultiStreamEngine(seg, model, precision=Precision(), **ENGINE_KW)
    got = _scores(got_engine)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    layout = lambda e: (e._fring is None, e._stacked is None)
    assert layout(got_engine) == layout(want_engine)
    if field == "int8_trunk":  # the variable changed the numbers
        assert not all(torch.equal(a, b) for a, b in zip(got, default))
    else:  # the variable changed what the engine built
        assert layout(got_engine) != layout(default_engine)
