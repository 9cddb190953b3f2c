"""The check has to fail. A run at a tiny size on the CPU, the chip's look
skipped, with the timed path broken underneath, must come out not correct,
once for each fault a serving cell can have (a cell on one card has no
exchange between chips); and the control (the reference one precision step
below the configuration's, in the port's place) must read past a limit."""

import numpy as np
import pytest

from portbench import cell as cells
from portbench.run import run_cell

SEED = 2**31 + 3


def small(name):
    cell, config, traffic = cells.resolve(name)
    traffic = dict(traffic, batch=2, pool_streams=4, audio_blocks=12, checked_streams=2, settle_hops=1)
    if traffic["mode"] == "open":
        traffic["cohorts"] = 2
    return cell, config, traffic


def state_unchanged(engine):
    """Every step returns the state it was given."""
    step = engine._step_impl
    engine._step_impl = lambda state, *a: (state, step(state, *a)[1])


def half_left_out(engine):
    """The second half of the streams is left out of every step."""
    step = engine.step

    def half(state, blocks, audio_mask=None, run_mask=None):
        b = engine.batch_size
        keep = np.arange(b) < b // 2
        audio_mask = keep if audio_mask is None else np.asarray(audio_mask) & keep
        run_mask = keep if run_mask is None else np.asarray(run_mask) & keep
        return step(state, blocks, audio_mask, run_mask)

    engine.step = half


def score_altered(engine):
    """The last stream's scores nudged by 0.002 where the step produces them."""
    step = engine.step

    def nudged(*a, **k):
        state, out = step(*a, **k)
        agg = out.aggregated.clone()
        agg[-1] += 0.002 * (agg[-1] > 0)
        return state, out._replace(aggregated=agg)

    engine.step = nudged


FAULTS = {"state_unchanged": state_unchanged, "half_left_out": half_left_out, "score_altered": score_altered}


@pytest.mark.parametrize("name", ["xvector.saturate", "xvector.realtime"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(name, fault):
    cell, config, traffic = small(name)
    res = run_cell(cell, config, traffic, cells.load_benchmark(), SEED, 1.0, False, device="cpu",
                   fault=FAULTS[fault])
    assert not res["correct"], res["check"]


def test_text_altered_is_not_correct(monkeypatch):
    """A turn's speaker changed in the text the assembler produces."""
    from diart_tpu_torch import native

    assemble = native.rttm_from_bits

    def altered(*a, **k):
        texts = assemble(*a, **k)
        return [t.replace("speaker0 ", "speaker1 ", 1) if t else t for t in texts]

    monkeypatch.setattr(native, "rttm_from_bits", altered)
    cell, config, traffic = small("xvector.saturate")
    res = run_cell(cell, config, traffic, cells.load_benchmark(), SEED, 1.0, False, device="cpu")
    gap = res["check"]["score_gap"]
    assert not res["correct"] and (gap["value"] == "inf" or gap["value"] > gap["limit"])


@pytest.mark.parametrize("name", ["xvector.saturate", "ecapa.saturate"])
def test_control_is_not_correct(name):
    from portbench.control import control_numbers
    from portbench.judge import verdict

    cell, config, traffic = small(name)
    res = control_numbers(cell, config, traffic, SEED, 12, device="cpu")
    assert verdict(dict(res["reference"]), config["limits"])
    assert not verdict(dict(res["control"]), config["limits"]), res["control"]
