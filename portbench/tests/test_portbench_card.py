"""On the card (``python -m pytest portbench/tests -m card``): each cell
served for a short window at its own size comes out correct, and the control
at the cell's own size does not."""

import pytest

from portbench import cell as cells
from portbench.judge import verdict

BENCH = cells.load_benchmark()


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_correct_on_card(card, name):
    from portbench.run import run_cell

    cell, config, traffic = cells.resolve(name)
    res = run_cell(cell, config, traffic, BENCH, 2**31 + 101, 3.0, False, device=card)
    assert res["correct"] and res["failed"] == 0, res["check"]


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_control_not_correct_on_card(card, name):
    from portbench.control import control_numbers

    cell, config, traffic = cells.resolve(name)
    res = control_numbers(cell, config, traffic, 2**31 + 103, 64, device=card)
    assert verdict(dict(res["reference"]), config["limits"])
    assert not verdict(dict(res["control"]), config["limits"]), res["control"]
