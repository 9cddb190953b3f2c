"""Every cell of BENCHMARK.json resolves its files by name, and a cell added
as data files and an entry alone is picked up."""

import json
import shutil

import pytest

from portbench import cell as cells
from portbench.run import metric_reader

ROOT = cells.ROOT
BENCH = cells.load_benchmark()


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(name):
    cell, config, traffic = cells.resolve(name)
    assert cell["config"] == config["name"]
    assert traffic["mode"] in ("closed", "open")
    for role in ("segmentation", "embedding"):
        assert (ROOT / "portbench" / "reference" / f"{config[role]['reference']}.py").exists()
        assert (ROOT / "portbench" / "work" / f"{config[role]['reference']}.py").exists()
    assert set(config["limits"]) == {"score_gap", "cluster_gap"}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found(metric):
    assert callable(metric_reader(metric))


def test_every_metric_reported_somewhere():
    names = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", names)) <= names
    for w in names:
        e2e = [m for m in BENCH["end_to_end"] if w in m.get("workloads", names)]
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert any(w in m.get("workloads", names) for m in BENCH["per_layer"])


def test_cell_added_as_data_is_picked_up(tmp_path):
    """A copy of the tree with a new configuration file, a new traffic file
    and their entries: the new cell resolves with no code edited."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / "portbench/configs/pyannet-xvector.json").read_text())
    config["name"] = "pyannet-xvector-wide"
    config["engine"]["max_speakers"] = 24
    (tmp_path / "portbench/configs/pyannet-xvector-wide.json").write_text(json.dumps(config))
    traffic = json.loads((ROOT / "portbench/traffic/saturate.json").read_text())
    traffic["batch"] = 512
    (tmp_path / "portbench/traffic/saturate-b512.json").write_text(json.dumps(traffic))
    bench["configs"].append(dict(bench["configs"][0], name="pyannet-xvector-wide",
                                 file="portbench/configs/pyannet-xvector-wide.json"))
    bench["workloads"].append(dict(name="wide.b512", config="pyannet-xvector-wide", traffic="saturate-b512",
                                   chips=1, why="a test cell"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell, config, traffic = cells.resolve("wide.b512", root=tmp_path)
    assert config["engine"]["max_speakers"] == 24 and traffic["batch"] == 512
