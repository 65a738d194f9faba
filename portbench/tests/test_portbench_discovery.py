"""Cells, configurations, mixes and metrics are found by name from files:
a new mix and a BENCHMARK.json entry make a new cell with no code edited."""

import json
import shutil

from conftest import ROOT
from portbench.harness import Cell


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_finds_its_files():
    bench = _bench()
    for w in bench["workloads"]:
        cell = Cell(w["name"])
        assert cell.scene().n_triangles == cell.cfg["triangles"]
        assert cell.traffic["spp_per_call"] >= 1
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]))


def test_a_new_mix_is_files_only(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "portbench" / "traffic" / "burst.json").write_text(json.dumps(
        {"spp_per_call": 4, "warm_spp": 4, "reference_spp": 32}))
    bench = _bench()
    bench["workloads"].append({"name": "cornell-box.burst",
                               "config": "cornell-box", "traffic": "burst",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "commit_s", "unit": "s",
                               "better": "lower", "source": "program_span",
                               "layer": "host scene build",
                               "moves": "setup_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = Cell("cornell-box.burst", root=tmp_path)
    assert cell.traffic["spp_per_call"] == 4
    assert cell.config_name == "cornell-box"
    assert [m["name"] for m in cell.per_layer] == ["commit_s"]
    assert cell.reader("commit_s")({"commit_s": 1.5}) == 1.5
    # an end-to-end metric listing other cells is not this cell's
    assert "pass_ms_p90" not in [m["name"] for m in cell.end_to_end]


def test_benchmark_names_and_units():
    import re
    bench = _bench()
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[key]:
            assert name.match(e["name"]), e["name"]
            if "unit" in e:
                assert unit.match(e["unit"]), e["unit"]
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
