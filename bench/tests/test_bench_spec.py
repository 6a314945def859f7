"""``BENCHMARK.json`` as data: every cell resolves its files by name, the
names and units keep to their characters, every per-layer metric moves an
end-to-end metric its cells report, and each cell takes one chip."""
from __future__ import annotations

import json
import re

import pytest
import torch

import cells
from bench import judge, run, spec

from repro_torch.configs import get_config

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((cells.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_resolves_its_files_by_name(cell):
    c = spec.resolve(BENCH, cell)
    assert c.chips == 1
    assert c.mix.batch > 0 and c.spec.n_layers > 0
    assert set(c.settings) == {"check_batches", "trace_batches", "limits"}
    assert set(c.settings["limits"]) <= set(judge.stats(torch.zeros(1),
                                                        torch.zeros(1)))
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))
    run.program_config(c.model)         # the program can run the file
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


def test_the_judges_numbers():
    gen = torch.Generator().manual_seed(0)
    g, floor = torch.rand(8256, generator=gen), torch.rand(8256, generator=gen)
    want = {"logit_gap_max": g.double().max().item(),
            "logit_gap_mean": g.double().mean().item()}
    assert judge.stats(g) == want
    assert judge.stats(g, floor) == dict(want, logit_gap_mean_excess=(
        g.double().mean() - floor.double().mean()).item())


def test_names_units_and_text():
    for entry in BENCH["configs"] + BENCH["workloads"] + METRICS:
        assert NAME.match(entry["name"]), entry["name"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in BENCH["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["why"]) <= 200
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    assert len(set(CELLS)) == len(CELLS)


def test_end_to_end_metrics():
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert spec.reports(e2e[m["moves"]], cell), (m["name"], cell)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_configs_name_their_source_and_changes():
    for c in BENCH["configs"]:
        assert c["file"].startswith("bench/configs/")
        model = json.loads((cells.ROOT / c["file"]).read_text())
        assert model["name"] == c["name"] and model["source"] == c["source"]
        assert all(k in model for k in c["reduced"])
        assert model["departures"] and model["assumed"]
        # the program's own registry entry, but for what the file changes
        cfg = run.program_config(model)
        reg = get_config(model["port_arch"])
        changed = {"d_ff": cfg.d_ff} if "intermediate_size" in \
            model["changed"] else {}
        assert cfg.hd == reg.hd
        assert cfg.with_(notes="", head_dim=None) == reg.with_(
            notes="", head_dim=None, **changed)
