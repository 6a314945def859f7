"""``BENCHMARK.json`` and the files it names, found by name: a cell of
``workloads`` resolves its configuration (the entry's ``file``), its
traffic mix (``bench/traffic/<traffic>.json``), its own settings
(``bench/workloads/<cell>.json``: how many batches the comparison and
the trace take, and the comparison's limit) and the readers of the
metrics it reports (``bench/metrics/<metric>.py``, each with a
``read(run)`` that returns a number, or None where it finds nothing to
read)."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

from . import traffic
from .reference import spec as model_spec

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    model: dict                    # the configuration file
    spec: model_spec.ModelSpec
    mix: traffic.Mix
    settings: dict                 # bench/workloads/<cell>.json
    end_to_end: list               # the metric entries this cell reports
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, name: str, root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    model = json.loads((root / conf["file"]).read_text())
    return Cell(
        name=name, chips=int(w["chips"]), model=model,
        spec=model_spec.from_dict(model),
        mix=traffic.load(HERE / "traffic" / f"{w['traffic']}.json"),
        settings=json.loads((HERE / "workloads" / f"{name}.json")
                            .read_text()),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)])


def reader(metric: str):
    """The ``read`` function of ``bench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    sp = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read
