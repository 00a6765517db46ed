"""A cell of ``BENCHMARK.json`` and the files it names.

The harness finds everything by name: the configuration at the path its
``configs`` entry gives, the traffic mix at ``traffic/<traffic>.json``,
the configuration's generator at ``gen/<generator.kind>.py``, the plain
reference of its metric at ``reference/<metric>.py``, the mix's traffic
driver at ``loops/<loop>.py``, each metric's reader at
``metrics/<name>.py``, each kernel's bound at ``bounds/<kernel>.py`` and
the peaks in ``peaks.json``. A cell whose files name a generator, a
metric or a loop that has no file here, or whose mix its loop does not
accept, is refused when it is loaded, before anything runs.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PACKAGE = "bench_gpu"
MODULE_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list   # the cell's BENCHMARK.json metric entries
    per_layer: list


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: str, name: str):
    """Import the python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


WHAT = {"gen": "generator", "reference": "metric", "loops": "loop"}


def part(folder: str, name: str) -> str:
    """The module ``bench_gpu.<folder>.<name>`` (a generator, the reference
    of a metric or a traffic driver), refused unless ``<folder>/<name>.py``
    is here."""
    if not (isinstance(name, str) and MODULE_NAME.match(name)
            and os.path.isfile(os.path.join(HERE, folder, f"{name}.py"))):
        raise ValueError(f"{WHAT[folder]} {name!r} is not implemented: "
                         f"the benchmark has no {folder}/{name}.py")
    return f"{PACKAGE}.{folder}.{name}"


def refusal(config: dict, traffic: dict) -> str | None:
    """Why the harness cannot run this configuration under this mix, or
    None where it can: each part it names has its file, and the mix's
    loop accepts the mix."""
    try:
        part("gen", config["generator"]["kind"])
        part("reference", config["metric"])
        loop = importlib.import_module(part("loops", traffic["loop"]))
    except KeyError as e:
        return f"no {e} key"
    except ValueError as e:
        return str(e)
    return loop.refusal(traffic)


def load_cell(name: str, bench: dict | None = None,
              root: str = ROOT) -> Cell:
    bench = load_benchmark(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cell = Cell(
        name=name,
        chips=int(w["chips"]),
        config=load_json(os.path.join(root, cfg["file"])),
        traffic=load_json(os.path.join(HERE, "traffic",
                                       w["traffic"] + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
    )
    why = refusal(cell.config, cell.traffic)
    if why:
        raise ValueError(f"{name}: {why}")
    return cell


def metric_path(name: str) -> str:
    return os.path.join(HERE, "metrics", name + ".py")


def load_peaks() -> dict:
    return load_json(os.path.join(HERE, "peaks.json"))
