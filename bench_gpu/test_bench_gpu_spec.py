"""BENCHMARK.json against the benchmark's contract, every file a cell
names found by its name, and the imports of the benchmark's modules."""

from __future__ import annotations

import ast
import glob
import json
import os
import re
import sys

import pytest

from bench_gpu import run, spec
from bench_gpu.spec import load_file
from bench_gpu.trace import load_bounds

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]
MODULES = sorted(glob.glob(os.path.join(spec.HERE, "**", "*.py"),
                           recursive=True))


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_gpu"]
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert LINE.match(word) and not word.startswith("/")
        assert ".." not in word
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_check_fits_its_time():
    cells = 24  # later PRs may add cells up to the limit
    runs = 2 + 14 * cells
    total = runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_entries():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for entry in BENCH[group]:
            assert set(entry) == keys
            assert NAME.match(entry["name"])
            assert LINE.match(entry["why"])
            assert (group, entry["name"]) not in seen
            seen.add((group, entry["name"]))
    metric_names = set()
    for group in ("end_to_end", "per_layer"):
        for m in BENCH[group]:
            extra = set(m) - {"workloads"}
            want = ({"name", "unit", "better", "bound", "source"}
                    if group == "end_to_end" else
                    {"name", "unit", "better", "source", "layer", "moves"})
            assert extra == want
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
            assert m["name"] not in metric_names
            metric_names.add(m["name"])
            for cell in m.get("workloads", []):
                assert cell in CELLS
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert LINE.match(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_enough():
    pairs = set()
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"], BENCH)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = spec.load_cell(cell, BENCH)
    assert c.config["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    assert c.traffic["name"] == next(
        w["traffic"] for w in BENCH["workloads"] if w["name"] == cell)
    for key in ("rows", "dim", "metric", "generator", "guarantee",
                "reduced", "assumed", "limits"):
        assert key in c.config
    assert set(c.config["limits"]) == {"bad_answers", "sim_err", "rank_gap"}
    for key in ("loop", "clients", "request_queries", "k", "engine",
                "load_order", "warmup_requests", "pool_rate_per_s",
                "check_per_request"):
        assert key in c.traffic
    for folder, name in (("gen", c.config["generator"]["kind"]),
                         ("reference", c.config["metric"]),
                         ("loops", c.traffic["loop"])):
        assert os.path.isfile(os.path.join(spec.HERE, folder, name + ".py"))
    for m in c.end_to_end + c.per_layer:
        reader = load_file(spec.metric_path(m["name"]), "t_" + m["name"])
        assert callable(reader.read)


@pytest.mark.parametrize("where,change,said", [
    ("config", {"metric": "hamming"}, "reference/hamming.py"),
    ("config", {"generator": {"kind": "sift_files"}}, "gen/sift_files.py"),
    ("config", {"metric": "../run"}, "metric '../run'"),
    ("traffic", {"loop": "open"}, "loops/open.py"),
    ("traffic", {"clients": 32}, "drives one client"),
])
def test_a_cell_the_harness_cannot_run_is_refused(monkeypatch, where,
                                                   change, said):
    cell = spec.load_cell(CELLS[0], BENCH)
    assert spec.refusal(cell.config, cell.traffic) is None
    cfg, mix = dict(cell.config), dict(cell.traffic)
    (cfg if where == "config" else mix).update(change)
    assert said in spec.refusal(cfg, mix)
    load_json = spec.load_json

    def changed(path):
        data = load_json(path)
        folder = os.path.basename(os.path.dirname(path))
        return dict(data, **change) if (folder == "traffic") == (
            where == "traffic") else data

    monkeypatch.setattr(spec, "load_json", changed)
    with pytest.raises(ValueError, match=re.escape(said)):
        spec.load_cell(CELLS[0], BENCH)


def test_config_files_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for entry in BENCH["configs"]:
        assert entry["file"].startswith("bench_gpu/")
        data = spec.load_json(os.path.join(spec.ROOT, entry["file"]))
        assert data["reduced"] == entry["reduced"]
        assert len(entry["reduced"]) <= 16


def test_every_metric_has_a_reader():
    for group in ("end_to_end", "per_layer"):
        for m in BENCH[group]:
            assert os.path.exists(spec.metric_path(m["name"]))


def test_bound_files_name_a_port_entry():
    bounds = load_bounds()
    assert set(bounds) == {
        "scan_topk", "scan_topk_hamming", "count_gt_eq", "count_hamming",
        "block_score", "select_bins", "scan_topk_bf16", "scan_topk_int8"}
    peaks = spec.load_peaks()
    for name, b in bounds.items():
        mod, fn = b.ENTRY.split(":")
        assert mod.startswith("redis_hnsw_tpu_torch.ops.")
        assert b.PEAK in peaks and callable(b.cost)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


@pytest.mark.parametrize("path", MODULES,
                         ids=[os.path.relpath(p, spec.HERE) for p in MODULES])
def test_no_jax_in_any_module(path):
    assert not _imports(path) & set(run.FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    for path in glob.glob(os.path.join(spec.HERE, "reference", "*.py")):
        tops = _imports(path)
        assert "redis_hnsw_tpu_torch" not in tops
        assert not tops & set(run.FORBIDDEN)


def test_nothing_reads_the_jax_side_benchmarks():
    banned = {"benchmarks", "bench", "chip_smoke"}
    for path in MODULES:
        assert not _imports(path) & banned
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                for arg in node.args:
                    if isinstance(arg, ast.Constant) and isinstance(
                            arg.value, str):
                        assert "chip_smoke" not in arg.value
                        assert "benchmarks/" not in arg.value


def test_forbidden_modules_compare_whole_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "redis_hnsw_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "redis_hnsw_tpu.ops", sys)
    assert run.loaded_forbidden() == ["jax", "redis_hnsw_tpu"]
