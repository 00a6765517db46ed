"""The harness on the card, at small sizes (marked ``cuda``; each test
skips where no card is there):

    python3 -m pytest bench_gpu/test_bench_gpu_cuda.py -q -m cuda
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_gpu import run, spec

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run.pin_caches()
    return torch.device("cuda")


def small(name: str) -> spec.Cell:
    cell = spec.load_cell(name)
    cell.config = dict(cell.config, rows=600_000)
    cell.traffic = dict(cell.traffic, pool_rate_per_s=60)
    return cell


def test_generator_is_deterministic_on_the_card(card):
    cell = small("sift128.batch")
    a = run.make_inputs(cell, 2**31 + 3, card, 200)
    b = run.make_inputs(cell, 2**31 + 3, card, 200)
    assert np.array_equal(a.rows, b.rows) and np.array_equal(a.pool, b.pool)


@pytest.mark.parametrize("name", ["sift128.batch", "gist960.batch",
                                  "sift128.batch-ordered"])
def test_traced_run_on_the_card(card, name):
    cell = small(name)
    result, lines = run.run_cell(cell, seed=5, seconds=3.0, trace=True,
                                 device=card)
    assert result["correct"] is True, lines
    dev = result["device"]
    assert dev["platform"] == "gpu" and dev["busy_s"] > 0
    assert 0 < dev["busy_s"] <= dev["window_s"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert 0 < m["kernels_roofline"] <= 100
    assert 0 <= m["device_idle_pct"] < 100
    for key in ("select_bins_roofline", "scan_topk_roofline"):
        if key in m:
            assert 0 < m[key] <= 100


def test_untraced_run_on_the_card(card):
    result, lines = run.run_cell(small("sift128.batch"), seed=6,
                                 seconds=3.0, trace=False, device=card)
    assert result["correct"] is True, lines
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert m["mem_bytes_per_row"] > 512 and m["qps"] > 0
