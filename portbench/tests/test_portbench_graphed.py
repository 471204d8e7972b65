"""The reader of ``engine.graphed_share``: a traced run of a tiny serving
cell on the CPU reads 0 (the CPU runs no graph), the prefill cells do not
list it, it reads the share of step rows marked ``graphed``, and nothing
from a step clock without that column, without ``repro_torch.tracing``
or outside the window."""
from __future__ import annotations

import sys
import time

import pytest

torch = pytest.importorskip("torch")

from portbench.harness import bench  # noqa: E402
from portbench.tests import tiny  # noqa: E402
from portbench.tests.test_portbench_tracing import (  # noqa: E402
    _serve_run, _window_of_steps)

GRAPHED = "engine.graphed_share"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("tinyroot"))


@pytest.mark.parametrize("cell", ["tiny-dense.bursts", "tiny-dense.calm"])
def test_graphed_share_reads_0_on_the_cpu(root, cell, monkeypatch):
    ctx = bench.load_cell(root, cell)
    assert GRAPHED in {m["name"] for m in ctx["per_layer"]}
    _window_of_steps(monkeypatch, 24)
    out = bench.execute(ctx, 2 ** 31 + 31, 0.5, 1, torch.device("cpu"))
    assert out["result"]["metrics"][GRAPHED] == {"value": 0.0, "unit": "%"}


@pytest.mark.parametrize("cell", ["jamba-v0.1-52b.repo_prefill",
                                  "tiny-hybrid.prefill"])
def test_prefill_cells_do_not_list_it(root, cell):
    names = {m["name"] for m in bench.load_cell(root, cell)["per_layer"]}
    assert GRAPHED not in names


@pytest.mark.parametrize("marks,share", [((1, 1, 1, 1), 100.0),
                                         ((0, 1, 1, 1), 75.0)])
def test_graphed_share_reads_the_marked_rows(root, marks, share):
    from repro_torch import tracing
    read = bench.reader(root, GRAPHED)
    tracing.reset()
    t0 = time.perf_counter()
    for i, graphed in enumerate(marks):
        now = time.perf_counter_ns()
        tracing.record_step(-1, i, [now] * (len(tracing.PHASES) + 1),
                            graphed)
    assert read(_serve_run(t0, time.perf_counter())) == share


def test_graphed_share_reads_nothing_from_a_clock_without_the_column(
        root, monkeypatch):
    from repro_torch import tracing
    # the step clock as it was before it marked graphed steps
    t0 = time.perf_counter()
    now = time.perf_counter_ns()
    tracing.record_step(-1, 0, [now] * (len(tracing.PHASES) + 1), 1)
    real = tracing.steps
    monkeypatch.setattr(tracing, "steps", lambda: {
        k: v for k, v in real().items() if k != "graphed"})
    read = bench.reader(root, GRAPHED)
    assert read(_serve_run(t0, time.perf_counter())) is None


def test_graphed_share_reads_nothing_without_the_module(root, monkeypatch):
    import repro_torch
    # the program as it was before it kept a step clock
    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    now = time.perf_counter()
    assert bench.reader(root, GRAPHED)(_serve_run(now - 1e6, now)) is None


def test_graphed_share_reads_nothing_outside_the_window(root):
    from repro_torch import tracing
    read = bench.reader(root, GRAPHED)
    # before any step this process could have taken
    assert read(_serve_run(-2.0, -1.0)) is None
    tracing.reset()
    now = time.perf_counter()
    assert read(_serve_run(now - 1e6, now)) is None
    assert read({"kind": "prefill", "t0": now - 1e6, "t1": now}) is None
