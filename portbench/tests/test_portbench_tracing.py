"""The readers of the program's step clock and admission records: a
traced run of a tiny serving cell on the CPU reads every one as a
number, the prefill cells list none of them, and each reads nothing
where the program has no ``repro_torch.tracing`` or no row of it lies
in the window."""
from __future__ import annotations

import sys
import time

import pytest

torch = pytest.importorskip("torch")

from portbench.harness import bench  # noqa: E402
from portbench.tests import tiny  # noqa: E402

METRICS = ("engine.control_ms_p50", "engine.control_ms_p95",
           "engine.issue_ms_p50", "engine.sync_wait_ms_p50",
           "engine.admit_wait_ms_p50")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("tinyroot"))


def _window_of_steps(monkeypatch, n: int) -> None:
    """The harness's window, stepped on until it holds ``n`` steps
    however loaded the host is (the 95th percentile reads 20 or more)."""
    from portbench.harness import serve
    real = serve.window

    def window(loop, seconds):
        w = real(loop, seconds)
        while len(w["steps"]) < n:
            w["steps"].append(loop.step())
        w["t1"] = w["steps"][-1]["t"]
        return w
    monkeypatch.setattr(serve, "window", window)


@pytest.mark.parametrize("cell", ["tiny-dense.bursts", "tiny-dense.calm"])
def test_traced_serving_run_reads_every_metric(root, cell, monkeypatch):
    ctx = bench.load_cell(root, cell)
    assert set(METRICS) <= {m["name"] for m in ctx["per_layer"]}
    _window_of_steps(monkeypatch, 24)
    out = bench.execute(ctx, 2 ** 31 + 29, 0.5, 1, torch.device("cpu"))
    got = out["result"]["metrics"]
    for name in METRICS:
        assert got[name]["unit"] == "ms" and got[name]["value"] >= 0, name
    # the control plane and the issue lie inside the step the harness
    # timed around each engine step
    step = got["engine.step_ms_p50"]["value"]
    assert got["engine.control_ms_p50"]["value"] < step
    assert got["engine.issue_ms_p50"]["value"] < step


@pytest.mark.parametrize("cell", ["jamba-v0.1-52b.repo_prefill",
                                  "tiny-hybrid.prefill"])
def test_prefill_cells_list_none(root, cell):
    names = {m["name"] for m in bench.load_cell(root, cell)["per_layer"]}
    assert not names & set(METRICS)


def _serve_run(t0: float, t1: float) -> dict:
    return {"kind": "serve", "t0": t0, "t1": t1}


@pytest.mark.parametrize("name", METRICS)
def test_reader_reads_nothing_without_the_module(root, monkeypatch, name):
    import repro_torch
    # the program as it was before it kept a step clock
    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    now = time.perf_counter()
    assert bench.reader(root, name)(_serve_run(now - 1e6, now)) is None


@pytest.mark.parametrize("name", METRICS)
def test_reader_reads_nothing_outside_the_window(root, name):
    from repro_torch import tracing
    read = bench.reader(root, name)
    # before any step this process could have taken
    assert read(_serve_run(-2.0, -1.0)) is None
    tracing.reset()
    now = time.perf_counter()
    assert read(_serve_run(now - 1e6, now)) is None
    assert read({"kind": "prefill", "t0": now - 1e6, "t1": now}) is None
