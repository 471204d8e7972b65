"""The port's trace schema and generator against the JAX package's: the
same seeds give field-for-field identical traces (numpy arrays exactly
equal) — the 144-task dataset of the characterization, the named Fig 8
traces, the escalation benchmark's spike corpus — and the same
allocation events."""
import dataclasses

import numpy as np
import pytest

from repro.traces import generator as JG
from repro.traces import schema as JS
from repro_torch.traces import generator as TG
from repro_torch.traces import schema as TS

FIG8 = (("dask/dask#11628", 1), ("sigmavirus24/github3.py#673", 2),
        ("sigmavirus24/github3.py#673", 3))


def as_plain(obj):
    """A dataclass tree as nested dicts/lists (ndarrays kept)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: as_plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [as_plain(x) for x in obj]
    return obj


def assert_same(a, b, where=""):
    """Exact equality, arrays by value and dtype, floats bit for bit."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def assert_traces_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        assert_same(as_plain(g), as_plain(w), g.task_id)


@pytest.mark.parametrize("model", ["haiku", "glm"])
def test_dataset_identical(model):
    """Half of the 144-task dataset each: 72 tasks of one model."""
    assert_traces_equal(TG.generate_dataset(model, 72, seed=0),
                        JG.generate_dataset(model, 72, seed=0))


def test_named_fig8_traces_identical():
    for name, seed in FIG8:
        assert_traces_equal([TG.named_trace(name, seed=seed)],
                            [JG.named_trace(name, seed=seed)])


def test_spike_corpus_and_alloc_events_identical():
    got = TG.generate_spike_corpus(8, seed=1)
    want = JG.generate_spike_corpus(8, seed=1)
    assert_traces_equal(got, want)
    assert max(t.peak_to_avg for t in got) == pytest.approx(15.4, rel=1e-9)
    named = [TG.named_trace(n, seed=s) for n, s in FIG8]
    jnamed = [JG.named_trace(n, seed=s) for n, s in FIG8]
    for g, w in zip(got + named, want + jnamed):
        ge = TS.to_alloc_events(g, accel=50.0)
        we = JS.to_alloc_events(w, accel=50.0)
        assert [(e.t_ms, e.delta_mb) for e in ge] == \
            [(e.t_ms, e.delta_mb) for e in we]
        # the tool span each event falls in is the same call
        assert [as_plain(e.tool) for e in ge] == [as_plain(e.tool)
                                                  for e in we]
