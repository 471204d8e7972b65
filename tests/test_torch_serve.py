"""The port's closed-loop retuner in the serving engine, and its serving
driver, against the JAX package's: ``EngineConfig(adaptive=...)`` with
thresholds the run never crosses and with the settings of
``tests/test_engine.py`` under which the retuner acts (the same reports,
the same retune actions on the engine's step clock), and
``repro_torch.launch.serve --reduced --device cpu`` against
``repro.launch.serve.run`` with the same arguments (the same report)."""
import argparse
import contextlib
import dataclasses
import io

import jax
import numpy as np
import pytest
import torch

from repro.core import adaptive as JA
from repro.core import domains as JD
from repro.launch import serve as JServe
from repro.serving import session as JS
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.core import adaptive as TA
from repro_torch.core import domains as TD
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch import serve as TServe
from repro_torch.models import model as TM
from repro_torch.serving import session as TS
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import EngineConfig as TEngineConfig

COMMON = dict(max_slots=4, s_max=384, pool_pages=40, page_tokens=16,
              mode="inkernel", use_freeze=True,
              session_high={"lo1": 12, "lo2": 12})
# (AdaptiveConfig kwargs, does the retuner act?)
ADAPTIVE = {
    "never_fires": (dict(high_frac=2.0), False),
    "acts": (dict(high_frac=0.01, low_frac=0.0, cooldown_ms=50.0,
                  watch=("/t/lo1", "/t/lo2")), True),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU engine runs many small matmuls, faster on one
    thread than on many, and far faster where test workers share the
    cores; the reports follow session phases, not token values."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def sessions(S, D):
    """The three sessions of ``tests/test_engine.py``, in either package."""
    return [
        S.Session(sid="hi", tenant="t", priority=D.HIGH,
                  prompt=list(range(2, 34)),
                  phases=[S.Phase(8, 96, "test"), S.Phase(8, 64, "git"),
                          S.Phase(12, 0)]),
        S.Session(sid="lo1", tenant="t", priority=D.LOW,
                  prompt=list(range(2, 26)),
                  phases=[S.Phase(8, 160, "test"), S.Phase(8, 96, "test"),
                          S.Phase(8, 0)]),
        S.Session(sid="lo2", tenant="t", priority=D.LOW,
                  prompt=list(range(2, 26)),
                  phases=[S.Phase(8, 160, "test"), S.Phase(8, 96, "test"),
                          S.Phase(8, 0)]),
    ]


def events(eng):
    return [(e.render(), e.t_ms) for e in eng._adaptive.events]


@pytest.fixture(scope="module")
def jax_runs(tiny_llama):
    cfg, params = tiny_llama
    out = {}
    for name, (kw, _) in ADAPTIVE.items():
        eng = JEngine(cfg, params, ecfg=JEngineConfig(
            **COMMON, adaptive=JA.AdaptiveConfig(**kw)), seed=0)
        for s in sessions(JS, JD):
            eng.submit(s)
        eng.run(6000)
        out[name] = (eng.report(), events(eng))
    return out


@pytest.fixture(scope="module")
def torch_model(tiny_llama):
    _, params = tiny_llama
    tcfg = dataclasses.replace(t_reduced(t_get_config("llama3.2-3b")),
                               dtype="float32")
    return tcfg, TM.params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")


@pytest.mark.parametrize("name", list(ADAPTIVE))
def test_adaptive_engine_identical(jax_runs, torch_model, name):
    kw, acts = ADAPTIVE[name]
    tcfg, tparams = torch_model
    eng = TEngine(tcfg, tparams, ecfg=TEngineConfig(
        **COMMON, adaptive=TA.AdaptiveConfig(**kw)), seed=0, device="cpu")
    for s in sessions(TS, TD):
        eng.submit(s)
    reset_launch_counts()
    eng.run(6000)
    report, evs = jax_runs[name]
    assert eng.report() == report
    assert events(eng) == evs
    assert bool(evs) == acts
    assert set(launch_counts().values()) == {0}
    if acts:
        bumps = [e for e in eng._adaptive.events if e.action == "bump_high"]
        assert bumps and all(e.t_ms == int(e.t_ms) for e in bumps)


# the driver's defaults, and a pool the sessions overrun (freezes act),
# the latter also on the recurrent xLSTM
SERVE_ARGS = [[], ["--pool-pages", "32"],
              ["--pool-pages", "32", "--arch", "xlstm-350m"]]


@pytest.mark.parametrize("extra", SERVE_ARGS,
                         ids=["defaults", "tight", "xlstm_tight"])
def test_serve_reduced_cpu_matches_reference(extra):
    """``python -m repro_torch.launch.serve --reduced --device cpu`` and
    the reference driver on the same arguments: the same report."""
    args = TServe.parser().parse_args(["--reduced", "--device", "cpu"]
                                      + extra)
    jargs = argparse.Namespace(**{k: v for k, v in vars(args).items()
                                  if k not in ("reduced", "device",
                                               "layers")})
    with contextlib.redirect_stdout(io.StringIO()) as got_out:
        got = TServe.run(args)
    with contextlib.redirect_stdout(io.StringIO()) as want_out:
        want = JServe.run(jargs)
    assert got == want
    assert got_out.getvalue() == want_out.getvalue()
    assert got["completed"] == args.sessions
    if extra:
        assert got["freezes"] > 0


def test_serve_defaults_to_the_card():
    import torch
    args = TServe.parser().parse_args(["--reduced"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TServe.serve(args)
