"""The port's evaluation twins (``repro_torch.evaluation``) against their
sources in ``benchmarks/`` on the CPU:

  characterization       the returned rows and the printed table identical;
  mismatch               the dict, the lines and every replay it runs
                         identical (event logs by time, kind and path);
  multitenant_isolation  ``run_fairness(steps=400)``: shares and P99 gaps
                         equal, the lines equal but the sched-steps/s
                         figure; ``run_config`` at 8 tenants, 200 steps, a
                         pool of 256: the reference on 8 fake devices in a
                         subprocess, every tenant row and the victims'
                         denial rate equal to the port's at 8 shards;
  throttle_precision     the mechanism's (ms, err) equal; the wall clock at
                         a 200 ms delay reopening at the mechanism's step
                         after at least 200 ms;
  engine_overhead        a few steps with the device and the async
                         backend: every engine run's ``report()`` equal,
                         the returned keys equal, the lines equal but their
                         timings; the fused-kernel gate's lines, its
                         cost-model line from the port's roofline;
  engine_fig8            the three reports and the printed table equal;
  roofline_table         records shaped like ``launch/dryrun.py``'s give
                         the source's rows;
  run                    every section replaced by a recorder: the twin
                         calls the source's sections in its order with its
                         arguments.

Each twin that holds tensors raises when asked for the card without one.
No timing gate runs here; ``chip_smoke.py`` runs them on the card.
"""
import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
torch = pytest.importorskip("torch")

from test_torch_replay import plain, recorded
from repro_torch.core import cgroup as TC
from repro_torch.evaluation import characterization as CH
from repro_torch.evaluation import engine_fig8 as EF8
from repro_torch.evaluation import engine_overhead as EO
from repro_torch.evaluation import mismatch as MM
from repro_torch.evaluation import multitenant_isolation as MT
from repro_torch.evaluation import roofline_table as RT
from repro_torch.evaluation import run as RUN
from repro_torch.evaluation import throttle_precision as TP

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small CPU ops: faster on one thread, and far faster where
    test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(path: str):
    spec = importlib.util.spec_from_file_location(
        "ref_" + Path(path).stem, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def call(fn, *a, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*a, **kw)
    return result, out.getvalue()


NUMBER = re.compile(r"[-+]?\d+(\.\d+)?")


def masked(text: str) -> list:
    """The printed lines with every number replaced (timings differ)."""
    return [NUMBER.sub("#", line) for line in text.splitlines()]


def test_characterization_identical():
    ref = load("benchmarks/characterization.py")
    want, want_out = call(ref.run)
    got, got_out = call(CH.run)
    assert got_out == want_out
    assert plain(got) == plain(want)


def test_mismatch_identical(monkeypatch):
    ref = load("benchmarks/mismatch.py")
    ref_runs, port_runs = recorded(monkeypatch, ref), recorded(monkeypatch,
                                                                MM)
    want, want_out = call(ref.run)
    got, got_out = call(MM.run)
    assert got_out == want_out
    assert plain(got) == plain(want)
    assert len(port_runs) == len(ref_runs) > 0
    for g, w in zip(port_runs, ref_runs):
        assert plain(g.summary()) == plain(w.summary())
        assert [(e.t_ms, e.kind.value, e.domain) for e in g.log.events] \
            == [(e.t_ms, e.kind.value, e.domain) for e in w.log.events]


def jax_up() -> None:
    """Start this process's JAX backend before a source module that sets
    ``XLA_FLAGS`` to 8 fake devices at import is loaded: the flag then
    changes nothing here (the other tests of the worker keep one device),
    and the caller restores the variable for later subprocesses."""
    import jax
    jax.devices()


@pytest.fixture(scope="module")
def mt_ref():
    """The reference's multitenant module, ``XLA_FLAGS`` restored as soon
    as it is loaded (it sets 8 fake devices at import)."""
    jax_up()
    before = os.environ.get("XLA_FLAGS")
    try:
        return load("benchmarks/multitenant_isolation.py")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


def test_fairness_matches_source(mt_ref):
    want, want_out = call(mt_ref.run_fairness, steps=400)
    got, got_out = call(MT.run_fairness, steps=400, device="cpu")
    for label in ("weighted", "uniform"):
        assert got[label]["share"] == want[label]["share"]
        assert got[label]["p99_gap"] == want[label]["p99_gap"]
    rate = re.compile(r"\(\d+ sched-steps/s\)")
    assert rate.sub("", got_out) == rate.sub("", want_out)
    assert rate.search(got_out)


# The reference's run_config on 8 fake devices, its dict printed as JSON.
# Its eager ``ShardedDeviceView.uncharge`` compiles a shard_map on every
# call (~9 s a step on the CPU); the harness wraps the same function in
# ``jax.jit`` once per view, which computes the same integers.
_MT_8DEV = r"""
import functools, json, sys
import jax
from repro.core import sharded as S

inner = S.ShardedDeviceView.uncharge
jitted = {}

def uncharge(self, state, dom, amt):
    if id(self) not in jitted:
        jitted[id(self)] = jax.jit(functools.partial(inner, self))
    return jitted[id(self)](state, dom, amt)

S.ShardedDeviceView.uncharge = uncharge
sys.path.insert(0, "benchmarks")
import multitenant_isolation as MT

assert len(jax.devices()) == 8
out = {kind: MT.run_config(kind, 8, 200, 256) for kind in ("shared", "sharded")}
print(json.dumps(out))
"""


def test_burst_isolation_matches_source_on_8_devices():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", _MT_8DEV], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    for kind in ("shared", "sharded"):
        got = MT.run_config(kind, 8, 200, 256, shards=8, device="cpu")
        assert got["tenants"] == want[kind]["tenants"], kind
        assert got["victim_denial_rate"] == want[kind]["victim_denial_rate"]
        assert got["kind"] == kind
    # the aggressor's bursts overrun its own group only
    assert [t["denials"] for t in got["tenants"]][1:] == [0] * 7
    assert got["tenants"][0]["denials"] > 0


def test_multitenant_quick_main():
    got, text = call(MT.main, ["--quick", "--device", "cpu"])
    assert got == {}
    assert text.rstrip().endswith("quick fairness check: PASS")


def test_throttle_precision_matches_source(monkeypatch):
    ref = load("benchmarks/throttle_precision.py")
    assert TP.mechanism_precision(device="cpu") \
        == ref.mechanism_precision() == (2000.0, 0.0)
    assert TP.mechanism_precision(200.0, device="cpu") \
        == ref.mechanism_precision(200.0)
    steps = []
    gate = TC.DeviceView.gate

    def counted(self, state, dom, step):
        steps.append(step)
        return gate(self, state, dom, step)

    monkeypatch.setattr(TC.DeviceView, "gate", counted)
    (m_ms, _), (w_ms, w_err) = (TP.mechanism_precision(200.0, device="cpu"),
                                TP.wallclock_precision(200.0, device="cpu"))
    assert steps[-1] == m_ms / 10.0 == 20          # the mechanism's step
    assert w_ms >= 200.0 and w_err == abs(w_ms - 200.0) / 200.0


def recorded_engines(monkeypatch, mod) -> list:
    """Record every engine ``mod`` builds: its ``report()`` when it is
    closed."""
    reports = []

    class Rec(mod.Engine):
        def close(self):
            reports.append(self.report())
            super().close()

    monkeypatch.setattr(mod, "Engine", Rec)
    return reports


@pytest.mark.parametrize("backend", ["device", "async"])
def test_engine_overhead_matches_source(monkeypatch, backend):
    ref = load("benchmarks/engine_overhead.py")
    want_reports = recorded_engines(monkeypatch, ref)
    got_reports = recorded_engines(monkeypatch, EO)
    gates = []

    def no_gate(quick, iters=300, **kw):
        gates.append((quick, iters))
        return {"p50_lax_charge": 1.0, "p50_fused_charge": 1.0}

    monkeypatch.setattr(ref, "fused_kernel_gate", no_gate)
    monkeypatch.setattr(EO, "fused_kernel_gate", no_gate)
    want, want_out = call(ref.run, steps=3, backend=backend)
    got, got_out = call(EO.run, steps=3, backend=backend, device="cpu")
    assert len(got_reports) == len(want_reports) \
        == (4 if backend == "async" else 3)
    assert got_reports == want_reports
    assert list(got) == list(want)
    assert masked(got_out) == masked(want_out)
    assert gates == [(False, 300)] * 2


def test_fused_kernel_gate_lines():
    from repro_torch.analysis.roofline import enforcement_roofline

    ref = load("benchmarks/engine_overhead.py")
    want, want_out = call(ref.fused_kernel_gate, True, iters=3)
    got, got_out = call(EO.fused_kernel_gate, True, iters=3, device="cpu")
    assert list(got) == list(want)
    g, w = got_out.splitlines(), want_out.splitlines()
    assert len(g) == len(w) == 5
    assert masked("\n".join(g[:4])) == masked("\n".join(w[:4]))
    rl = enforcement_roofline()
    assert g[3] == (f"cost model: lax {rl['lax']['bytes']:.0f} B / "
                    f"{rl['lax']['flops']:.0f} flop, fused "
                    f"{rl['fused']['bytes']:.0f} B / "
                    f"{rl['fused']['flops']:.0f} flop")
    assert w[4].startswith("fused-kernel gate: interpret mode")
    assert g[4].startswith("fused-kernel gate: CPU tensors, P50 assert "
                           "skipped")


def test_engine_fig8_matches_source():
    ref = load("benchmarks/engine_fig8.py")
    want, want_out = call(ref.run)
    got, got_out = call(EF8.run, device="cpu")
    assert got_out == want_out
    assert got == want
    assert list(got) == ["nolimit", "userspace", "agentcgroup"]


def dryrun_records() -> list:
    """Records as ``launch/dryrun.py`` writes them: an applicable cell,
    an inapplicable one, one whose trace failed."""
    ok = {"arch": "llama3.2-3b", "shape": "train_4k", "applicable": True,
          "n_chips": 1, "device": "NVIDIA H100 SXM (data sheet)",
          "reduced": {"global_batch": "256 -> 1"}, "t_trace_s": 4.1,
          "memory": {"per_device_bytes": 52645900000, "fits_hbm": True,
                     "hbm_bytes": 80 * 10 ** 9},
          "roofline": {"compute_s": 0.09297, "memory_s": 0.3749,
                       "collective_s": 0.0, "dominant": "memory_s",
                       "model_flops": 6.7e13, "hlo_flops_global": 9.19e13,
                       "useful_flop_ratio": 0.7291,
                       "roofline_fraction": 0.2142,
                       "step_time_bound_s": 0.3749}}
    big = dict(ok, arch="pixtral-12b", shape="prefill_32k",
               memory={"per_device_bytes": 95 * 2 ** 30, "fits_hbm": False},
               roofline=dict(ok["roofline"], compute_s=1.5, memory_s=4e-4,
                             dominant="compute_s"))
    skip = {"arch": "hubert-xlarge", "shape": "decode_32k",
            "applicable": False, "skip_reason": "encoder-only"}
    err = {"arch": "xlstm-350m", "shape": "train_4k", "applicable": True,
           "error": "RuntimeError: boom", "traceback": "..."}
    return [ok, big, skip, err]


@pytest.mark.parametrize("markdown", [False, True])
def test_roofline_table_rows(tmp_path, markdown):
    ref = load("benchmarks/roofline_table.py")
    mine, theirs = tmp_path / "port", tmp_path / "ref"
    mine.mkdir()
    theirs.mkdir()
    for i, rec in enumerate(dryrun_records()):
        (mine / f"{i}.json").write_text(json.dumps(rec))
        (theirs / f"{i}.json").write_text(json.dumps(dict(rec,
                                                          mesh="single")))
    got = RT.table(str(mine), markdown=markdown)
    assert got == ref.table(str(theirs), mesh="single", markdown=markdown)
    assert len(got.splitlines()) == 4 + 1 + markdown
    text, out = call(RT.run, str(mine))
    assert text == RT.table(str(mine))
    assert out.startswith("\n== roofline baselines — one ")


SECTIONS = ("characterization", "mismatch", "fig8_replay",
            "escalation_waste", "adaptive_pressure", "engine_fig8",
            "engine_overhead", "multitenant_isolation",
            "throttle_precision", "roofline_table")
PLUMBING = ("device", "full", "params")


def recorders(monkeypatch, modules: dict, calls: list) -> None:
    for name, mod in modules.items():
        def rec(*a, _name=name, **kw):
            calls.append((_name, a, kw))
            return _name
        monkeypatch.setattr(mod, "run", rec)


@pytest.mark.parametrize("with_dryrun", [True, False])
def test_suite_calls_the_sources_sections(monkeypatch, tmp_path,
                                          with_dryrun):
    import repro_torch.evaluation as TE
    import repro_torch.traces as TT

    jax_up()
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.delenv("XLA_FLAGS", raising=False)   # restored after
    ref_run = importlib.import_module("benchmarks.run")
    ref_mods = {n: importlib.import_module(f"benchmarks.{n}")
                for n in SECTIONS}
    port_mods = {n: importlib.import_module(
        f"repro_torch.{'traces' if n in ('fig8_replay', 'escalation_waste', 'adaptive_pressure') else 'evaluation'}.{n}")
        for n in SECTIONS}
    assert all(getattr(TT if n in ("fig8_replay", "escalation_waste",
                                   "adaptive_pressure") else TE, n)
               is port_mods[n] for n in SECTIONS)
    want, got = [], []
    recorders(monkeypatch, ref_mods, want)
    recorders(monkeypatch, port_mods, got)
    dryrun = tmp_path / "dryrun"
    if with_dryrun:
        (tmp_path / "results" / "dryrun").mkdir(parents=True)
        dryrun.mkdir()
    monkeypatch.chdir(tmp_path)
    _, want_out = call(ref_run.main)
    out, got_out = call(RUN.run, device="cpu", dryrun_dir=str(dryrun))

    def strip(calls):
        return [(n, () if n == "roofline_table" else a,
                 {k: v for k, v in kw.items() if k not in PLUMBING})
                for n, a, kw in calls]

    assert strip(got) == strip(want)
    assert [n for n, *_ in got] == [n for n in SECTIONS
                                    if with_dryrun or n != "roofline_table"]
    assert list(out) == [n for n, *_ in got]
    assert all(out[n] == n for n in out)
    for n, a, kw in got:
        if n in ("engine_fig8", "engine_overhead"):
            assert kw == {"device": torch.device("cpu"), "full": False,
                          "params": None}
        if n == "roofline_table":
            assert a == (str(dryrun),)
    assert ("missing — run" in got_out) == ("missing — run" in want_out) \
        == (not with_dryrun)
    assert got_out.rstrip().splitlines()[-1].startswith("benchmarks done in")


CUDA_CALLS = {
    "multitenant_run_config": lambda: MT.run_config("sharded", 8, 4, 256),
    "multitenant_fairness": lambda: MT.run_fairness(steps=4),
    "multitenant_main": lambda: MT.main(["--quick"]),
    "throttle_mechanism": lambda: TP.mechanism_precision(),
    "throttle_wallclock": lambda: TP.wallclock_precision(),
    "throttle_main": lambda: TP.main([]),
    "engine_fig8": lambda: EF8.run(),
    "engine_overhead": lambda: EO.run(steps=1),
    "engine_overhead_gate": lambda: EO.fused_kernel_gate(True, iters=1),
    "suite": lambda: RUN.main([]),
}


@pytest.mark.parametrize("name", list(CUDA_CALLS))
def test_tensor_drivers_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CUDA_CALLS[name]()
