"""The port's conformance kit and host-tree backend against the JAX
package's.

* Every standard scenario passes on all six of the port's backend kinds
  (the device-state kinds on the CPU; the sharded ones at 1 and 4
  shards) against the port's host tree, and on ``device`` at 4,104
  domains; the fault-injecting factories with the fault-free plan, and
  with a transient-only plan under auto-retry, give each kind's
  synchronous inner backend's stream.
* Each scenario's observation stream on the port's host tree equals the
  JAX kit's host stream (enum kinds by name, numbers exactly), and the
  port's device-table stream equals the JAX kit's device stream.
* The host tree's millisecond-clock decision (``step=None``, f32 clock
  and throttle windows) gives the tickets the reference's jitted
  decision gives, bit for bit, over randomized charges.
"""
import numpy as np
import pytest

from repro.core import cgroup as JC
from repro.core import progs as JP
from repro.testing import conformance as JK
from repro_torch.core import cgroup as TC
from repro_torch.core import progs as TP
from repro_torch.core.events import Ev
from repro_torch.testing import conformance as TK

NAMES = [s.name for s in TK.STANDARD_SCENARIOS]
DEVICE_NAMES = [s.name for s in TK.STANDARD_SCENARIOS if not s.requires]


def test_scenarios_are_the_references():
    assert NAMES == [s.name for s in JK.STANDARD_SCENARIOS]
    for t, j in zip(TK.STANDARD_SCENARIOS, JK.STANDARD_SCENARIOS):
        assert (t.ops, t.capacity, t.n_domains, t.requires,
                t.pressure_windows) == (j.ops, j.capacity, j.n_domains,
                                        j.requires, j.pressure_windows)
        assert sorted(t.programs) == sorted(j.programs)


def _kind(spec: str) -> tuple:
    """``"kind"`` or ``"kind:S"`` (a sharded kind at S shards)."""
    kind, _, shards = spec.partition(":")
    return kind, int(shards or 1)


@pytest.mark.parametrize("kind,n_domains", [
    ("host", None), ("device", None), ("device", 4104), ("sharded", None),
    ("sharded:4", None), ("async-host", None), ("async-device", None),
    ("async-sharded", None), ("async-sharded:4", None)])
def test_suite_passes(kind, n_domains):
    """The port's own suite: each kind against the port's host tree, the
    device table at the scenarios' size and at the enforcement bench's
    4,104 domains, the sharded kinds at 1 and 4 shards."""
    kind, n_shards = _kind(kind)
    suite = TK.ConformanceSuite()
    report = suite.run(TK.standard_backend_factory(
        kind, device="cpu", n_domains=n_domains, n_shards=n_shards),
        features=TK.backend_features(kind))
    assert report.ok, report.summary()
    skipped = [r.name for r in report.results if r.skipped]
    assert skipped == ([] if kind.endswith("host") else ["memcg_events"])


FAULT_PLANS = {
    "fault_free": (None, 0),
    "transient_retry": (dict(seed=7, p_transient=0.5), 1),
}


@pytest.mark.parametrize("plan", sorted(FAULT_PLANS))
@pytest.mark.parametrize("kind", list(TK.BACKEND_KINDS) + ["sharded:4",
                                                           "async-sharded:4"])
def test_faulty_factory_matches_inner_backend(kind, plan):
    """``faulty_backend_factory`` with the fault-free plan (the suite
    passes), and with a transient-only plan under ``auto_retry=1`` (every
    transient fires before its op and the retry applies it once): every
    scenario's stream equals the synchronous inner backend's, which
    ``test_suite_passes`` certifies."""
    from repro_torch.core.faults import FaultPlan
    kind, n_shards = _kind(kind)
    kw, retry = FAULT_PLANS[plan]
    faulty = TK.faulty_backend_factory(
        kind, FaultPlan(**kw) if kw else None, auto_retry=retry,
        device="cpu", n_shards=n_shards)
    inner = TK.standard_backend_factory(
        kind.removeprefix("async-"), device="cpu", n_shards=n_shards)
    if plan == "fault_free":
        report = TK.ConformanceSuite().run(
            faulty, features=TK.backend_features(kind))
        assert report.ok, report.summary()
    for sc in TK.STANDARD_SCENARIOS:
        if not sc.requires <= TK.backend_features(kind):
            continue
        streams = []
        for make in (faulty, inner):
            be = make(sc.capacity, sc.n_domains)
            try:
                streams.append(TK.replay(TC.AgentCgroup(be), sc))
            finally:
                close = getattr(be, "close", None)
                if close is not None:
                    close()
        assert streams[0] == streams[1], sc.name


def by_name(obs):
    """Enum values stay comparable across the two packages' ``Ev``."""
    return [(i, n, v.name if hasattr(v, "name") and hasattr(v, "value")
             else v) for i, n, v in obs]


@pytest.mark.parametrize("name", NAMES)
def test_host_stream_matches_reference(name):
    t, j = TK.get_scenario(name), JK.get_scenario(name)
    got = TK.replay(TC.AgentCgroup(TC.HostTreeBackend(t.capacity)), t)
    want = JK.replay(JC.AgentCgroup(JC.HostTreeBackend(j.capacity)), j)
    assert by_name(got) == by_name(want)


@pytest.mark.parametrize("name", DEVICE_NAMES)
def test_device_stream_matches_reference(name):
    t, j = TK.get_scenario(name), JK.get_scenario(name)
    got = TK.replay(TC.AgentCgroup(TC.DeviceTableBackend(
        t.capacity, n_domains=t.n_domains, device="cpu")), t)
    want = JK.replay(JC.AgentCgroup(JC.DeviceTableBackend(
        j.capacity, n_domains=j.n_domains)), j)
    assert by_name(got) == by_name(want)


PROGRAMS = {
    "graduated": (lambda P: P.GraduatedThrottleProgram()),
    "bucket": (lambda P: P.TokenBucketProgram(bucket_capacity=24.0,
                                              refill=(0.5, 1.25, 3.0))),
}


@pytest.mark.parametrize("prog", sorted(PROGRAMS))
def test_ms_clock_decisions_bit_exact(prog):
    """Randomized charges on the facade's millisecond clock (fractional
    times, f32 clock and windows): every ticket, delay and throttle
    event as the reference's jitted decision gives them."""
    rng = np.random.default_rng(7)
    cgs = [TC.AgentCgroup(TC.HostTreeBackend(900)),
           JC.AgentCgroup(JC.HostTreeBackend(900))]
    progs = [PROGRAMS[prog](TP), PROGRAMS[prog](JP)]
    paths = ["/a", "/a/x", "/a/y", "/b", "/b/z"]
    for cg, p in zip(cgs, progs):
        cg.attach("/", p)
        cg.mkdir("/a", high=300)
        cg.mkdir("/a/x", high=40, low=5)
        cg.mkdir("/a/y", high=60, max=120, priority=2)
        cg.mkdir("/b", high=200, priority=0)
        cg.mkdir("/b/z", high=30)
    now = 0.0
    for _ in range(120):
        now += float(rng.uniform(0.0, 37.3))
        path = paths[int(rng.integers(len(paths)))]
        pages = int(rng.integers(1, 40))
        release = rng.random() < 0.3
        out = []
        for cg in cgs:
            cg.set_time(now)
            if release:
                cg.uncharge(path, min(pages, cg.usage(path)))
                out.append(cg.usage(path))
            else:
                t = cg.try_charge(path, pages)
                out.append((t.granted, t.stalled, t.blocked_by,
                            t.over_high, t.delay_ms))
        assert out[0] == out[1], (now, path, pages)
    logs = [[(e.t_ms, e.kind.value, e.domain, sorted(e.detail.items()))
             for e in cg.log.events] for cg in cgs]
    assert logs[0] == logs[1]
    assert cgs[0].log.count(Ev.THROTTLE) > 0


def test_device_kind_defaults_to_the_card():
    import torch
    make = TK.standard_backend_factory("device")
    if torch.cuda.is_available():
        assert make(100, 8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(100, 8)


@pytest.mark.parametrize("kind", ["sharded", "async-device",
                                  "async-sharded"])
def test_device_state_kinds_default_to_the_card(kind):
    import torch
    make = TK.standard_backend_factory(kind)
    if torch.cuda.is_available():
        be = make(100, 8)
        assert getattr(be, "inner", be).device.type == "cuda"
        getattr(be, "close", lambda: None)()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(100, 8)
