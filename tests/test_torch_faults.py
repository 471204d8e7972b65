"""The port's fault injector (``repro_torch/core/faults.py``) against the
JAX package's: a ``FaultPlan`` serialized by either package injects the
same faults at the same ops in the other (the schedule comes from the
same numpy generator, four draws an op, the freeze/offload chaos points
from their own stream), and the port's twins of the reference's
fault tests (``tests/test_faults.py``) hold: transients fire before the
op applies, a wedge inside the async daemon poisons it loudly, an
injected kill routes into escalation, the sharded backend's
reconciliation seam, kills mid-freeze, offload transients that leave no
partial entry, a replay over a faulty backend identical to the plain
one, and the eight seeded chaos runs.  Wedges are ``threading.Event``s;
the daemon's timeout is lowered only just before the wedged wait."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import cgroup as JC
from repro.core import domains as JD
from repro.core import escalation as JE
from repro.core import faults as JF
from repro.core import policy as JPol
from repro.traces import generator as JG
from repro.traces import replay as JR
from repro_torch.core import domains as D
from repro_torch.core import escalation as TE
from repro_torch.core import faults as TF
from repro_torch.core import policy as TPol
from repro_torch.core.cgroup import AgentCgroup, DomainSpec, HostTreeBackend
from repro_torch.core.daemon import AsyncDaemonBackend, DaemonError
from repro_torch.core.freezer import FrozenStore
from repro_torch.core.sharded import ShardedTableBackend
from repro_torch.traces import generator as TG
from repro_torch.traces import replay as TR

# (package's cgroup module, its faults module, its escalation module)
PACKAGES = {"torch": (None, TF, TE), "jax": (JC, JF, JE)}


def _host(pkg, capacity):
    cg_mod = PACKAGES[pkg][0]
    return (HostTreeBackend(capacity) if cg_mod is None
            else cg_mod.HostTreeBackend(capacity))


def _facade(pkg, backend):
    cg_mod = PACKAGES[pkg][0]
    return (AgentCgroup(backend) if cg_mod is None
            else cg_mod.AgentCgroup(backend))


def _spec(pkg, **kw):
    cg_mod = PACKAGES[pkg][0]
    return DomainSpec(**kw) if cg_mod is None else cg_mod.DomainSpec(**kw)


def _scripted_run(plan_json: str, pkg: str = "torch") -> list:
    """The reference's scripted op sequence under a plan, in either
    package; the injected faults."""
    F = PACKAGES[pkg][1]
    be = F.FaultyBackend(_host(pkg, 500), F.FaultPlan.from_json(plan_json))
    cg = _facade(pkg, be)
    for i in range(4):
        try:
            cg.mkdir(f"/s{i}", _spec(pkg, high=60))
        except F.TransientBackendError:
            continue
        for step, mb in ((0, 30), (1, 20), (2, 40)):
            try:
                cg.try_charge(f"/s{i}", mb, step=step)
            except F.TransientBackendError:
                pass
    return list(be.injected)


BASE = dict(seed=3, p_transient=0.3, p_delay=0.2, delay_s=0.0001,
            p_spurious_kill=0.1)


# ------------------------------------------------------------ determinism


def test_fault_plan_json_roundtrip_both_ways():
    """A plan written by either package reads back equal in the other."""
    kw = dict(seed=42, p_transient=0.25, p_delay=0.1, delay_s=0.002,
              p_spurious_kill=0.05, p_wedge=0.01, wedge_s=0.5,
              p_kill_mid_freeze=0.2, p_offload_transient=0.3,
              ops=("mkdir", "kill"))
    jplan, tplan = JF.FaultPlan(**kw), TF.FaultPlan(**kw)
    assert TF.FaultPlan.from_json(jplan.to_json()) == tplan
    assert JF.FaultPlan.from_json(tplan.to_json()) == jplan
    assert tplan.to_json() == jplan.to_json()
    assert TF.FaultPlan.from_json(TF.FaultPlan().to_json()) == TF.FaultPlan()
    assert TF.MUTATING_OPS == JF.MUTATING_OPS


@pytest.mark.parametrize("seed", [3, 4])
def test_jax_plan_injects_identical_schedule(seed):
    """A plan serialized by the JAX package: the port injects the same
    faults at the same ops on the same op sequence, and again on a
    second run (every chaos failure replays from the plan alone)."""
    plan = JF.FaultPlan(**dict(BASE, seed=seed)).to_json()
    want = _scripted_run(plan, "jax")
    got = _scripted_run(plan)
    assert got == want
    assert got and _scripted_run(plan) == got


def test_injection_schedule_depends_on_the_seed():
    a = _scripted_run(TF.FaultPlan(**BASE).to_json())
    assert _scripted_run(TF.FaultPlan(**dict(BASE, seed=4)).to_json()) != a


def test_transient_raised_before_inner_op_applies():
    plan = TF.FaultPlan(seed=0, p_transient=1.0, ops=("try_charge",))
    cg = AgentCgroup(TF.FaultyBackend(HostTreeBackend(500), plan))
    cg.mkdir("/s")                           # not in ops: untouched
    with pytest.raises(TF.TransientBackendError):
        cg.try_charge("/s", 30)
    assert cg.usage("/s") == 0               # the op did NOT apply


# ---------------------------------------------------------- loud failure


def test_wedge_inside_async_daemon_poisons_loudly():
    """A wedged op on the daemon thread times the flush out: the caller
    gets DaemonError (not a hang), and the backend stays poisoned until
    closed and rebuilt."""
    plan = TF.FaultPlan(seed=0, p_wedge=1.0, wedge_s=30.0, ops=("freeze",))
    faulty = TF.FaultyBackend(HostTreeBackend(500), plan)
    be = AsyncDaemonBackend(faulty)
    cg = AgentCgroup(be)
    cg.mkdir("/s")
    cg.freeze("/s")                          # queues; daemon wedges on apply
    be.flush_timeout_s = 0.3                 # only the wedge can trip it
    with pytest.raises(DaemonError, match="timed out"):
        cg.flush()
    with pytest.raises(DaemonError, match="close and rebuild"):
        cg.mkdir("/t")                       # poisoned: loud, never silent
    assert faulty.injected == [(0, "freeze", "wedge", 30.0)]
    faulty.unwedge()
    be.close(flush=False)
    assert not be._thread.is_alive()


def test_spurious_kill_routes_into_escalation_and_recovers():
    """An injected out-of-band kill lands on the open lease;
    note_external_kill synthesizes the typed OomEvent and the escalation
    loop retries the call at a negotiated limit."""
    holder = {}
    plan = TF.FaultPlan(seed=0, p_spurious_kill=1.0, ops=("uncharge",))
    be = TF.FaultyBackend(
        HostTreeBackend(1000), plan,
        on_spurious_kill=lambda p, f:
            holder["cg"].intent.note_external_kill(p, freed=f))
    cg = AgentCgroup(be)
    holder["cg"] = cg
    cg.mkdir("/s")
    cg.try_charge("/s", 10)
    lease = cg.intent.declare("tool_1", None, parent="/s", high=50, max=50)
    cg.try_charge(lease.path, 30)
    cg.uncharge("/s", 5)                     # injection point: kills the lease
    assert lease.killed and lease.oom is not None
    assert lease.oom.residual_pages == 30    # freed routed via the callback
    new, neg = TE.Escalator(cg, TE.EscalationPolicy()).escalate(lease)
    assert new.attempt == 2 and neg.grant_pages == 100
    assert cg.read(new.path, "memory.max") == 100
    new.close()
    assert be.injected == [(0, "kill", "spurious_kill", "/s/tool_1")]


# --------------------------------------- sharded reconciliation under chaos


@pytest.mark.parametrize("n_shards", [1, 4])
def test_sharded_reconcile_transient_between_shard_gathers(n_shards):
    """Transients fire between the per-shard gathers of ``reconcile``
    (the ``reconcile_hook`` seam), so a root read can fail mid-gather;
    retrying converges to the exact total, and the seeded schedule
    (one draw a reconcile, at shard 0) is the same at any shard count."""
    inner = ShardedTableBackend(500, n_domains=16, n_shards=n_shards,
                                device="cpu")
    plan = TF.FaultPlan(seed=3, p_transient=0.4, ops=("reconcile",))
    injector = TF.FaultyBackend(inner, plan)

    def hook(shard):
        if shard == 0 and injector._pre_fault("reconcile"):
            raise TF.TransientBackendError(
                f"injected between shard gathers (shard {shard})")

    inner.reconcile_hook = hook
    cg = AgentCgroup(injector)
    cg.mkdir("/t0")
    cg.mkdir("/t1")
    assert cg.try_charge("/t0", 40).granted
    assert cg.try_charge("/t1", 25).granted
    fired, total = 0, None
    for _ in range(32):
        try:
            total = cg.usage("/")
            break
        except TF.TransientBackendError:
            fired += 1
    assert total == 65
    assert fired > 0
    # the reference's draws for the same plan: where the first
    # reconcile succeeds
    rng = np.random.default_rng(3)
    draws = [rng.random(4)[0] for _ in range(32)]
    assert fired == next(i for i, r in enumerate(draws) if r >= 0.4)
    inner.reconcile_hook = None
    assert cg.usage("/") == 65


def test_sharded_reconcile_concurrent_lifecycle_op():
    """A lifecycle op landing between shard gathers leaves accounting
    consistent: the mid-reconciliation read sees the pre- or post-op
    total, and a clean re-read returns the exact post-op value."""
    inner = ShardedTableBackend(500, n_domains=16, n_shards=4, device="cpu")
    cg = AgentCgroup(inner)
    cg.mkdir("/t0")
    assert cg.try_charge("/t0", 60).granted
    fired = []

    def hook(shard):
        if not fired:                    # one-shot: lands mid-gather once
            fired.append(shard)
            inner.uncharge("/t0", 10)

    inner.reconcile_hook = hook
    mid = cg.usage("/")
    assert mid in (50, 60)
    inner.reconcile_hook = None
    assert fired and cg.usage("/") == 50
    assert cg.usage("/t0") == 50


# ------------------------------------------- freeze/offload chaos points


def _freeze_script(plan_json: str, pkg: str = "torch") -> tuple:
    """Charge a session, freeze it, observe: (injected, cg)."""
    F = PACKAGES[pkg][1]
    be = F.FaultyBackend(_host(pkg, 500), F.FaultPlan.from_json(plan_json))
    cg = _facade(pkg, be)
    cg.mkdir("/s")
    cg.mkdir("/s/sess", _spec(pkg, high=100))
    cg.try_charge("/s/sess", 80, step=0)
    cg.freeze("/s/sess")
    return list(be.injected), cg


def test_kill_mid_freeze_deterministic():
    """p_kill_mid_freeze: the subtree dies while the freezer quiesces,
    usage released before the freeze applies, the domain both killed and
    frozen; the schedule is the JAX package's and replays."""
    plan = JF.FaultPlan(seed=11, p_kill_mid_freeze=1.0).to_json()
    injected, cg = _freeze_script(plan)
    assert [(op, fault, d) for _, op, fault, d in injected] == \
        [("freeze", "kill_mid_freeze", "/s/sess")]
    assert injected == _freeze_script(plan, "jax")[0]
    assert cg.usage("/") == 0                # the kill released the pages
    assert cg.read("/s/sess", "cgroup.freeze") == 1
    assert not cg.try_charge("/s/sess", 1, step=1).granted
    assert _freeze_script(plan)[0] == injected


def test_kill_mid_freeze_hook_and_stream_isolation():
    """The kill routes through on_spurious_kill, and enabling the chaos
    points does not shift the four-draw schedule of an existing plan."""
    seen = []
    plan = TF.FaultPlan(seed=11, p_kill_mid_freeze=1.0)
    be = TF.FaultyBackend(HostTreeBackend(500), plan,
                          on_spurious_kill=lambda p, f: seen.append((p, f)))
    cg = AgentCgroup(be)
    cg.mkdir("/s")
    cg.try_charge("/s", 40, step=0)
    cg.freeze("/s")
    assert seen == [("/s", 40)]
    base = TF.FaultPlan(**BASE)
    with_chaos = dataclasses.replace(base, p_kill_mid_freeze=1.0,
                                     p_offload_transient=1.0)
    assert _scripted_run(base.to_json()) == \
        _scripted_run(with_chaos.to_json())


def test_offload_transient_leaves_no_partial_entry():
    """p_offload_transient through ``FrozenStore.offload_hook``: the
    offload fails before the entry commits, the store is untouched, and
    the retry freezes exactly once."""
    plan = TF.FaultPlan(seed=5, p_offload_transient=1.0)
    faulty = TF.FaultyBackend(HostTreeBackend(500), plan)
    store = FrozenStore()
    store.offload_hook = faulty.offload_fault
    blob = {"kv": torch.ones((4, 4))}
    with pytest.raises(TF.TransientBackendError):
        store.freeze("sess_1", blob, pages=10, now=3.0)
    assert not store.is_frozen("sess_1")     # nothing committed
    assert store.n_freezes == 0 and store.bytes_held == 0
    assert faulty.injected == [(0, "offload", "transient", "sess_1")]
    store.offload_hook = None                # transient cleared: retry
    store.freeze("sess_1", blob, pages=10, now=4.0)
    assert store.is_frozen("sess_1") and store.n_freezes == 1
    assert store.bytes_held == 64
    entry = store.thaw("sess_1")
    assert entry.pages == 10 and entry.frozen_at == 4.0


def test_chaos_plan_back_compat():
    """A plan artifact from before the chaos points (no such keys) loads
    with them off, in both packages alike."""
    old = json.loads(JF.FaultPlan(seed=9).to_json())
    del old["p_kill_mid_freeze"], old["p_offload_transient"]
    assert TF.FaultPlan.from_json(json.dumps(old)) == TF.FaultPlan(seed=9)


# ------------------------------------------------------- replay over faults


def _replay_results(pkg: str, backend=None):
    G, R, Pol, Dm = ((TG, TR, TPol, D) if pkg == "torch"
                     else (JG, JR, JPol, JD))
    tr = [G.named_trace("dask/dask#11628", seed=1),
          G.named_trace("sigmavirus24/github3.py#673", seed=2)]
    r = R.Replay(tr, [Dm.HIGH, Dm.LOW], Pol.AgentCgroupPolicy(),
                 R.ReplayConfig(capacity_mb=1100), backend=backend).run()
    hi = r.latency_of(Dm.HIGH)
    return (r.survival, r.throttle_count, r.peak_pool_mb, hi.p50, hi.p95,
            {k: (v.completed, v.killed, v.finish_ms)
             for k, v in r.tasks.items()})


def test_replay_over_faulty_backend_bit_identical():
    """The trace replay over a faulty host tree, with the JAX-written
    transient-only plan and auto-retry: every transient self-heals before
    its op applies, so the result equals the plain run's and the JAX
    package's, with the same faults injected at the same ops."""
    plan_json = JF.FaultPlan(seed=11, p_transient=0.2).to_json()
    want = _replay_results("torch")
    assert want == _replay_results("jax")
    faulty = TF.FaultyBackend(HostTreeBackend(1100),
                              TF.FaultPlan.from_json(plan_json),
                              auto_retry=1)
    jfaulty = JF.FaultyBackend(JC.HostTreeBackend(1100),
                               JF.FaultPlan.from_json(plan_json),
                               auto_retry=1)
    assert _replay_results("torch", faulty) == want
    assert _replay_results("jax", jfaulty) == want
    assert faulty.injected == jfaulty.injected
    assert any(f == "transient" for _, _, f, _ in faulty.injected)


# -------------------------------------------------------------- chaos fuzz


def _chaos_plan(F, seed: int):
    return F.FaultPlan(seed=seed, p_transient=0.15, p_delay=0.05,
                       delay_s=0.0002, p_spurious_kill=0.08)


def _chaos_run(pkg: str, seed: int) -> tuple:
    """The reference's lease-heavy chaos workload under the plan's
    faults, in either package: transients self-heal (auto_retry),
    spurious kills route into escalation; ends with clean accounting or
    fails loudly.  (completed calls, injected faults, final usage)."""
    F, E = PACKAGES[pkg][1], PACKAGES[pkg][2]
    holder = {}
    be = F.FaultyBackend(
        _host(pkg, 1000), _chaos_plan(F, seed), auto_retry=1,
        on_spurious_kill=lambda p, f:
            holder["cg"].intent.note_external_kill(p, freed=f))
    cg = _facade(pkg, be)
    holder["cg"] = cg
    esc = E.Escalator(cg, E.EscalationPolicy(max_attempts=3))
    cg.mkdir("/s", _spec(pkg, max=600))
    clock = 0.0
    completed = 0
    for i in range(6):
        lease = cg.intent.declare(f"tool_{i}", None, parent="/s",
                                  high=40, max=40)
        need = 30 + 15 * (i % 3)             # some calls exceed the max
        charged = 0
        for _ in range(30):
            if charged >= need or lease.closed:
                break
            if lease.killed:
                try:
                    lease, _ = esc.escalate(lease)
                except E.EscalationExhausted:
                    break
                charged = 0
                continue
            clock += 500.0                   # expire throttle windows
            cg.set_time(clock)
            if cg.usage(lease.path) + 10 > lease.max:
                cg.kill(lease.path)          # memcg-max breach -> OOM
                continue
            if cg.try_charge(lease.path, 10).granted:
                charged += 10
        if not lease.closed:
            if charged >= need and not lease.killed:
                completed += 1
            lease.close()
    assert cg.intent.open_leases() == []
    assert 0 <= cg.usage("/") <= 1000
    assert cg.usage("/s") == cg.usage("/")
    return completed, list(be.injected), cg.usage("/")


@pytest.mark.parametrize("seed", list(range(8)))
def test_chaos_fuzz_invariants_hold(seed):
    """The reference's seeded chaos sweep: the invariants hold, and the
    port's run (completed calls, every injected fault, final usage)
    equals the JAX package's under the same plan."""
    got = _chaos_run("torch", seed)
    assert got == _chaos_run("jax", seed)
