"""The port's sharded backend (``repro_torch/core/sharded.py``) against
the JAX package's and against the host tree:

* round-robin tenant placement, global handles (``shard * n + local``)
  and the global root-capacity denial (a stall event at the charged
  domain), identical to the host tree's grants at 4 shards and to the
  JAX sharded backend at 1;
* the in-step charge, gate and schedule over 4 shards, through the
  device view's global handles, equal bit for bit to the JAX package's
  ``controller.charge_batch`` / ``slot_gate`` and
  ``sched.schedule_decision`` run on each shard's slice, what
  ``shard_map`` computes on each device (no fake devices needed);
* ``snapshot``/``restore`` round trips;
* the conformance scenarios' observation streams on
  ``ShardedTableBackend(n_shards=1)`` equal to the JAX one's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import cgroup as JCg
from repro.core import controller as JC
from repro.core import progs as JP
from repro.core import sched as JS
from repro.core.sharded import ShardedTableBackend as JSharded
from repro.testing import conformance as JK
from repro_torch.core import progs as TP
from repro_torch.core.cgroup import AgentCgroup, DomainSpec, HostTreeBackend
from repro_torch.core.sharded import ShardedTableBackend
from repro_torch.testing import conformance as TK
from test_torch_enforcement import (assert_same_state, batch, programs,
                                    random_state, to_jax, to_torch)

jax.config.update("jax_platform_name", "cpu")

jax_charge = jax.jit(JC.charge_batch, static_argnums=(4,))
jax_gate = jax.jit(JC.slot_gate, static_argnums=(3,))
S4 = 4


def _ops(cg, DS) -> list:
    """Tenants over the shards, sessions and a tool call under them,
    charges up to and past the global root capacity (100 pages), a
    freeze, a kill, reads of the reconciled root."""
    out = []
    for t in ("/a", "/b", "/c", "/d", "/e"):
        out.append(cg.mkdir(t, DS(high=45)))
        out.append(cg.mkdir(f"{t}/s", DS(high=30, max=40)))
    out.append(cg.mkdir("/a/s/tool", DS(high=10)))
    for step, (path, pages) in enumerate((
            ("/a/s/tool", 8), ("/a/s", 20), ("/b/s", 35), ("/c/s", 30),
            ("/d/s", 12), ("/e/s", 9), ("/b/s", 10), ("/d/s", 5),
            ("/a/s/tool", 6), ("/c/s", 1))):
        t = cg.try_charge(path, pages, step=step)
        out.append((t.granted, t.stalled, t.blocked_by, t.delay_ms))
    cg.freeze("/c")
    out.append(cg.try_charge("/c/s", 1, step=20).granted)
    cg.thaw("/c")
    out.append(cg.kill("/d"))
    out.append(cg.try_charge("/e/s", 30, step=21).granted)
    for path in ("/", "/a", "/a/s", "/b/s", "/c", "/d/s", "/e/s"):
        out.append((path, cg.read(path, "memory.current"),
                    cg.read(path, "memory.peak"),
                    cg.read(path, "memory.stall")))
    return out


def _grants(obs) -> list:
    """The tickets and reads, without handles (backend-specific)."""
    return [o for o in obs if not isinstance(o, int)]


def test_placement_handles_and_root_capacity():
    """4 shards: tenants round-robin (the fifth back on shard 0), each
    handle ``shard * n + local``, and every grant, denial (the global
    root capacity says "/") and read as the host tree gives them."""
    be = ShardedTableBackend(100, n_domains=16, n_shards=S4, device="cpu")
    got = _ops(AgentCgroup(be), DomainSpec)
    want = _ops(AgentCgroup(HostTreeBackend(100)), DomainSpec)
    assert be.placement() == {"/a": 0, "/b": 1, "/c": 2, "/d": 3, "/e": 0}
    handles = [o for o in got if isinstance(o, int)][:11]
    assert handles == [1, 2, 17, 18, 33, 34, 49, 50, 3, 4, 5]
    for p in be.paths():
        assert be.path_of(be.handle(p)) == p
    assert (False, True, "/", 0.0) in _grants(got)    # global root wall
    # grants and stalls as the host tree's (its ``blocked_by`` names the
    # first blocking ancestor; the sharded backend checks the global
    # root first, as the reference's does)
    assert [o[:2] if isinstance(o, tuple) else o
            for o in _grants(got)[:-7]] == \
        [o[:2] if isinstance(o, tuple) else o for o in _grants(want)[:-7]]
    # the reads: root usage reconciles to the host tree's; peaks are
    # per-shard sums (an upper bound), so only usage and stalls compare
    for g, w in zip(_grants(got)[-7:], _grants(want)[-7:]):
        assert (g[0], g[1], g[3]) == (w[0], w[1], w[3])


def test_one_shard_matches_jax_sharded_backend():
    """At one shard the port's stream is the JAX sharded backend's,
    handles, tickets, reads and the snapshot alike."""
    tbe = ShardedTableBackend(100, n_domains=16, device="cpu")
    jbe = JSharded(100, n_domains=16)
    got = _ops(AgentCgroup(tbe), DomainSpec)
    assert got == _ops(JCg.AgentCgroup(jbe), JCg.DomainSpec)
    ts, js = tbe.snapshot(), jbe.snapshot()
    assert sorted(ts) == sorted(js)
    for k in ts:
        if isinstance(ts[k], np.ndarray):
            assert np.array_equal(ts[k], np.asarray(js[k])), k
        else:
            assert ts[k] == js[k], k


# ------------------------------------------------------------- in-step


def _tables(seed: int, kind: str, n: int = 40):
    """S4 random tables (numpy, stacked) and each shard's live domains."""
    rng = np.random.default_rng(seed)
    jprogs = programs(kind, JP, 10.0, (np.float32(10), np.float32(10)))
    tprogs = programs(kind, TP, 10.0, (np.float32(10), np.float32(10)))
    step = int(rng.integers(5, 40))
    tables, lives = zip(*(random_state(rng, n, jprogs, step)
                          for _ in range(S4)))
    stacked = {k: np.stack([t[k] for t in tables]) for k in tables[0]}
    return rng, jprogs, tprogs, step, tables, lives, stacked


def _global_slots(rng, lives, n: int, m: int):
    """m slots over all shards as global handles (some dead), and the
    (S, m) matrix of shard-local indices, -1 off the shard."""
    shard = rng.integers(0, S4, m)
    dom = np.array([s * n + int(rng.choice(lives[s])) for s in shard],
                   np.int32)
    dom[rng.random(m) < 0.15] = -1
    dom2 = np.full((S4, m), -1, np.int32)
    for j, d in enumerate(dom):
        if d >= 0:
            dom2[d // n, j] = d % n
    return dom, dom2


def _view(tprogs, stacked):
    be = ShardedTableBackend(100, n_domains=stacked["usage"].shape[1],
                             n_shards=S4, prog=tprogs, device="cpu")
    be.state = to_torch(stacked)
    return be.device_view()


@pytest.mark.parametrize("kind,seed", [(k, s) for k in
                                       ("graduated", "token_bucket",
                                        "mixed") for s in range(2)])
def test_in_step_charge_and_gate_match_jax_per_shard(kind, seed):
    """The view's charge and gate over global handles, three steps
    feeding forward, against the JAX charge and gate on each shard's
    slice: every table bit-identical, the flags gathered per slot."""
    rng, jprogs, tprogs, step, tables, lives, stacked = _tables(
        300 + seed, kind)
    view = _view(tprogs, stacked)
    n = stacked["usage"].shape[1]
    st = view.state
    for _ in range(3):
        dom, dom2 = _global_slots(rng, lives, n, 12)
        _, amt = batch(rng, lives[0], 12)
        new, granted, stalled = view.charge(st, torch.from_numpy(dom),
                                            torch.from_numpy(amt), step)
        gate = view.gate(new, torch.from_numpy(dom), step + 1)
        wants, g_want, s_want = [], np.zeros(12, bool), np.zeros(12, bool)
        gate_want = np.zeros(12, bool)
        for s in range(S4):
            js = to_jax({k: v[s] for k, v in stacked.items()})
            w, g, sl = jax_charge(js, jnp.asarray(dom2[s]), jnp.asarray(amt),
                                  step, jprogs)
            gw = jax_gate(w, jnp.asarray(dom2[s]), step + 1, jprogs)
            mine = dom2[s] >= 0
            g_want |= np.asarray(g) & mine
            s_want |= np.asarray(sl) & mine
            gate_want |= np.asarray(gw) & mine
            wants.append(w)
        want = {k: np.stack([np.asarray(w[k]) for w in wants])
                for k in wants[0]}
        assert_same_state(want, new)
        assert np.array_equal(granted.numpy(), g_want)
        assert np.array_equal(stalled.numpy(), s_want)
        assert np.array_equal(gate.numpy(), gate_want)
        stacked = {k: np.asarray(v) for k, v in want.items()}
        st = to_torch(stacked)
        step += int(rng.integers(0, 3))


@pytest.mark.parametrize("seed", range(2))
def test_in_step_schedule_matches_jax_per_shard(seed):
    """The view's weighted round: every shard runs
    ``schedule_decision`` over its own slots with a per-shard budget,
    as the JAX package's on each shard's slice."""
    rng, jprogs, tprogs, step, tables, lives, stacked = _tables(
        400 + seed, "weighted_fair")
    stacked["prog"][:, :, 4] = rng.integers(-1, 3, stacked["prog"].shape[:2])
    stacked["prog"][:, :, 5] = rng.random(stacked["prog"].shape[:2]) < 0.8
    view = _view(tprogs, stacked)
    n = stacked["usage"].shape[1]
    dom, dom2 = _global_slots(rng, lives, n, 12)
    cost = rng.integers(0, 3, 12).astype(np.int32)
    budget = 2
    new, advance = view.schedule(view.state, torch.from_numpy(dom),
                                 torch.from_numpy(cost), step, budget)
    wants, a_want = [], np.zeros(12, bool)
    for s in range(S4):
        js = to_jax({k: v[s] for k, v in stacked.items()})
        w, a = JS.schedule_decision(jprogs, js, jnp.asarray(dom2[s]),
                                    jnp.asarray(cost), step, budget)
        a_want |= np.asarray(a) & (dom2[s] >= 0)
        wants.append(w)
    want = {k: np.stack([np.asarray(w[k]) for w in wants]) for k in wants[0]}
    assert_same_state(want, new)
    assert np.array_equal(advance.numpy(), a_want)
    assert a_want.any() and not a_want.all()


# ------------------------------------------------------ snapshot/restore


@pytest.mark.parametrize("n_shards", [1, S4])
def test_snapshot_restore_roundtrip(n_shards):
    """A backend rebuilt from a snapshot carries the same state, and the
    same ops on both go on giving the same answers."""
    prog = TP.TokenBucketProgram(bucket_capacity=20.0)
    a = ShardedTableBackend(100, n_domains=16, n_shards=n_shards,
                            device="cpu")
    cga = AgentCgroup(a)
    cga.attach("/", prog)
    _ops(cga, DomainSpec)
    snap = a.snapshot()
    b = ShardedTableBackend(100, n_domains=16, n_shards=n_shards,
                            device="cpu")
    b.attach("/", prog)
    b.restore(snap)
    snap2 = b.snapshot()
    assert sorted(snap) == sorted(snap2)
    for k in snap:
        same = (np.array_equal(snap[k], snap2[k])
                if isinstance(snap[k], np.ndarray) else snap[k] == snap2[k])
        assert same, k
    cgb = AgentCgroup(b)
    for cg in (cga, cgb):
        cg.mkdir("/f")
        cg.mkdir("/f/s", high=5)
    out = [[cg.try_charge(p, 3, step=30 + i).granted
            for i, p in enumerate(("/f/s", "/a/s", "/e/s", "/f/s"))]
           + [cg.handle("/f/s"), cg.usage("/"), cg.read("/f", "cpu.weight")]
           for cg in (cga, cgb)]
    assert out[0] == out[1]
    with pytest.raises(ValueError, match="shape"):
        ShardedTableBackend(100, n_domains=8, n_shards=n_shards,
                            device="cpu").restore(snap)


# ------------------------------------------------------------ kit streams


DEVICE_NAMES = [s.name for s in TK.STANDARD_SCENARIOS if not s.requires]


def by_name(obs):
    return [(i, n, v.name if hasattr(v, "name") and hasattr(v, "value")
             else v) for i, n, v in obs]


@pytest.mark.parametrize("name", DEVICE_NAMES)
def test_one_shard_stream_matches_reference(name):
    """Each scenario's observation stream on the port's one-shard
    backend equals the JAX sharded backend's."""
    t, j = TK.get_scenario(name), JK.get_scenario(name)
    got = TK.replay(AgentCgroup(ShardedTableBackend(
        t.capacity, n_domains=t.n_domains, device="cpu")), t)
    want = JK.replay(JCg.AgentCgroup(JSharded(j.capacity,
                                              n_domains=j.n_domains)), j)
    assert by_name(got) == by_name(want)
