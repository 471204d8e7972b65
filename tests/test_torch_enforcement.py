"""The port's in-step decision core against the JAX reference, bit for
bit: randomized charge batches over random depth-<=4 trees (duplicate
domains in a batch, frozen and throttled ancestors, hard-max walls,
delays on exact step quanta) through JAX ``_lax_charge_batch``, the
interpreted Pallas ``fused_charge_batch`` and the port's plain
``charge_batch``; the same for the slot gate and the weighted
scheduler.  Every state table and flag must be identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import controller as JC
from repro.core import progs as JP
from repro.core import sched as JS
from repro.kernels import enforcement as JK
from repro_torch.core import controller as TC
from repro_torch.core import progs as TP
from repro_torch.core import sched as TS
from repro_torch.core.pressure import INT32_MAX
from repro_torch.kernels import enforcement as TK

jax.config.update("jax_platform_name", "cpu")

# the reference paths, compiled once per program registry
lax_charge = jax.jit(JC._lax_charge_batch, static_argnums=(4,))
pallas_charge = jax.jit(JK.fused_charge_batch, static_argnums=(4,))

UNL = 2**31 - 1


def programs(kind, mod, step_ms, rng_row):
    """(registry tuple) of ``mod``'s programs for one test family; the
    knobs come from the same seeded draws for both packages."""
    gain, base = rng_row
    grad = mod.GraduatedThrottleProgram(step_ms=step_ms, overage_gain=gain,
                                        base_delay_ms=base)
    wfair = (JS if mod is JP else TS).WeightedFairProgram(step_ms=step_ms)
    tb = mod.TokenBucketProgram(step_ms=step_ms, bucket_capacity=6.0,
                                refill=(0.7, 1.3, 2.9), overage_gain=gain)
    if kind == "graduated":
        return (grad,)
    if kind == "token_bucket":
        return (tb,)
    if kind == "weighted_fair":
        return (wfair,)
    base_prog = mod.PolicyProgram()
    base_prog.step_ms = step_ms
    return (grad, tb, wfair, base_prog)


def random_state(rng, n, progs_np, step, exact=False):
    """A random control table (numpy) over a random depth-<=4 tree."""
    depth = np.zeros(n, int)
    parent = np.full(n, -1, np.int32)
    active = np.zeros(n, bool)
    active[0] = True
    for i in range(1, n):
        if rng.random() < 0.85:
            cands = [j for j in range(i) if active[j] and depth[j] < 3]
            p = int(rng.choice(cands))
            parent[i], depth[i], active[i] = p, depth[p] + 1, True
    high = np.where(rng.random(n) < 0.3, UNL,
                    rng.integers(1, 40, n)).astype(np.int32)
    maxl = np.where(rng.random(n) < 0.4, UNL,
                    rng.integers(10, 80, n)).astype(np.int32)
    usage = rng.integers(0, 45, n).astype(np.int32)
    if exact:   # overage fractions that land delays on whole quanta
        high = np.where(high < UNL, 10, high).astype(np.int32)
        usage = rng.integers(0, 4, n).astype(np.int32) * 5
    low = np.where(rng.random(n) < 0.2, rng.integers(0, 30, n),
                   0).astype(np.int32)
    width = max(p.n_params for p in progs_np)
    rows = np.stack([JP.pad_row(progs_np[k % len(progs_np)].default_row(),
                                width) for k in range(n)])
    if not exact:
        rows[:, :4] *= rng.uniform(0.5, 1.5, (n, 4)).astype(np.float32)
    if width >= 10:
        rows[:, 4] = rng.uniform(0, 6, n).astype(np.float32)
        rows[:, 5] = rng.integers(0, step + 1, n).astype(np.float32)
    st = {
        "usage": usage, "high": high, "max": maxl, "low": low,
        "parent": parent,
        "priority": rng.integers(0, 3, n).astype(np.int32),
        "frozen": rng.random(n) < 0.1,
        "active": active,
        "throttle_until": np.where(rng.random(n) < 0.2,
                                   step + rng.integers(-2, 4, n),
                                   0).astype(np.int32),
        "peak": (usage + rng.integers(0, 10, n)).astype(np.int32),
        "prog": rows.astype(np.float32),
        "prog_id": rng.integers(-1, len(progs_np) + 1, n).astype(np.int32),
        "weight": rng.integers(1, 300, n).astype(np.int32),
        "cpu_max": np.where(rng.random(n) < 0.3, rng.integers(1, 4, n),
                            UNL).astype(np.int32),
        "flat_weight": rng.uniform(0.05, 1.0, n).astype(np.float32),
        "vruntime": rng.integers(0, 4, n).astype(np.float32),
        "cpu_used": rng.integers(0, 4, n).astype(np.int32),
        "cpu_stamp": rng.integers(-1, 2, n).astype(np.int32),
        "mem_stall": np.where(rng.random(n) < 0.2, INT32_MAX,
                              rng.integers(0, 9, n)).astype(np.int32),
        "cpu_stall": np.where(rng.random(n) < 0.2, INT32_MAX - 1,
                              rng.integers(0, 9, n)).astype(np.int32),
    }
    live = np.flatnonzero(active)
    return st, live


def to_jax(st):
    return {k: jnp.asarray(v) for k, v in st.items()}


def to_torch(st):
    return {k: torch.from_numpy(np.array(v)) for k, v in st.items()}


def assert_same_state(want: dict, got: dict):
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        if w.dtype == np.float32:
            assert np.array_equal(w.view(np.int32),
                                  np.asarray(g).view(np.int32)), k
        else:
            assert np.array_equal(w, np.asarray(g)), k


def batch(rng, live, m):
    dom = rng.choice(np.concatenate([live, [-1]]), m).astype(np.int32)
    dom[rng.random(m) < 0.3] = dom[0]           # duplicates in one batch
    amt = rng.choice([0, 0, 1, 1, 2, 5, 9, 40], m).astype(np.int32)
    return dom, amt


CASES = [(kind, seed) for kind in ("graduated", "token_bucket",
                                   "weighted_fair", "mixed")
         for seed in range(4)]


@pytest.mark.parametrize("kind,seed", CASES)
def test_charge_batch_bit_identical(kind, seed):
    rng = np.random.default_rng(seed)
    step_ms = (10.0, 7.0)[seed % 2]
    exact = seed % 2 == 0
    knobs = (np.float32(10.0), np.float32(10.0)) if exact else \
        (np.float32(rng.uniform(2, 30)), np.float32(rng.uniform(3, 20)))
    jprogs = programs(kind, JP, step_ms, knobs)
    tprogs = programs(kind, TP, step_ms, knobs)
    step = int(rng.integers(3, 40))
    st, live = random_state(rng, 40, jprogs, step, exact=exact)
    for _ in range(3):                   # consecutive steps feed forward
        dom, amt = batch(rng, live, 8)
        want, wg, ws = lax_charge(to_jax(st), jnp.asarray(dom),
                                  jnp.asarray(amt), step, jprogs)
        fused, fg, fs = pallas_charge(to_jax(st), jnp.asarray(dom),
                                      jnp.asarray(amt), step, jprogs)
        got, tg, ts = TC.charge_batch(to_torch(st), torch.from_numpy(dom),
                                      torch.from_numpy(amt), step, tprogs)
        assert_same_state(want, got)
        assert_same_state(fused, got)
        for w in (wg, fg):
            assert np.array_equal(np.asarray(w), tg.numpy())
        for w in (ws, fs):
            assert np.array_equal(np.asarray(w), ts.numpy())
        st = {k: np.asarray(v) for k, v in want.items()}
        step += int(rng.integers(0, 3))


def test_exact_quantum_delays_are_exercised():
    """The exact-boundary family really produces delays on whole step
    quanta (60 ms at step_ms 10 -> 6 steps, not 7)."""
    progs = (TP.GraduatedThrottleProgram(step_ms=10.0),)
    st = TC.new_state(100, 4, progs, "cpu")
    st["parent"][1] = 0
    st["high"][1] = 10
    new, g, _ = TC.charge_batch(st, torch.tensor([1], dtype=torch.int32),
                                torch.tensor([15], dtype=torch.int32), 5,
                                progs)
    assert bool(g[0]) and int(new["throttle_until"][1]) == 5 + 6


def test_saturating_stall_counter_holds_at_int32_max():
    progs = (TP.GraduatedThrottleProgram(),)
    st = TC.new_state(100, 4, progs, "cpu")
    st["parent"][1] = 0
    st["frozen"][1] = True
    st["mem_stall"][1] = INT32_MAX
    new, g, s = TC.charge_batch(st, torch.tensor([1, 1], dtype=torch.int32),
                                torch.tensor([1, 1], dtype=torch.int32), 0,
                                progs)
    assert not bool(g.any()) and bool(s.all())
    assert int(new["mem_stall"][1]) == INT32_MAX


@pytest.mark.parametrize("kind,seed", CASES[::2])
def test_slot_gate_bit_identical(kind, seed):
    rng = np.random.default_rng(100 + seed)
    jprogs = programs(kind, JP, 10.0, (np.float32(10), np.float32(10)))
    tprogs = programs(kind, TP, 10.0, (np.float32(10), np.float32(10)))
    step = 5
    st, live = random_state(rng, 40, jprogs, step)
    dom, _ = batch(rng, live, 8)
    want = JC._lax_slot_gate(to_jax(st), jnp.asarray(dom), step, jprogs)
    fused = JK.fused_slot_gate(to_jax(st), jnp.asarray(dom), step, jprogs)
    got = TC.slot_gate(to_torch(st), torch.from_numpy(dom), step, tprogs)
    assert np.array_equal(np.asarray(want), got.numpy())
    assert np.array_equal(np.asarray(fused), got.numpy())


@pytest.mark.parametrize("kind,seed", [(k, s) for k in
                                       ("weighted_fair", "mixed",
                                        "graduated", "weighted_fair_frac")
                                       for s in range(3)])
def test_schedule_decision_bit_identical(kind, seed):
    """Weighted rounds with inf keys (runnable slots outside the
    weighted scheduler), tied vruntimes, duplicate domains and cpu.max
    windows; integer ``sched_boost`` values, and non-integer ones
    (``weighted_fair_frac``: the weight goes through ``xla_exp2``)."""
    rng = np.random.default_rng(200 + seed)
    frac = kind == "weighted_fair_frac"
    kind = "weighted_fair" if frac else kind
    jprogs = programs(kind, JP, 10.0, (np.float32(10), np.float32(10)))
    tprogs = programs(kind, TP, 10.0, (np.float32(10), np.float32(10)))
    step = int(rng.integers(90, 210))
    st, live = random_state(rng, 40, jprogs, step)
    width = st["prog"].shape[1]
    if width >= 6 and kind == "weighted_fair":
        st["prog"][:, 4] = (rng.uniform(-3, 3, 40) if frac
                            else rng.integers(-1, 3, 40))
        st["prog"][:, 5] = rng.random(40) < 0.8
    for _ in range(3):
        dom, _ = batch(rng, live, 8)
        cost = rng.integers(0, 3, 8).astype(np.int32)
        budget = int(rng.integers(0, 6))
        want, wa = JS.schedule_decision(jprogs, to_jax(st), jnp.asarray(dom),
                                        jnp.asarray(cost), step, budget)
        got, ta = TS.schedule_decision(tprogs, to_torch(st),
                                       torch.from_numpy(dom),
                                       torch.from_numpy(cost), step, budget)
        assert_same_state(want, got)
        assert np.array_equal(np.asarray(wa), ta.numpy())
        st = {k: np.asarray(v) for k, v in want.items()}
        step += int(rng.integers(1, 60))


def test_custom_program_runs_on_cpu_and_has_no_cuda_form():
    class BurstCap(TP.GraduatedThrottleProgram):
        param_names = TP.GraduatedThrottleProgram.param_names + ("cap",)

        def default_row(self):
            return np.concatenate([super().default_row(),
                                   np.float32([3.0])])

        def on_charge(self, view, req):
            base = super().on_charge(view, req)
            big = req.amt > view.params[..., 4]
            return TP.Verdict(base.grant & ~big, base.stall | big,
                              base.delay_ms, base.params)

    progs = (BurstCap(),)
    st = TC.new_state(100, 4, progs, "cpu")
    st["parent"][1] = 0
    _, g, s = TC.charge_batch(st, torch.tensor([1, 1], dtype=torch.int32),
                              torch.tensor([2, 5], dtype=torch.int32), 0,
                              progs)
    assert g.tolist() == [True, False] and s.tolist() == [False, True]
    with pytest.raises(NotImplementedError, match="BurstCap"):
        TK.kind_codes(progs)


def test_xla_exp2_bit_identical():
    """``xla_exp2`` against XLA's ``jnp.exp2`` on the CPU: 10**6 seeded
    f32 draws in [-3, 3], a wide sweep, and the edge values (infinities,
    NaN, signed zero, subnormals, over- and underflow, the clamps)."""
    rng = np.random.default_rng(2026)
    edges = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-45, -1e-45,
                      1e-40, 1.0, -1.0, 127.0, 127.99, 128.0, 128.2, -125.5,
                      -126.0, -126.7, -127.0, -149.0, -150.0, 3.4e38,
                      -3.4e38], np.float32)
    exp2 = jax.jit(jnp.exp2)
    for x in (rng.uniform(-3, 3, 10**6).astype(np.float32),
              rng.uniform(-200, 200, 10**5).astype(np.float32), edges):
        want = np.asarray(exp2(x))
        got = TP.xla_exp2(torch.from_numpy(x)).numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32)) or (
            np.array_equal(np.isnan(got), np.isnan(want))
            and np.array_equal(got[~np.isnan(got)].view(np.int32),
                               want[~np.isnan(want)].view(np.int32)))
