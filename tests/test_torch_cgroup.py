"""The port's control plane against the JAX package: the same op
sequences through the JAX ``AgentCgroup(DeviceTableBackend)`` and the
port's (on CPU tensors) — mkdir, charges on the step clock, control-file
writes, a lease declare/close with residual transfer, freeze/thaw, a
subtree kill with its typed OOM event, ``memory.events``,
``memory.pressure``, scheduling rounds, program attach/retune, and
snapshot/restore.  Every read must be identical."""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import cgroup as JCG
from repro.core import domains as JD
from repro.core import progs as JP
from repro.core import sched as JS
from repro.core.controller import ControllerConfig as JCfg
from repro.core.intent import Hint as JHint
from repro_torch.core import cgroup as TCG
from repro_torch.core import domains as TD
from repro_torch.core import progs as TP
from repro_torch.core import sched as TS
from repro_torch.core.controller import ControllerConfig as TCfg
from repro_torch.core.intent import Hint as THint

FILES = ("memory.current", "memory.peak", "memory.high", "memory.max",
         "memory.low", "memory.priority", "memory.events", "cgroup.freeze",
         "cpu.weight", "cpu.max", "memory.stall", "cpu.stall",
         "memory.pressure", "cpu.pressure")


class Side:
    """One package's modules, so one op script drives either."""

    def __init__(self, cg, D, P, S, Hint, CG):
        self.cg, self.D, self.P, self.S, self.Hint, self.CG = \
            cg, D, P, S, Hint, CG


def jax_side(capacity=120):
    cg = JCG.AgentCgroup(JCG.DeviceTableBackend(
        capacity, n_domains=24, cfg=JCfg(step_ms=10.0)))
    return Side(cg, JD, JP, JS, JHint, JCG)


def torch_side(capacity=120):
    cg = TCG.AgentCgroup(TCG.DeviceTableBackend(
        capacity, n_domains=24, cfg=TCfg(step_ms=10.0), device="cpu"))
    return Side(cg, TD, TP, TS, THint, TCG)


def norm(x):
    """Reads as plain python values, whatever array type carried them."""
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if hasattr(x, "tolist"):
        return x.tolist()
    if dataclasses.is_dataclass(x):
        return norm(dataclasses.asdict(x))
    return x


def observe(side: Side, out: list):
    cg = side.cg
    for p in sorted(cg.paths()):
        out.append((p, {f: norm(cg.read(p, f)) for f in FILES}))


def scripted(side: Side) -> list:
    """A fixed op sequence covering every lifecycle op of the slice."""
    cg, D = side.cg, side.D
    obs = []
    cg.pressure_clock(step_quantum=1.0, windows=(20.0, 60.0))
    cg.mkdir("/a")
    cg.mkdir("/b")
    cg.mkdir("/a/s1", side.CG.DomainSpec(high=20, priority=D.HIGH, low=8))
    cg.mkdir("/a/s2", side.CG.DomainSpec(high=12, max=30, priority=D.LOW))
    cg.mkdir("/b/s3", side.CG.DomainSpec(weight=300, cpu_max=2))
    tickets = []
    for step in range(12):
        cg.set_time(step)
        for path, amt in (("/a/s1", 3), ("/a/s2", 4), ("/b/s3", 5)):
            t = cg.try_charge(path, amt, step)
            tickets.append((t.granted, t.stalled, t.delay_ms))
        if step == 4:
            cg.write("/a/s2", "memory.high", 40)
            cg.write("/b/s3", "cpu.weight", 50)
        if step == 6:
            lease = cg.intent.declare("tool_1", side.Hint.HIGH,
                                      parent="/a/s1", priority=D.HIGH)
            for _ in range(3):
                t = cg.try_charge(lease.path, 2, step)
                tickets.append((t.granted, t.stalled, t.delay_ms))
            observe(side, obs)
            obs.append(("lease_fb", norm(lease.feedback("throttled"))))
            obs.append(("residual", lease.close()))
        if step == 8:
            cg.freeze("/a/s2")
            obs.append(("gate_frozen", cg.try_charge("/a/s2", 1, step)
                        .granted))
        if step == 10:
            cg.thaw("/a/s2")
            cg.uncharge("/a/s2", 4)
            cg.charge_unchecked("/a/s2", 2)
        obs.append(("sched", cg.schedule(["/a/s1", "/a/s2", "/b/s3",
                                          "/b/s3"], [1, 1, 1, 2], step, 2)))
    obs.append(("tickets", tickets))
    observe(side, obs)
    lease = cg.intent.declare("tool_2", None, parent="/b/s3", max=9)
    cg.try_charge(lease.path, 4, 12)
    obs.append(("killed", cg.kill("/b/s3")))
    obs.append(("oom", [(e.path, e.session, e.peak_pages, e.limit_pages,
                         e.residual_pages)
                        for e in cg.intent.oom_events("/b/s3")]))
    obs.append(("residual_rm", cg.rmdir("/a/s2")))
    observe(side, obs)
    snap = cg.snapshot()
    obs.append(("snapshot", {k: norm(v) for k, v in snap.items()}))
    return obs


def test_scripted_sequence_identical():
    assert scripted(torch_side()) == scripted(jax_side())


def test_snapshot_restore_roundtrip_identical():
    outs = []
    for make in (jax_side, torch_side):
        src = make()
        scripted(src)
        dst = make()
        dst.cg.restore(src.cg.snapshot())
        obs = []
        observe(dst, obs)
        dst.cg.set_time(20)
        obs.append(dst.cg.try_charge("/a/s1", 5, 20).granted)
        outs.append(obs)
    assert outs[0] == outs[1]


def programs(side: Side):
    return (side.P.TokenBucketProgram(bucket_capacity=5.0,
                                      refill=(1.0, 2.0, 3.0)),
            side.S.WeightedFairProgram())


@pytest.mark.parametrize("seed", range(3))
def test_random_ops_identical(seed):
    """Seeded random charges, uncharges, writes and freezes, with a
    token-bucket and then a weighted-fair subtree attach and a retune;
    every read compared every few steps."""
    def run(side: Side):
        rng = np.random.default_rng(seed)
        cg, D = side.cg, side.D
        tb, wf = programs(side)
        paths = ["/t0", "/t1"]
        for p in paths:
            cg.mkdir(p)
        obs = []
        for step in range(40):
            cg.set_time(step)
            op = rng.integers(0, 7)
            p = paths[rng.integers(0, len(paths))]
            if op == 0 and len(paths) < 10:
                parent = paths[rng.integers(0, len(paths))]
                if parent.count("/") < 3:
                    child = f"{parent}/c{step}"
                    cg.mkdir(child, side.CG.DomainSpec(
                        high=int(rng.integers(2, 30)),
                        priority=int(rng.integers(0, 3))))
                    paths.append(child)
            elif op in (1, 2, 3):
                t = cg.try_charge(p, int(rng.integers(0, 9)), step)
                obs.append((t.granted, t.stalled, t.delay_ms))
            elif op == 4:
                cg.uncharge(p, int(rng.integers(0, 3)))
            elif op == 5:
                (cg.freeze if rng.random() < 0.5 else cg.thaw)(p)
            elif op == 6:
                cg.write(p, "memory.high", int(rng.integers(1, 40)))
            if step in (10, 25):
                cg.attach(paths[0], tb if step == 10 else wf)
                cg.update_params(paths[0], overage_gain=2.5)
            if step % 4 == 3:
                observe(side, obs)
        observe(side, obs)
        return obs
    assert run(torch_side()) == run(jax_side())


@pytest.mark.parametrize("seed", range(2))
def test_domain_tree_copy_identical(seed):
    """The port's pure-Python ``DomainTree`` (the host tree the next
    slice's ``HostTreeBackend`` wraps) replays seeded charges, freezes
    and kills exactly as the reference's."""
    def run(D):
        rng = np.random.default_rng(seed)
        tree = D.DomainTree(60)
        paths = ["/a", "/b", "/a/x", "/a/y", "/b/z"]
        for p in paths:
            tree.create(p, high=int(rng.integers(5, 30)),
                        max=int(rng.integers(20, 50)),
                        priority=int(rng.integers(0, 3)))
        out = []
        for i in range(60):
            tree.now_ms = float(i * 10)
            p = paths[int(rng.integers(0, len(paths)))]
            op = int(rng.integers(0, 6))
            if op < 3:
                r = tree.try_charge(p, int(rng.integers(1, 8)))
                out.append((r.ok, r.blocked_by, tuple(r.over_high)))
            elif op == 3:
                tree.uncharge(p, min(tree.usage(p), 3))
            elif op == 4:
                (tree.freeze if rng.random() < 0.5 else tree.thaw)(p)
            out.append(tree.throttle_delay_ms(p))
            out.append([tree.usage(q) for q in paths])
        out.append(tree.kill("/a"))
        out.append([(e.t_ms, e.kind.value, e.domain, e.detail)
                    for e in tree.log.events])
        return out
    assert run(TD) == run(JD)
