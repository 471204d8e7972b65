"""Quickstart: the three layers of the framework (port of
``examples/quickstart.py``).

 1. resource domains + in-step controller (the AgentCgroup core),
 2. a reduced model doing a few training steps,
 3. a multi-tenant serving engine with enforcement.

The device table, its in-step charge, the training steps and the engine
run on the card unless ``--device cpu`` is given (there: the fused
charge kernel, the f32 flash forward and backward, the f32 decode
kernel); the host tree and the async daemon around it run on the host.

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import torch
from torch.utils._pytree import tree_map

from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.core import domains as D
from repro_torch.core.cgroup import (AgentCgroup, DeviceTableBackend,
                                     DomainSpec, HostTreeBackend)
from repro_torch.core.controller import ControllerConfig, resolve_device
from repro_torch.core.daemon import AsyncDaemonBackend
from repro_torch.core.intent import Hint
from repro_torch.core.progs import TokenBucketProgram
from repro_torch.data.pipeline import DataIterator
from repro_torch.models import model as M
from repro_torch.perf import DEFAULT_PERF, replace as perf_replace
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.session import Phase, Session
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_step import init_train_state, make_train_step

# the charges that reach a device table outside the engine: one in §1's
# drive, one in-step charge in §1b, three in §1c (one fused charge
# launch each on the card)
DEVICE_CHARGES = 5


def drive(cg: AgentCgroup) -> dict:
    """The SAME op sequence works against any backend: mkdir a
    hierarchy, declare a tool-call lease from an intent hint, charge
    through it, close the lease (residual transfers to the session)."""
    cg.mkdir("/tenant", DomainSpec(high=800))
    cg.mkdir("/tenant/sess", DomainSpec(priority=D.HIGH))
    lease = cg.intent.declare("tool_1", Hint.LOW, parent="/tenant/sess",
                              high=50)
    ticket = cg.try_charge(lease.path, 80)
    granted = ticket.granted
    lease.close()                      # rmdir + residual moves upward
    return {"granted": granted, "root": cg.usage("/"),
            "sess": cg.usage("/tenant/sess"),
            "sess_peak": cg.peak("/tenant/sess")}


def control_plane(device) -> dict:
    """§1: one op sequence through the host tree, the device table and
    the async daemon around a host tree; then a ``memory.high`` breach
    on both host-class backends and their ``memory.events``."""
    print("== 1. one cgroupfs-style control plane, two backends ==")
    # zero-delay config so host and device grant/deny semantics align
    no_throttle = ControllerConfig(base_delay_ms=0.0, max_delay_ms=0.0)
    host_cg = AgentCgroup(HostTreeBackend(1000))
    # the async lifecycle daemon: same ops, but queued to a daemon thread
    # and applied in FIFO epochs — bit-exact with its inner backend
    async_cg = AgentCgroup(AsyncDaemonBackend(HostTreeBackend(1000)))
    try:
        host = drive(host_cg)
        dev = drive(AgentCgroup(DeviceTableBackend(1000, cfg=no_throttle,
                                                   device=device)))
        asy = drive(async_cg)
        epoch = async_cg.backend.epoch
        print(f"host   backend: {host}")
        print(f"device backend: {dev}")
        print(f"async  backend: {asy} (epoch {epoch})")
        if not host == dev == asy:
            raise AssertionError("backends diverged!")
        # identical op sequence -> identical memcg event counters, async
        # or not: shrink the session high and breach it on both
        for c in (host_cg, async_cg):
            c.write("/tenant/sess", "memory.high", 10)
            c.try_charge("/tenant/sess", 20)   # high breach + throttle
        ev_host = host_cg.read("/tenant/sess", "memory.events")
        ev_async = async_cg.read("/tenant/sess", "memory.events")
    finally:
        async_cg.backend.close()
    print(f"memory.events: host {ev_host} == async {ev_async}")
    if ev_host != ev_async:
        raise AssertionError("event counters diverged!")
    return {"host": host, "device": dev, "async": asy, "epoch": epoch,
            "events_host": ev_host, "events_async": ev_async}


def extras(device) -> dict:
    """§1b: the host tree's graduated delay, and one in-step charge
    through the device table's view (the fused charge kernel on the
    card)."""
    print("\n== 1b. backend-specific extras ==")
    cg = AgentCgroup(HostTreeBackend(1000))
    cg.mkdir("/sess", DomainSpec(high=50))
    t = cg.try_charge("/sess", 80)
    events = cg.read("/sess", "memory.events")
    print(f"host:   memory.events = {events}, "
          f"graduated delay {t.delay_ms:.0f} ms")
    dcg = AgentCgroup(DeviceTableBackend(1000, cfg=ControllerConfig(),
                                         device=device))
    idx = dcg.mkdir("/sess", DomainSpec(high=50))
    view = dcg.device_view()
    st, granted, _ = view.charge(
        view.state, torch.tensor([idx], dtype=torch.int32, device=device),
        torch.tensor([80], dtype=torch.int32, device=device), 0)
    granted = bool(granted[0])
    until = int(st["throttle_until"][idx])
    print(f"device: in-step charge granted={granted}, "
          f"throttled until step {until}")
    return {"events": events, "delay_ms": t.delay_ms, "granted": granted,
            "throttle_until": until}


def programs(device) -> tuple:
    """§1c: a token-bucket program on the device table, retuned live
    between charges: the three grants."""
    print("\n== 1c. pluggable policy programs (memcg_bpf_ops analogue) ==")
    pcg = AgentCgroup(DeviceTableBackend(1000, device=device))
    pcg.attach("/", TokenBucketProgram(bucket_capacity=16, refill=(1, 2, 4)))
    pcg.mkdir("/agent")
    g0 = pcg.try_charge("/agent", 16, step=0).granted    # drains the bucket
    g1 = pcg.try_charge("/agent", 16, step=1).granted    # rate-limited
    pcg.update_params("/agent", refill_normal=16.0)      # live retune
    g2 = pcg.try_charge("/agent", 16, step=2).granted    # refilled
    print(f"token bucket: step0 granted={g0}, step1 granted={g1}, "
          f"after update_params(refill_normal=16) step2 granted={g2}")
    if (g0, g1, g2) != (True, False, True):
        raise AssertionError(f"token bucket grants {(g0, g1, g2)}")
    return g0, g1, g2


def model_config():
    return dataclasses.replace(reduced(get_config("llama3.2-3b")),
                               dtype="float32")


def train(device, params=None) -> tuple:
    """§2: 10 f32 train steps of the reduced llama3.2-3b; returns
    (cfg, the trained parameters, the loss of every step)."""
    print("\n== 2. train a reduced llama3.2 for 10 steps ==")
    cfg = model_config()
    if params is None:
        params = M.init_params(cfg, torch.Generator(device=device)
                               .manual_seed(0), device=device)
    perf = perf_replace(DEFAULT_PERF, scan_chunk=32, remat="none")
    step = make_train_step(cfg, perf, OptConfig(lr=1e-3, warmup_steps=2,
                                                total_steps=10))
    opt = init_train_state(cfg, params, perf)
    data = DataIterator(cfg, SHAPES["train_4k"], seed=0, batch=4, seq=64,
                        device=device)
    losses = []
    for i in range(10):
        params, opt, m = step(params, opt, data.at(i), i)
        losses.append(float(m["loss"]))
        if i % 3 == 0:
            print(f"  step {i}: loss {losses[-1]:.3f}")
    return cfg, params, losses


def serve(cfg, params, device) -> Engine:
    """§3: two agent sessions served under in-step enforcement; returns
    the finished engine."""
    print("\n== 3. serve two agent sessions under AgentCgroup ==")
    # the trained weights as plain tensors: decoding records no graph
    params = tree_map(torch.Tensor.detach, params)
    eng = Engine(cfg, params,
                 ecfg=EngineConfig(max_slots=2, s_max=256, pool_pages=24,
                                   page_tokens=16, mode="inkernel"),
                 device=device)
    eng.submit(Session(sid="hi", tenant="t", priority=D.HIGH,
                       prompt=list(range(2, 18)),
                       phases=[Phase(8, 64, "test"), Phase(8, 0)]))
    eng.submit(Session(sid="lo", tenant="t", priority=D.LOW,
                       prompt=list(range(2, 18)),
                       phases=[Phase(8, 96, "test"), Phase(8, 0)]))
    eng.run(3000)
    r = eng.report()
    print(f"  survival={r['survival']:.0%} throttles={r['throttle_triggers']} "
          f"freezes={r['freezes']} pool_overshoot={r['overshoot_pages']} "
          f"pages")
    return eng


def main(argv=None, params=None) -> dict:
    """Run the three sections; returns what each printed (the report of
    §3 whole).  ``params`` (the reduced f32 llama's weights on the
    device) is drawn from a generator seeded with 0 when not given."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    out = {"control_plane": control_plane(dev), "extras": extras(dev),
           "programs": programs(dev)}
    cfg, params, out["losses"] = train(dev, params)
    eng = serve(cfg, params, dev)
    out["report"], out["engine_steps"] = eng.report(), eng.step_no
    print("\nquickstart done.")
    return out


if __name__ == "__main__":
    main()
