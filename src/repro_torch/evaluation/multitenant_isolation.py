"""Per-tenant isolation under concurrent burst replays (paper Fig-8
workload, N tenants) — shared single-device table vs the sharded
multi-tenant backend.

Every tenant replays the same agent rhythm: steady decode-page
allocation plus periodic tool-result bursts; tenant 0 is the aggressor
(oversized bursts).  Both configurations get the SAME aggregate page
pool:

  * ``shared``   — one ``DeviceTableBackend`` table, every tenant charges
    the same root: an aggressor burst consumes pool the victims then
    cannot get (the paper's §3 memory-interference finding);
  * ``sharded``  — ``ShardedTableBackend`` with one device group per
    tenant, each owning 1/N of the pool: the in-step charge gates each
    tenant only against its own group.

Reported per tenant: grant rate, denial count, longest stall streak,
and peak pages; the interference headline is the victims' denial rate
delta between the two configurations.

A second scenario exercises the CPU half (``cpu.weight``): four
tenants with weights 400/200/100/100 compete for two decode slots per
step under ``WeightedFairProgram``, against a uniform-weight baseline.
Grant shares must track the flattened weight ratios within 5%, and the
high-weight tenant's P99 gap between consecutive grants must be lower
than under the uniform gate — weight buys latency, not just share.

Port of ``benchmarks/multitenant_isolation.py`` as a module of the
port.  The source spreads its groups over an N-device mesh (8 fake
devices by default); here the sharded backend stacks ``--shards``
groups (default 8) as ``(S, n)`` tables on one device, and the in-step
charge serves every shard in one launch of the charge kernel on the
card.  The header line names those shards where the source names its
devices; every other printed line, returned value and assertion is the
source's.  Runs on the card unless ``--device cpu`` is given.

Run: PYTHONPATH=src python -m repro_torch.evaluation.multitenant_isolation \\
         [--quick] [--shards 8] [--device cpu]
``--quick`` runs only the fairness scenario with its tolerance
assertion (the CI bench-smoke entry).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.cgroup import (AgentCgroup, DeviceTableBackend,
                                     DomainSpec)
from repro_torch.core.controller import ControllerConfig, resolve_device
from repro_torch.core.sharded import ShardedTableBackend
from repro_torch.evaluation import sync

CTRL = ControllerConfig(base_delay_ms=10.0, max_delay_ms=200.0)
SHARDS = 8                  # the source's fake-device count


def burst_schedule(n_tenants: int, steps: int) -> np.ndarray:
    """(steps, n_tenants) page requests: steady decode trickle for all,
    plus tool-result bursts — oversized for the aggressor (tenant 0)."""
    amt = np.zeros((steps, n_tenants), np.int32)
    amt[::4, :] = 1                              # decode page crossings
    for t in range(n_tenants):
        period, start = 50, 10 + 3 * t
        size = 24 if t == 0 else 4               # aggressor vs victims
        for s in range(start, steps, period):
            amt[s:s + 8, t] += size
    return amt


def run_config(kind: str, n_tenants: int, steps: int, pool: int, *,
               shards: int = SHARDS, device="cuda") -> dict:
    dev = resolve_device(device)
    if kind == "sharded":
        # split the SAME aggregate pool over the shards actually built
        # (tenants share a shard when they outnumber shards)
        n_sh = min(n_tenants, shards)
        be = ShardedTableBackend(pool // n_sh, n_domains=8, cfg=CTRL,
                                 n_shards=n_sh, device=dev)
    else:
        be = DeviceTableBackend(pool, n_domains=4 * n_tenants + 4, cfg=CTRL,
                                device=dev)
    cg = AgentCgroup(be)
    handles = []
    for t in range(n_tenants):
        cg.mkdir(f"/t{t}")
        handles.append(cg.mkdir(f"/t{t}/sess", DomainSpec()))
    view = cg.device_view()

    amt_all = burst_schedule(n_tenants, steps)
    dom = torch.tensor(handles, dtype=torch.int32, device=dev)
    grants = np.zeros((steps, n_tenants), bool)
    requested = amt_all > 0
    state = view.state
    t0 = time.perf_counter()
    for s in range(steps):
        state, g, _ = view.charge(state, dom,
                                  torch.as_tensor(amt_all[s], device=dev), s)
        grants[s] = g.cpu().numpy()
        # a granted burst's pages retire two steps later (tool output
        # consumed), keeping usage oscillating the way serving does
        if s >= 2:
            retire = torch.as_tensor(
                np.where(grants[s - 2], amt_all[s - 2], 0), device=dev)
            state = view.uncharge(state, dom, retire)
    sync(dev)
    dt = time.perf_counter() - t0
    view.commit(state)

    out = {"kind": kind, "steps_per_s": steps / dt, "tenants": []}
    for t in range(n_tenants):
        req = requested[:, t]
        ok = grants[:, t] & req
        denied = req & ~grants[:, t]
        streak = best = 0
        for d in denied:
            streak = streak + 1 if d else 0
            best = max(best, streak)
        out["tenants"].append({
            "tenant": f"/t{t}",
            "requests": int(req.sum()),
            "grant_rate": float(ok.sum() / max(req.sum(), 1)),
            "denials": int(denied.sum()),
            "max_stall_steps": best,
            "peak_pages": cg.peak(f"/t{t}"),
        })
    victims = out["tenants"][1:]
    out["victim_denial_rate"] = float(
        sum(v["denials"] for v in victims)
        / max(sum(v["requests"] for v in victims), 1))
    return out


def run_fairness(weights=(400, 200, 100, 100), steps: int = 2000,
                 budget: int = 2, tol: float = 0.05, *,
                 device="cuda") -> dict:
    """Weighted decode-slot fairness: the same always-runnable slot mix
    under ``WeightedFairProgram``, weighted vs uniform-weight baseline.

    Asserts (a) grant shares within ``tol`` relative of the flattened
    weight ratios and (b) the top-weight tenant's P99 grant gap strictly
    below its uniform-baseline gap.
    """
    from repro_torch.core.sched import WeightedFairProgram

    dev = resolve_device(device)
    n = len(weights)
    results = {}
    for label, ws in (("weighted", tuple(weights)),
                      ("uniform", (100,) * n)):
        be = DeviceTableBackend(10 ** 6, n_domains=n + 4, cfg=CTRL,
                                prog=WeightedFairProgram(
                                    base_delay_ms=0.0, max_delay_ms=0.0),
                                device=dev)
        cg = AgentCgroup(be)
        handles = [cg.mkdir(f"/t{t}", DomainSpec(weight=w))
                   for t, w in enumerate(ws)]
        view = cg.device_view()

        dom = torch.tensor(handles, dtype=torch.int32, device=dev)
        cost = torch.ones((n,), dtype=torch.int32, device=dev)
        grants = np.zeros((steps, n), bool)
        state = view.state
        t0 = time.perf_counter()
        for s in range(steps):
            state, adv = view.schedule(state, dom, cost, s, budget)
            grants[s] = adv.cpu().numpy()
        sync(dev)
        dt = time.perf_counter() - t0
        view.commit(state)

        share = grants.sum(axis=0) / max(int(grants.sum()), 1)
        p99 = []
        for t in range(n):
            gap = np.diff(np.flatnonzero(grants[:, t]))
            p99.append(float(np.percentile(gap, 99)) if gap.size
                       else float("inf"))
        results[label] = {"share": share.tolist(), "p99_gap": p99,
                          "steps_per_s": steps / dt}

    expect = [w / sum(weights) for w in weights]
    got = results["weighted"]["share"]
    for t, (e, g) in enumerate(zip(expect, got)):
        assert abs(g - e) <= tol * e, (
            f"tenant /t{t}: share {g:.3f} vs weight ratio {e:.3f} "
            f"(>{100 * tol:.0f}% off)")
    hi = int(np.argmax(weights))
    assert (results["weighted"]["p99_gap"][hi]
            < results["uniform"]["p99_gap"][hi]), (
        "high-weight tenant's P99 grant gap did not improve over the "
        "uniform baseline")

    print(f"\n== weighted decode-slot fairness: {n} tenants, weights "
          f"{list(weights)}, {budget} slots/step, {steps} steps ==")
    print(f"{'tenant':8s} {'weight':>6s} {'share':>7s} {'expect':>7s} "
          f"{'p99gap':>7s} {'uniform':>8s}")
    for t in range(n):
        print(f"/t{t:<6d} {weights[t]:6d} {got[t]:7.3f} {expect[t]:7.3f} "
              f"{results['weighted']['p99_gap'][t]:7.0f} "
              f"{results['uniform']['p99_gap'][t]:8.0f}")
    print(f"shares within {100 * tol:.0f}% of weight ratios; high-weight "
          f"p99 gap {results['weighted']['p99_gap'][hi]:.0f} vs uniform "
          f"{results['uniform']['p99_gap'][hi]:.0f} steps "
          f"({results['weighted']['steps_per_s']:.0f} sched-steps/s)")
    return results


def run(device="cuda") -> dict:
    """Suite entry point (``evaluation.run``): the weighted-fairness
    scenario; the sharded isolation comparison stays CLI-only."""
    return run_fairness(steps=1200, device=device)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--pool", type=int, default=256)
    ap.add_argument("--quick", action="store_true",
                    help="fairness scenario + tolerance assertion only "
                         "(CI bench-smoke)")
    ap.add_argument("--shards", type=int, default=SHARDS,
                    help="device groups of the sharded configuration, "
                         "stacked on the one device")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)

    if args.quick:
        run_fairness(steps=400, device=dev)
        print("quick fairness check: PASS")
        return {}

    print(f"\n== multi-tenant burst isolation: {args.tenants} tenants, "
          f"{args.steps} steps, {args.pool}-page aggregate pool, "
          f"{args.shards} shards on one {dev.type} device ==")
    results = {}
    for kind in ("shared", "sharded"):
        r = run_config(kind, args.tenants, args.steps, args.pool,
                       shards=args.shards, device=dev)
        results[kind] = r
        print(f"\n[{kind}]  {r['steps_per_s']:.0f} charge-steps/s, "
              f"victim denial rate {r['victim_denial_rate']:.3f}")
        print(f"{'tenant':8s} {'reqs':>5s} {'grant%':>7s} {'denied':>6s} "
              f"{'stallmax':>8s} {'peak':>5s}")
        for row in r["tenants"]:
            print(f"{row['tenant']:8s} {row['requests']:5d} "
                  f"{100 * row['grant_rate']:6.1f}% {row['denials']:6d} "
                  f"{row['max_stall_steps']:8d} {row['peak_pages']:5d}")
    shared = results["shared"]["victim_denial_rate"]
    shard = results["sharded"]["victim_denial_rate"]
    print(f"\nvictim denial rate: shared={shared:.3f}  sharded={shard:.3f}"
          f"  (interference removed: "
          f"{100 * (shared - shard) / max(shared, 1e-9):.0f}%)")
    results["fairness"] = run_fairness(device=dev)
    return results


if __name__ == "__main__":
    main()
