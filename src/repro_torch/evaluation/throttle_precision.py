"""Paper §6 selftest analogue: throttle-delay precision.

The paper configures a 2000 ms memcg_bpf_ops delay and measures
2.000 +/- 0.046 s (2.3% relative error).  Our in-step controller
quantizes delays to engine steps; we measure:
  (1) mechanism precision — configured delay vs the step at which the
      slot gate actually reopens (quantization error), and
  (2) wall-clock precision — the same, timed through the REAL jitted
      engine step on a reduced model.

Port of ``benchmarks/throttle_precision.py`` as a module of the port:
the charge and every gate evaluation go through the facade's device
view (``DeviceView.gate``: the gate kernel on the card, its plain
version on CPU tensors), the wall-clock half paced at ``step_ms`` by a
busy wait as in the source (which, like this module, times the gate
evaluations, not a model step); the same printed lines and returned
dict.
Runs on the card unless ``--device cpu`` is given.

Run: PYTHONPATH=src python -m repro_torch.evaluation.throttle_precision \\
         [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.core.cgroup import AgentCgroup, DeviceTableBackend, DomainSpec
from repro_torch.core.controller import ControllerConfig


def _throttled_view(delay_ms: float, step_ms: float, device="cuda"):
    """One over-``high`` charge through the unified control plane;
    returns the device view + post-charge state + the domain index
    (as a one-slot tensor on the table's device)."""
    cfg = ControllerConfig(step_ms=step_ms, base_delay_ms=delay_ms,
                           max_delay_ms=delay_ms, overage_gain=0.0)
    cg = AgentCgroup(DeviceTableBackend(10_000, n_domains=8, cfg=cfg,
                                        device=device))
    idx = cg.mkdir("/s", DomainSpec(high=10))
    view = cg.device_view()
    dev = view.state["usage"].device
    dom = torch.tensor([idx], dtype=torch.int32, device=dev)
    st, granted, _ = view.charge(view.state, dom,
                                 torch.tensor([50], dtype=torch.int32,
                                              device=dev), 0)
    assert bool(granted[0])
    return view, st, dom


def mechanism_precision(delay_ms: float = 2000.0, step_ms: float = 10.0,
                        device="cuda"):
    view, st, dom = _throttled_view(delay_ms, step_ms, device)
    reopened = None
    for step in range(1, int(delay_ms / step_ms) + 10):
        if bool(view.gate(st, dom, step)[0]):
            reopened = step
            break
    measured = reopened * step_ms
    err = abs(measured - delay_ms) / delay_ms
    return measured, err


def wallclock_precision(delay_ms: float = 2000.0, step_ms: float = 10.0,
                        device="cuda"):
    """Time the reopen through actual gate evaluations, pacing steps at
    step_ms (the engine cadence)."""
    view, st, dom = _throttled_view(delay_ms, step_ms, device)
    bool(view.gate(st, dom, 0)[0])                 # warm the kernel
    t0 = time.perf_counter()
    step = 0
    deadline = t0
    while True:
        step += 1
        deadline += step_ms / 1000.0
        while time.perf_counter() < deadline:
            pass
        if bool(view.gate(st, dom, step)[0]):
            break
    measured = (time.perf_counter() - t0) * 1000.0
    err = abs(measured - delay_ms) / delay_ms
    return measured, err


def run(device="cuda"):
    m_ms, m_err = mechanism_precision(device=device)
    w_ms, w_err = wallclock_precision(device=device)
    print("\n== throttle precision (paper: 2.000 +/- 0.046 s, 2.3%) ==")
    print(f"mechanism : configured 2000 ms, reopened at {m_ms:.0f} ms "
          f"(err {m_err * 100:.2f}%)")
    print(f"wall-clock: configured 2000 ms, measured {w_ms:.1f} ms "
          f"(err {w_err * 100:.2f}%)")
    return {"mechanism_ms": m_ms, "mechanism_err": m_err,
            "wall_ms": w_ms, "wall_err": w_err}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
