"""The fused charge and slot-gate kernels' time on the card, as the
serving step meets them, at the three table shapes of ``SHAPES``:

    PYTHONPATH=src python -m repro_torch.kernels.enforcement_bench [--parent DIR]

Each shape is a tree like the engine's (``serving/engine.py`` builds
``n = 4 max_slots + 8`` domains): the root, 7 tenants, one session
domain a slot and one tool-call domain a session, the rest free.  Its
limits are set so that some slots throttle (tenants over ``memory.high``,
throttle windows still open), some are denied (sessions at
``memory.max``) and some are frozen; every slot charges its session or
its tool-call domain, a tenth of them dead (``dom = -1``).

=======  =====  =====  ===============================================
shape    n      m      registry (P)
=======  =====  =====  ===============================================
engine   40     8      graduated program (4): ``engine_full``'s table
wide     1,032  256    mixed stock registry (10): max_slots 256
beyond   4,104  1,024  mixed stock registry (10): max_slots 1024
=======  =====  =====  ===============================================

For each kernel (``charge``, ``gate``), shape and implementation, one
JSON line with:

``device_ms``   the kernel's device time a call from ``torch.profiler``
                (``timing.device_ms``), cold: a 64 MB write between
                calls, as the step meets the table after 28 decode
                layers;
``issue_ms``    the issue pace, ``timing.cuda_ms`` over calls issued
                back to back (the slower of the host and the device);
``host_ms``     the wrapper's host time a call, by part: ``checks``
                (device, type, shape, contiguity), ``constants`` (kind
                codes, ``1 / step_ms``), ``alloc`` (the outputs),
                ``call`` (the ctypes call, which launches), and
                ``wrapper`` (the whole public call), each from the host
                clock over calls without a synchronize;
``bound_ms``    the bytes bound (``timing.bound_ms``): the slots, the
                static columns of the domains they touch, and every
                domain's mutable row read once and written once;
``bit_exact``   the outputs against the plain version on the same
                inputs.

One more line per shape gives the launch floor: the device time, issue
pace and host time of ``csrc/enforcement.cu``'s empty kernel launched
through the same ctypes path.  With ``--parent DIR`` the enforcement
wrapper and ``csrc/enforcement.cu`` of another checkout at DIR (e.g.
``git archive <commit> | tar -x -C build/parent``) are built and timed
in the same process, in turns (parent, this, this, parent); its host
parts are timed on the same pieces of its own code.  Where the parent
refuses a shape (its kernel staged the whole table in shared memory),
its line records the error and the run goes on.  Prints the card's name
and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import controller as C
from repro_torch.core import domains as D
from repro_torch.core.progs import (GraduatedThrottleProgram, PolicyProgram,
                                    TokenBucketProgram, pad_row)
from repro_torch.core.sched import WeightedFairProgram
from repro_torch.kernels import _build, timing

TENANTS = 7
SHAPES = {
    "engine": dict(slots=8, registry="graduated", calls=200),
    "wide": dict(slots=256, registry="mixed", calls=100),
    "beyond": dict(slots=1024, registry="mixed", calls=40),
}
FLUSH_BYTES = 64 << 20
INT32_MAX = 2**31 - 1
STATE_KEYS = ("usage", "peak", "throttle_until", "prog", "mem_stall")


def registries() -> dict:
    """Every stock program alone, and all of them in one registry."""
    grad = GraduatedThrottleProgram(step_ms=10.0, overage_gain=7.5)
    tb = TokenBucketProgram(step_ms=10.0, bucket_capacity=6.0,
                            refill=(0.7, 1.3, 2.9))
    wf = WeightedFairProgram(step_ms=10.0)
    return {"graduated": (grad,), "token_bucket": (tb,),
            "weighted_fair": (wf,),
            "mixed": (grad, tb, wf, PolicyProgram())}


def engine_case(slots: int, progs, seed: int, device, *, negative=False,
                dup=False, ancestor=False, peak_below=False,
                prog_oob=False) -> tuple:
    """``(state, dom, amt, step)`` of one charge over an engine-shaped
    table of ``4 slots + 8`` domains (module docstring), from a seeded
    generator.  Options for the checks: ``negative`` amounts on a
    quarter of the slots; ``dup`` slots that charge slot 0's domain
    again; ``ancestor``: slot 0 charges a tenant over its
    ``memory.high`` whose session slot 1 charges, so slot 0's throttle
    denies slot 1 in the same batch; ``peak_below``: peaks under usage;
    ``prog_oob``: program ids outside the registry."""
    rng = np.random.default_rng(seed)
    n, m = 4 * slots + 8, slots
    step = int(rng.integers(20, 200))
    sess = 8 + np.arange(slots)
    tool = sess + slots
    parent = np.full(n, -1, np.int32)
    parent[1:8] = 0
    parent[sess] = 1 + rng.integers(0, TENANTS, slots)
    parent[tool] = sess
    usage = np.zeros(n, np.int64)
    usage[tool] = rng.integers(0, 24, slots)
    usage[sess] = usage[tool] + rng.integers(4, 40, slots)
    np.add.at(usage, parent[sess], usage[sess])
    usage[0] = usage[1:8].sum()
    high = np.full(n, INT32_MAX, np.int64)
    mx = np.full(n, INT32_MAX, np.int64)
    low = np.zeros(n, np.int64)
    high[0] = mx[0] = usage[0] + 4 * slots
    high[1:8] = usage[1:8] + rng.integers(-5, 30, TENANTS)
    mx[sess] = np.where(rng.random(slots) < 0.5,
                        usage[sess] + rng.integers(0, 12, slots), INT32_MAX)
    high[sess] = np.where(rng.random(slots) < 0.3,
                          usage[sess] + rng.integers(-3, 6, slots),
                          INT32_MAX)
    low[sess] = np.where(rng.random(slots) < 0.2, usage[sess] + 8, 0)
    mx[tool] = usage[tool] + rng.integers(0, 50, slots)
    frozen = np.zeros(n, bool)
    frozen[sess] = rng.random(slots) < 0.05
    frozen[1 + rng.integers(0, TENANTS)] = rng.random() < 0.3
    tu = np.zeros(n, np.int64)
    hot = rng.random(n) < 0.1
    tu[hot] = step + rng.integers(-2, 4, int(hot.sum()))
    width = max(p.n_params for p in progs)
    prog_id = rng.integers(0, len(progs), n)
    if prog_oob:
        prog_id = rng.integers(-2, len(progs) + 2, n)
    rows = np.stack([pad_row(progs[int(np.clip(k, 0, len(progs) - 1))]
                             .default_row(), width) for k in prog_id])
    if width >= 10:
        rows[:, 4] = rng.uniform(0, 6, n)
        rows[:, 5] = rng.integers(step - 5, step + 1, n)
    peak = usage + rng.integers(0, 10, n)
    if peak_below:
        peak = np.where(rng.random(n) < 0.5,
                        usage - rng.integers(1, 10, n), peak)
    stall = np.where(rng.random(n) < 0.1, INT32_MAX, rng.integers(0, 9, n))
    dom = np.where(rng.random(m) < 0.5, sess, tool)
    dom = np.where(rng.random(m) < 0.1, -1, dom)
    amt = rng.choice([0, 1, 1, 2, 3, 5, 40], m)
    if negative:
        amt = np.where(rng.random(m) < 0.25, -amt, amt)
    if dup and m > 2:
        dom[rng.random(m) < 0.3] = dom[0]
    if ancestor and m > 1:
        t = int(parent[sess[1]])
        dom[0], amt[0], dom[1], amt[1] = t, 5, sess[1], 1
        high[t], low[t], frozen[t], tu[t] = usage[t], 0, False, 0
        mx[0] = high[0] = INT32_MAX
        mx[sess[1]] = INT32_MAX
        frozen[[0, sess[1]]] = False
        tu[[0, sess[1]]] = 0
        prog_id[t] = 0                # the primary program's delays,
        rows[t] = pad_row(progs[0].default_row(), width)
        if width >= 10:
            rows[t, 6] = 0.0          # and no token bucket on the tenant
    cols = {"usage": usage, "peak": peak, "high": high, "max": mx,
            "low": low, "parent": parent, "throttle_until": tu,
            "mem_stall": stall, "prog_id": prog_id,
            "priority": rng.integers(0, 3, n)}
    st = {k: torch.from_numpy(v.astype(np.int32)).to(device)
          for k, v in cols.items()}
    st["frozen"] = torch.from_numpy(frozen).to(device)
    st["prog"] = torch.from_numpy(rows.astype(np.float32)).to(device)
    st["active"] = torch.from_numpy(parent >= 0).to(device)
    st["active"][0] = True
    to = dict(dtype=torch.int32, device=device)
    return (st, torch.as_tensor(dom, **to), torch.as_tensor(amt, **to),
            step)


def shape_case(shape: str, device, seed: int = 0) -> tuple:
    """``(state, dom, amt, step, progs)`` of a bench shape."""
    spec = SHAPES[shape]
    progs = registries()[spec["registry"]]
    return (*engine_case(spec["slots"], progs, seed, device), progs)


def _chains(parent: np.ndarray, dom: np.ndarray) -> list:
    """Each slot's chain as a list (a dead slot: [])."""
    out = []
    for d in dom.tolist():
        chain, i = [], d
        while d >= 0 and i >= 0 and len(chain) < C.DEPTH:
            chain.append(i)
            i = int(parent[i])
        out.append(chain)
    return out


def charge_bound(state: dict, dom) -> tuple:
    """``timing.bound_ms`` of a charge: dom and amt; parent, high, max,
    low, priority, prog_id and frozen of each touched domain; usage,
    peak, throttle_until, mem_stall and the parameter row of every
    domain read and written; granted and stalled; ~40 operations a
    chain level."""
    parent = state["parent"].cpu().numpy()
    d = dom.cpu().numpy()
    chains = _chains(parent, d)
    touched = {x for c in chains for x in c} | ({0} if (d < 0).any()
                                                 else set())
    n, P = state["prog"].shape
    m = len(d)
    n_bytes = (2 * m * 4 + len(touched) * (6 * 4 + 1)
               + 2 * n * (4 * 4 + P * 4) + 2 * m)
    return timing.bound_ms(n_bytes, 40 * sum(map(len, chains)),
                           torch.float32)


def gate_bound(state: dict, dom) -> tuple:
    """``timing.bound_ms`` of a gate: slot_dom, parent, frozen and
    throttle_until of each chain level, the flags."""
    chains = _chains(state["parent"].cpu().numpy(), dom.cpu().numpy())
    levels = sum(map(len, chains))
    m = len(chains)
    return timing.bound_ms(m * 4 + levels * 9 + m, 8 * levels,
                           torch.float32)


def same_tables(a: dict, b: dict) -> bool:
    """Bit-identical over the charge's outputs."""
    return all(torch.equal(a[k].view(torch.int32), b[k].view(torch.int32))
               if a[k].dtype == torch.float32 else torch.equal(a[k], b[k])
               for k in STATE_KEYS)


def cold_device_ms(fn, kernel: str, calls: int, dev) -> tuple:
    """``(device ms, launches)`` a call of the kernels named like
    ``kernel`` that ``fn`` launches, with a 64 MB write between calls."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)

    def call():
        flush.fill_(1)
        fn()

    call()
    torch.cuda.synchronize()
    seen = timing.device_ms(call, calls)
    hits = [v for k, v in seen.items() if kernel in k]
    if not hits:
        raise AssertionError(f"the profiler saw no {kernel}: {list(seen)}")
    return sum(ms for ms, _ in hits), sum(c for _, c in hits)


def host_ms(fn, iters: int) -> float:
    """Host time of one ``fn()`` (no synchronize inside the window)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e3


def this_parts(K, kernel: str, st, dom, amt, step, progs) -> dict:
    """This checkout's wrapper, piece by piece."""
    dev = dom.device
    consts = K.registry_constants(progs)
    if kernel == "gate":
        m, _ = K.gate_checks(st, dom)
        out = torch.empty(m, dtype=torch.bool, device=dev)
        return {
            "constants": lambda: K.registry_constants(progs),
            "checks": lambda: K.gate_checks(st, dom),
            "alloc": lambda: torch.empty(m, dtype=torch.bool, device=dev),
            "call": lambda: K.gate_call(st, dom, step, m, out),
            "wrapper": lambda: K.fused_slot_gate(st, dom, step, progs)}
    m, n, P = K.charge_checks(st, dom, amt)
    buf = K.charge_outputs(m, n, P, dev)[0]
    return {
        "constants": lambda: K.registry_constants(progs),
        "checks": lambda: K.charge_checks(st, dom, amt),
        "alloc": lambda: K.charge_outputs(m, n, P, dev),
        "call": lambda: K.charge_call(st, dom, amt, step, consts, m, n, P,
                                      buf),
        "wrapper": lambda: K.fused_charge_batch(st, dom, amt, step, progs)}


def parent_parts(mod, kernel: str, st, dom, amt, step, progs) -> dict:
    """The parent's ``_launch_charge`` / ``_launch_gate``, cut into the
    same pieces from its own helpers (its wrapper is one function)."""
    dev = dom.device
    m = dom.shape[0]
    n = st["usage"].shape[0]
    P = st["prog"].shape[1]
    i32 = torch.int32

    if kernel == "gate":
        def constants():
            mod.kind_codes(progs)
            for p in progs:
                assert type(p).on_gate is PolicyProgram.on_gate

        def checks():
            mod._check(dom, "slot_dom", i32, (m,), dev)
            for key in ("parent", "throttle_until"):
                mod._check(st[key], key, i32, (n,), dev)
            mod._check(st["frozen"], "frozen", torch.bool, (n,), dev)

        out = torch.empty(m, dtype=torch.bool, device=dev)
        lib = mod._gate_lib()

        def call():
            err = lib.enforcement_gate(
                dom.data_ptr(), m, int(step), st["parent"].data_ptr(),
                st["frozen"].data_ptr(), st["throttle_until"].data_ptr(),
                out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
            _build.check(err, "parent enforcement_gate")

        return {"constants": constants, "checks": checks,
                "alloc": lambda: torch.empty(m, dtype=torch.bool,
                                             device=dev),
                "call": call,
                "wrapper": lambda: mod.fused_slot_gate(st, dom, step, progs)}

    def constants():
        codes = mod.kind_codes(progs)
        return (sum(c << (4 * i) for i, c in enumerate(codes)),
                float(mod.step_reciprocal(progs)))

    def checks():
        mod._check(dom, "dom", i32, (m,), dev)
        mod._check(amt, "amt", i32, (m,), dev)
        for key in ("parent", "high", "max", "low", "priority", "prog_id",
                    "usage", "peak", "throttle_until", "mem_stall"):
            mod._check(st[key], key, i32, (n,), dev)
        mod._check(st["frozen"], "frozen", torch.bool, (n,), dev)
        mod._check(st["prog"], "prog", torch.float32, (n, P), dev)

    def alloc():
        return (torch.empty_like(st["usage"]), torch.empty_like(st["peak"]),
                torch.empty_like(st["throttle_until"]),
                torch.empty_like(st["prog"]),
                torch.empty_like(st["mem_stall"]),
                torch.empty(m, dtype=torch.bool, device=dev),
                torch.empty(m, dtype=torch.bool, device=dev))

    kinds, inv_step = constants()
    outs = alloc()
    lib = mod._charge_lib()

    def call():
        err = lib.enforcement_charge(
            dom.data_ptr(), amt.data_ptr(), m, int(step), inv_step,
            *(st[k].data_ptr() for k in (
                "parent", "high", "max", "low", "frozen", "priority",
                "prog_id", "usage", "peak", "throttle_until", "prog",
                "mem_stall")),
            n, P, kinds, len(progs), *(t.data_ptr() for t in outs),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "parent enforcement_charge")

    return {"constants": constants, "checks": checks, "alloc": alloc,
            "call": call,
            "wrapper": lambda: mod.fused_charge_batch(st, dom, amt, step,
                                                      progs)}


def measure(mod, parts: dict, kernel: str, case: tuple, calls: int) -> dict:
    """One implementation at one shape (see the module docstring)."""
    st, dom, amt, step, progs = case
    dev = dom.device
    if kernel == "gate":
        fn = parts["wrapper"]
        got = fn()
        exact = torch.equal(got, C._plain_slot_gate(st, dom, step, progs))
    else:
        fn = parts["wrapper"]
        got, g, s = fn()
        want, wg, ws = C._plain_charge_batch(st, dom, amt, step, progs)
        exact = (same_tables(got, want) and torch.equal(g, wg)
                 and torch.equal(s, ws))
    dev_ms, launches = cold_device_ms(fn, f"{kernel}_kernel", calls, dev)
    host = {k: host_ms(f, calls) for k, f in parts.items()}
    return {"device_ms": dev_ms, "kernels_per_call": launches,
            "issue_ms": timing.cuda_ms(fn, calls), "host_ms": host,
            "bit_exact": bool(exact)}


def launch_floor(K, dev, calls: int) -> dict:
    """The empty kernel through the same ctypes path."""
    fn = lambda: K.empty_launch(dev)  # noqa: E731
    dev_ms, _ = cold_device_ms(fn, "empty_kernel", calls, dev)
    return {"device_ms": dev_ms, "issue_ms": timing.cuda_ms(fn, calls),
            "host_ms": host_ms(fn, calls)}


def load_parent(root: Path):
    """The enforcement wrapper module of the checkout at ``root`` and
    the library of its own ``csrc/enforcement.cu``, built with this
    checkout's flags into ``build/kernels/parent/``.  The wrapper loads
    its library through this checkout's ``_build``, so a caller puts
    the library in ``_build._loaded`` while it times that wrapper."""
    src = root / "src" / "repro_torch" / "kernels" / "enforcement.py"
    spec = importlib.util.spec_from_file_location("parent_enforcement", src)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = _build.BUILD_DIR / "parent" / "libenforcement.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd, _ = _build._command("enforcement")
    cmd[cmd.index("-o") + 1] = str(out)
    cmd[-1] = str(root / "src" / "repro_torch" / "csrc" / "enforcement.cu")
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc of the parent's kernel:\n{done.stdout}"
                           f"{done.stderr}")
    return mod, ctypes.CDLL(str(out))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of another checkout to time beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("enforcement_bench needs a CUDA card")
    from repro_torch.kernels import enforcement as K

    card = timing.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    impls = {"this": (K, _build.load("enforcement"))}
    if args.parent is not None:
        impls["parent"] = load_parent(args.parent)
    order = ["parent", "this", "this", "parent"] if args.parent else ["this"]
    try:
        for shape, spec in SHAPES.items():
            case = shape_case(shape, dev)
            st, dom = case[0], case[1]
            _build._loaded["enforcement"] = impls["this"][1]
            print(json.dumps({
                "shape": shape, "impl": "launch_floor", "card": card,
                **launch_floor(K, dev, spec["calls"])}), flush=True)
            bounds = {"charge": charge_bound(st, dom),
                      "gate": gate_bound(st, dom)}
            # the gate first: a refused parent charge leaves its error
            # in the parent library's own CUDA runtime (each library
            # links one statically), where its next launch check finds it
            for kernel in ("gate", "charge"):
                for turn, name in enumerate(order):
                    mod, lib = impls[name]
                    _build._loaded["enforcement"] = lib
                    line = {"shape": shape, "kernel": kernel, "impl": name,
                            "turn": turn, "card": card,
                            "n": st["usage"].shape[0], "m": dom.shape[0],
                            "P": st["prog"].shape[1],
                            "bound_ms": bounds[kernel][0],
                            "bound_by": bounds[kernel][1]}
                    make = parent_parts if name == "parent" else this_parts
                    try:
                        parts = make(mod, kernel, *case)
                        line.update(measure(mod, parts, kernel, case,
                                            spec["calls"]))
                    except RuntimeError as err:
                        # a design that stages the whole table refuses
                        # one past shared memory: record it, go on
                        line["refused"] = str(err).splitlines()[0]
                        torch.cuda.synchronize()
                    print(json.dumps(line), flush=True)
    finally:
        _build._loaded["enforcement"] = impls["this"][1]


if __name__ == "__main__":
    main()
