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
``bound_ms``    the bytes bound (``enforcement.charge_cost`` and
                ``gate_cost`` at this data, ``timing.cost_bound_ms``):
                the slots, the static columns of the domains they touch,
                and every domain's mutable row read once and written
                once;
``bit_exact``   the outputs against the plain version on the same
                inputs.

One more line per shape gives the launch floor: the device time, issue
pace and host time of ``csrc/enforcement.cu``'s empty kernel launched
through the same ctypes path.

The sharded backend's in-step shapes, ``SHARD_SHAPES``, stack S such
tables on a leading axis and spread m slots over them (one launch for
all shards; ``shard_case``):

=======  ==  =====  ===  ===========================================
shape    S   n      m    slots
=======  ==  =====  ===  ===========================================
groups   8   513    64   slot j on shard 8 j / 64: 8 device groups of
                         one node, 4,104 domains in all
spread   8   1,032  256  each slot on a shard from a seeded generator
=======  ==  =====  ===  ===========================================

For each kernel and shard shape, one line with ``device_ms`` (a
launch's, over the launches the profiler saw), ``issue_ms``,
``bound_ms`` and ``bit_exact`` (against the plain per-shard loop) as
above, and ``as_shard_launches_ms``: the device time of the same work as
S launches at S = 1, one a shard's slice.

With ``--parent DIR`` the enforcement wrapper and
``csrc/enforcement.cu`` of another checkout at DIR (one whose wrapper
has the same pieces, ``wrapper_parts``; e.g. ``git archive <commit> |
tar -x -C build/parent``) are built and timed at the three table shapes
in the same process, in turns (parent, this, this, parent); its host
parts are timed on the same pieces of its own code.  Where the parent
refuses a shape, its line records the error and the run goes on.
Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import inspect
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
from repro_torch.kernels import enforcement as E

TENANTS = 7
SHAPES = {
    "engine": dict(slots=8, registry="graduated", calls=200),
    "wide": dict(slots=256, registry="mixed", calls=100),
    "beyond": dict(slots=1024, registry="mixed", calls=40),
}
# the sharded backend's in-step shapes (module docstring)
SHARD_SHAPES = {
    "groups": dict(shards=8, n=513, slots=64, spread="even",
                   registry="mixed", calls=100),
    "spread": dict(shards=8, n=1032, slots=256, spread="seeded",
                   registry="mixed", calls=60),
}
FLUSH_BYTES = 64 << 20
INT32_MAX = 2**31 - 1
STATE_KEYS = C.CHARGED_KEYS


def registries() -> dict:
    """Every stock program alone, and all of them in one registry."""
    grad = GraduatedThrottleProgram(step_ms=10.0, overage_gain=7.5)
    tb = TokenBucketProgram(step_ms=10.0, bucket_capacity=6.0,
                            refill=(0.7, 1.3, 2.9))
    wf = WeightedFairProgram(step_ms=10.0)
    return {"graduated": (grad,), "token_bucket": (tb,),
            "weighted_fair": (wf,),
            "mixed": (grad, tb, wf, PolicyProgram())}


def engine_case(slots: int, progs, seed: int, device, *, n=None,
                negative=False, dup=False, ancestor=False, peak_below=False,
                prog_oob=False) -> tuple:
    """``(state, dom, amt, step)`` of one charge over an engine-shaped
    table of ``4 slots + 8`` domains (module docstring; ``n`` domains
    when given, at least ``2 slots + 8``, the rest free), from a seeded
    generator.  Options for the checks: ``negative`` amounts on a
    quarter of the slots; ``dup`` slots that charge slot 0's domain
    again; ``ancestor``: slot 0 charges a tenant over its
    ``memory.high`` whose session slot 1 charges, so slot 0's throttle
    denies slot 1 in the same batch; ``peak_below``: peaks under usage;
    ``prog_oob``: program ids outside the registry."""
    rng = np.random.default_rng(seed)
    n, m = (4 * slots + 8 if n is None else n), slots
    if n < 2 * slots + 8:
        raise ValueError(f"{n} domains hold no {slots} sessions and tools")
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


def shard_case(shape: str, device, seed: int = 0) -> tuple:
    """``(state, dom, amt, step, progs)`` of one in-step charge over a
    shard shape: S engine-shaped tables of n domains (``engine_case``,
    one seed a shard) stacked into ``(S, n)`` columns, the ``(S, m)``
    matrix of shard-local slots (-1 off the slot's shard) and the shared
    ``(m,)`` amounts.  ``even`` puts slot j on shard ``j S / m``,
    ``seeded`` on a shard drawn by a seeded generator; a slot charges
    one of its shard's sessions or tool calls (a tenth dead)."""
    spec = SHARD_SHAPES[shape]
    S, n, m = spec["shards"], spec["n"], spec["slots"]
    progs = registries()[spec["registry"]]
    per = (n - 8) // 4
    cases = [engine_case(per, progs, seed * 1000 + s, device, n=n)
             for s in range(S)]
    rng = np.random.default_rng([seed, S, n, m])
    owner = (np.arange(m) * S // m if spec["spread"] == "even"
             else rng.integers(0, S, m))
    dom = np.full((S, m), -1, np.int32)
    for j, s in enumerate(owner):
        dom[s, j] = int(cases[s][1][j % per])
    amt = rng.choice([0, 1, 1, 2, 3, 5, 40], m).astype(np.int32)
    state = {k: torch.stack([c[0][k] for c in cases]) for k in cases[0][0]}
    to = dict(dtype=torch.int32, device=device)
    return (state, torch.as_tensor(dom, **to), torch.as_tensor(amt, **to),
            cases[0][3], progs)


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


def _shards(state: dict, dom) -> list:
    """``[(parent, dom)]`` a shard, as numpy (one pair without the
    shard axis)."""
    parent = state["parent"].cpu().numpy()
    d = dom.cpu().numpy()
    if d.ndim == 1:
        return [(parent, d)]
    return list(zip(parent, d))


def walks(state: dict, dom) -> list:
    """Each shard's (domains touched, chain levels walked) by its slots,
    read from the table: what ``E.charge_cost`` and ``E.gate_cost`` count
    for this run's data.  A dead slot touches the root."""
    out = []
    for parent, d in _shards(state, dom):
        chains = _chains(parent, d)
        touched = {x for c in chains for x in c} | ({0} if (d < 0).any()
                                                     else set())
        out.append((len(touched), sum(map(len, chains))))
    return out


def charge_bound(state: dict, dom) -> tuple:
    """``timing.cost_bound_ms`` of ``E.charge_cost`` at this data."""
    return timing.cost_bound_ms(E.charge_cost(state, dom, walks(state, dom)))


def gate_bound(state: dict, dom) -> tuple:
    """``timing.cost_bound_ms`` of ``E.gate_cost`` at this data."""
    return timing.cost_bound_ms(E.gate_cost(state, dom, walks(state, dom)))


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
    # the profiler now and then returns no event at all for these short
    # ctypes launches after many sessions in one process: a session that
    # saw none is repeated, at most three times
    for _ in range(3):
        try:
            seen = timing.device_ms(call, calls)
        except AssertionError:
            seen = {}
        hits = [v for k, v in seen.items() if kernel in k]
        if hits:
            return sum(ms for ms, _ in hits), sum(c for _, c in hits)
    raise AssertionError(f"the profiler saw no {kernel}: {list(seen)}")


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


def wrapper_parts(K, kernel: str, st, dom, amt, step, progs) -> dict:
    """A checkout's wrapper module ``K`` (this one's, or a parent's with
    the same pieces: registry constants, checks, output carve, ctypes
    call), piece by piece.  A parent without the shard axis has a gate
    call that takes no table width."""
    dev = dom.device
    consts = K.registry_constants(progs)
    if kernel == "gate":
        m, n = K.gate_checks(st, dom)
        out = torch.empty(m, dtype=torch.bool, device=dev)
        width = ((n,) if "n" in inspect.signature(K.gate_call).parameters
                 else ())
        return {
            "constants": lambda: K.registry_constants(progs),
            "checks": lambda: K.gate_checks(st, dom),
            "alloc": lambda: torch.empty(m, dtype=torch.bool, device=dev),
            "call": lambda: K.gate_call(st, dom, step, m, out, *width),
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


def measure_shards(K, kernel: str, case: tuple, calls: int) -> dict:
    """One shard shape (module docstring): the one launch over every
    shard against the plain per-shard loop, its cold device time and
    issue pace, and the same work as S launches at S = 1."""
    st, dom, amt, step, progs = case
    dev = dom.device
    slices = [({k: v[s] for k, v in st.items()}, dom[s])
              for s in range(dom.shape[0])]
    if kernel == "gate":
        def fn():
            return K.fused_slot_gate(st, dom, step, progs)

        def per_shard():
            for sub, d in slices:
                K.fused_slot_gate(sub, d, step, progs)

        exact = torch.equal(fn(), C._plain_gate_shards(st, dom, step, progs))
    else:
        def fn():
            return K.fused_charge_batch(st, dom, amt, step, progs)

        def per_shard():
            for sub, d in slices:
                K.fused_charge_batch(sub, d, amt, step, progs)

        got, g, s = fn()
        want, wg, ws = C._plain_charge_shards(st, dom, amt, step, progs)
        exact = (same_tables(got, want) and torch.equal(g, wg)
                 and torch.equal(s, ws))
    # the profiler drops some events of these short ctypes launches (it
    # saw 0.92 of them a call in a run of this bench); a launch's time
    # is the total over the launches it saw, and the loop's is S times
    # that mean
    dev_ms, seen = cold_device_ms(fn, f"{kernel}_kernel", calls, dev)
    loop_ms, loop_seen = cold_device_ms(per_shard, f"{kernel}_kernel",
                                        calls, dev)
    return {"device_ms": dev_ms / seen, "profiled_per_call": seen,
            "issue_ms": timing.cuda_ms(fn, calls),
            "as_shard_launches_ms": loop_ms / loop_seen * len(slices),
            "as_shard_launches_profiled_per_call": loop_seen,
            "as_shard_launches_issue_ms": timing.cuda_ms(per_shard, calls),
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
                    try:
                        parts = wrapper_parts(mod, kernel, *case)
                        line.update(measure(mod, parts, kernel, case,
                                            spec["calls"]))
                    except RuntimeError as err:
                        # a design that stages the whole table refuses
                        # one past shared memory: record it, go on
                        line["refused"] = str(err).splitlines()[0]
                        torch.cuda.synchronize()
                    print(json.dumps(line), flush=True)
        # the shard axis: this checkout's kernels only (a parent may
        # have none)
        _build._loaded["enforcement"] = impls["this"][1]
        for shape, spec in SHARD_SHAPES.items():
            case = shard_case(shape, dev)
            st, dom = case[0], case[1]
            bounds = {"charge": charge_bound(st, dom),
                      "gate": gate_bound(st, dom)}
            for kernel in ("gate", "charge"):
                print(json.dumps({
                    "shape": shape, "kernel": kernel, "impl": "this",
                    "card": card, "S": dom.shape[0],
                    "n": st["usage"].shape[1], "m": dom.shape[1],
                    "P": st["prog"].shape[2],
                    "bound_ms": bounds[kernel][0],
                    "bound_by": bounds[kernel][1],
                    **measure_shards(K, kernel, case, spec["calls"])}),
                    flush=True)
    finally:
        _build._loaded["enforcement"] = impls["this"][1]


if __name__ == "__main__":
    main()
