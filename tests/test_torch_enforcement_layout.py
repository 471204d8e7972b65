"""The redesigned fused charge's data flow, on the CPU, bit for bit.

``csrc/enforcement.cu::charge_kernel`` never stages the whole table: it
partitions the domains into the ones its slots touch (their ancestor
chains, domain 0 for a dead slot) and the rest, copies the rest in ->
out with ``peak = max(peak_in, usage_in)``, decides the slots in chunks
over a working set of the touched domains, and moves each peak only on
the charged chain, except that after slot 0 every domain off slot 0's
chain takes ``usage_in`` into its peak.  ``emulate_charge`` below is that
data flow in torch (the decision itself is the port's
``charge_decision``); it must agree with ``_plain_charge_batch``, which
takes ``max(peak, usage)`` over all n after every slot, at the bench's
``engine``, ``wide`` and ``beyond`` shapes, direct and chunked, with
negative amounts, m = 0, duplicate domains, an in-batch ancestor
throttle, peaks under usage and program ids out of range.  The plain
charge and gate are also held against the JAX reference's lax
``charge_batch`` at n = 1032 (the interpreted Pallas kernel stays at the
small size of ``test_torch_enforcement.py``), and the launch path's
pieces (the output carve, the registry constants, the checks) are
checked here; the kernel itself runs in ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import controller as JC
from repro.core import progs as JP
from repro.core import sched as JS
from repro_torch.core import controller as TC
from repro_torch.core import progs as TP
from repro_torch.core.pressure import charge_stall_event, saturating_count
from repro_torch.kernels import enforcement as K
from repro_torch.kernels import enforcement_bench as B

jax.config.update("jax_platform_name", "cpu")

KEYS = B.STATE_KEYS
DEPTH = TC.DEPTH


def chains_of(parent: list, dom: list) -> list:
    """The domains each slot touches: its self-first chain, or [0]."""
    out = []
    for d in dom:
        if d < 0:
            out.append([0])
            continue
        chain = [d]
        while len(chain) < DEPTH and parent[chain[-1]] >= 0:
            chain.append(parent[chain[-1]])
        out.append(chain)
    return out


def emulate_charge(state: dict, dom, amt, step: int, progs, chunk: int):
    """The kernel's partition and chunked walk, in torch."""
    parent = state["parent"].tolist()
    n, m = len(parent), dom.shape[0]
    d_list, a_list = dom.tolist(), amt.tolist()
    chains = chains_of(parent, d_list)
    touched = {x for c in chains for x in c}
    live0 = set(chains[0]) if m and d_list[0] >= 0 else set()
    out = {k: state[k].clone() for k in KEYS}
    rest = torch.tensor([i for i in range(n) if i not in touched],
                        dtype=torch.long)
    if m:                               # the copied remainder
        out["peak"][rest] = torch.maximum(state["peak"][rest],
                                          state["usage"][rest])
    chunked = m > chunk
    if chunked:                         # first pass: touched in -> out
        for x in touched:
            if x not in live0:
                out["peak"][x] = max(int(state["peak"][x]),
                                     int(state["usage"][x]))
    src = out if chunked else state
    step_t = torch.tensor(step, dtype=torch.int32)
    inv_step = TC.step_reciprocal(progs)
    granted = torch.zeros(m, dtype=torch.bool)
    stalled = torch.zeros(m, dtype=torch.bool)
    for c0 in range(0, m, chunk):
        zs = range(c0, min(m, c0 + chunk))
        keys = list(dict.fromkeys(x for z in zs for x in chains[z]))
        ent = {x: i for i, x in enumerate(keys)}
        idx = torch.tensor(keys, dtype=torch.long)
        usage, peak = src["usage"][idx].clone(), src["peak"][idx].clone()
        tu, stall = (src["throttle_until"][idx].clone(),
                     src["mem_stall"][idx].clone())
        owner = {}
        for z in zs:
            if d_list[z] >= 0:
                owner.setdefault(d_list[z], z)
        rows = {z: src["prog"][d_list[z]].clone() for z in owner.values()}
        if not chunked:                 # the rule, on the working set
            for x, i in ent.items():
                if x not in live0:
                    peak[i] = torch.maximum(peak[i], usage[i])
        for z in zs:
            d, a = d_list[z], a_list[z]
            if d < 0:
                i0 = ent[0]
                stall[i0] = saturating_count(stall[i0], 0)
                continue
            lv = [ent[x] for x in chains[z]]
            pad = DEPTH - len(lv)
            c = torch.tensor(chains[z] + [0] * pad, dtype=torch.long)
            valid = torch.tensor([True] * len(lv) + [False] * pad)
            li = torch.tensor(lv + [0] * pad, dtype=torch.long)
            zero = torch.zeros(DEPTH, dtype=torch.int32)
            unl = torch.full((DEPTH,), TC.UNLIMITED, dtype=torch.int32)
            row = rows[owner[d]]
            view = TP.ChainView(
                valid=valid,
                usage=torch.where(valid, usage[li], zero),
                high=torch.where(valid, state["high"][c], unl),
                max=torch.where(valid, state["max"][c], unl),
                low=torch.where(valid, state["low"][c], zero),
                frozen=valid & state["frozen"][c],
                throttle_until=torch.where(valid, tu[li], zero),
                priority=state["priority"][d], params=row,
                prog_id=state["prog_id"][d])
            req = TP.Request(torch.tensor(d, dtype=torch.int32),
                             torch.tensor(a, dtype=torch.int32), step_t)
            verdict, delay, throttle = TP.charge_decision(progs, view, req)
            grant, stl = bool(verdict.grant), bool(verdict.stall)
            for i in lv:                # scatter, once per appearance
                if grant:
                    usage[i] = usage[i] + a
            for i in lv:                # the charged chain's peak
                peak[i] = torch.maximum(peak[i], usage[i])
            i0 = lv[0]
            dly = torch.ceil(delay * inv_step).to(torch.int32)
            if bool(throttle):
                tu[i0] = torch.maximum(tu[i0], step_t + dly)
            rows[owner[d]] = verdict.params
            stall[i0] = saturating_count(
                stall[i0], charge_stall_event(verdict.stall, throttle))
            granted[z], stalled[z] = grant, stl
        for x, i in ent.items():        # write the working set back
            out["usage"][x], out["peak"][x] = usage[i], peak[i]
            out["throttle_until"][x], out["mem_stall"][x] = tu[i], stall[i]
        for x in keys:
            if x in owner:
                out["prog"][x] = rows[owner[x]]
            elif not chunked:
                out["prog"][x] = state["prog"][x]
    return dict(state, **out), granted, stalled


def assert_bit_identical(got: tuple, want: tuple) -> None:
    assert B.same_tables(got[0], want[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


OPTIONS = {
    "negative_dup": dict(negative=True, dup=True),
    "ancestor": dict(ancestor=True, peak_below=True),
    "oob": dict(prog_oob=True, negative=True, peak_below=True),
}


@pytest.mark.parametrize("chunk", [256, 3])
@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("kind", list(B.registries()))
def test_partition_engine_shape(kind, option, chunk):
    """The bench's engine shape (n 40, m 8), direct (one chunk) and in
    chunks of 3 slots (the last ragged)."""
    progs = B.registries()[kind]
    st, dom, amt, step = B.engine_case(8, progs, 7, "cpu",
                                       **OPTIONS[option])
    want = TC._plain_charge_batch(st, dom, amt, step, progs)
    assert_bit_identical(emulate_charge(st, dom, amt, step, progs, chunk),
                         want)
    if option == "ancestor":   # slot 0's throttle denies slot 1
        assert bool(want[1][0]) and not bool(want[1][1])
        assert bool(want[2][1])


@pytest.mark.parametrize("kind", list(B.registries()))
def test_partition_empty_batch(kind):
    """m = 0: nothing is touched, every peak stays as it came."""
    progs = B.registries()[kind]
    st, dom, amt, step = B.engine_case(8, progs, 3, "cpu", peak_below=True)
    dom, amt = dom[:0], amt[:0]
    got = emulate_charge(st, dom, amt, step, progs, 256)
    assert_bit_identical(got, TC._plain_charge_batch(st, dom, amt, step,
                                                     progs))
    assert torch.equal(got[0]["peak"], st["peak"])


def test_partition_slot0_rule_needs_the_exception():
    """A negative first amount on a domain whose peak is under its
    usage: its peak ends under usage_in, so taking usage_in into it (the
    rule without its exception for slot 0's chain) would differ."""
    progs = B.registries()["graduated"]
    st, dom, amt, step = B.engine_case(8, progs, 0, "cpu")
    d = int(dom[dom >= 0][0])
    dom[:] = -1
    dom[0], amt[0] = d, -3
    st["peak"][d] = st["usage"][d] - 5
    st["frozen"][:] = False
    st["throttle_until"][:] = 0
    st["max"][:] = TC.UNLIMITED
    want = TC._plain_charge_batch(st, dom, amt, step, progs)
    assert bool(want[1][0])
    assert int(want[0]["peak"][d]) < int(st["usage"][d])
    assert_bit_identical(emulate_charge(st, dom, amt, step, progs, 256),
                         want)


@pytest.mark.parametrize("chunk", [256, 64])
def test_partition_wide_shape(chunk):
    """n 1,032, m 256, the mixed registry: one chunk, and four."""
    progs = B.registries()["mixed"]
    st, dom, amt, step = B.engine_case(256, progs, 11, "cpu", negative=True,
                                       dup=True, peak_below=True)
    assert_bit_identical(emulate_charge(st, dom, amt, step, progs, chunk),
                         TC._plain_charge_batch(st, dom, amt, step, progs))


def test_partition_beyond_shape():
    """n 4,104, m 1,024 in four chunks of 256: past what a kernel that
    staged the whole table could hold in shared memory."""
    progs = B.registries()["token_bucket"]
    st, dom, amt, step = B.engine_case(1024, progs, 5, "cpu", negative=True,
                                       dup=True, peak_below=True,
                                       prog_oob=True)
    assert_bit_identical(emulate_charge(st, dom, amt, step, progs, 256),
                         TC._plain_charge_batch(st, dom, amt, step, progs))


# ------------------------------------------------ the JAX reference, wide


def jax_registry(kind):
    grad = JP.GraduatedThrottleProgram(step_ms=10.0, overage_gain=7.5)
    tb = JP.TokenBucketProgram(step_ms=10.0, bucket_capacity=6.0,
                               refill=(0.7, 1.3, 2.9))
    wf = JS.WeightedFairProgram(step_ms=10.0)
    base = JP.PolicyProgram()
    base.step_ms = 10.0
    return {"graduated": (grad,), "token_bucket": (tb,),
            "weighted_fair": (wf,), "mixed": (grad, tb, wf, base)}[kind]


@pytest.mark.parametrize("kind", ["mixed", "token_bucket"])
def test_plain_matches_jax_reference_at_n_1032(kind):
    """The port's plain charge and gate against the reference's lax
    ``charge_batch`` and ``slot_gate`` at the wide shape (n 1,032)."""
    progs = B.registries()[kind]
    st, dom, amt, step = B.engine_case(256, progs, 13, "cpu", negative=True,
                                       dup=True, peak_below=True,
                                       prog_oob=True)
    jst = {k: jnp.asarray(v.numpy()) for k, v in st.items()}
    jprogs = jax_registry(kind)
    want, wg, ws = jax.jit(JC._lax_charge_batch, static_argnums=(4,))(
        jst, jnp.asarray(dom.numpy()), jnp.asarray(amt.numpy()), step,
        jprogs)
    got, tg, ts = TC._plain_charge_batch(st, dom, amt, step, progs)
    for k in KEYS:
        w = np.asarray(want[k])
        g = got[k].numpy()
        if w.dtype == np.float32:
            w, g = w.view(np.int32), g.view(np.int32)
        assert np.array_equal(w, g), k
    assert np.array_equal(np.asarray(wg), tg.numpy())
    assert np.array_equal(np.asarray(ws), ts.numpy())
    jgot = {k: jnp.asarray(v.numpy()) for k, v in got.items()}
    gate_j = JC._lax_slot_gate(jgot, jnp.asarray(dom.numpy()), step + 1,
                               jprogs)
    gate_t = TC._plain_slot_gate(got, dom, step + 1, progs)
    assert np.array_equal(np.asarray(gate_j), gate_t.numpy())


# ------------------------------------------------------ the launch path


@pytest.mark.parametrize("m,n,P", [(8, 40, 4), (0, 40, 4), (3, 7, 10),
                                   (1024, 4104, 10)])
def test_charge_outputs_carve_the_kernels_layout(m, n, P):
    """One allocation; views at the offsets ``enforcement_charge``
    computes: usage, peak, tu, stall (n words each), prog (n P), the
    granted and stalled bytes, then room for m 16-byte chain records
    from the next 16-byte boundary."""
    buf, usage, peak, tu, stall, prog, granted, stalled = \
        K.charge_outputs(m, n, P, "cpu")
    base = buf.data_ptr()
    for t, w in zip((usage, peak, tu, stall, prog),
                    (0, n, 2 * n, 3 * n, 4 * n)):
        assert t.data_ptr() == base + 4 * w and t.is_contiguous()
    flags = base + 4 * (4 * n + n * P)
    if m:    # (an empty view's data_ptr is 0)
        assert granted.data_ptr() == flags
        assert stalled.data_ptr() == flags + m
    scratch = (flags + 2 * m + 15) // 16 * 16
    assert scratch + 16 * m <= base + buf.numel() * 4
    assert granted.dtype == stalled.dtype == torch.bool
    assert granted.shape == stalled.shape == (m,)
    assert prog.dtype == torch.float32 and prog.shape == (n, P)
    for t in (usage, peak, tu, stall):
        assert t.dtype == torch.int32 and t.shape == (n,)


def test_registry_constants_match_the_plain_arithmetic():
    for kind, progs in B.registries().items():
        kinds, n_kinds, inv_step, stock_gate = K.registry_constants(progs)
        codes = K.kind_codes(progs)
        assert n_kinds == len(codes) and stock_gate
        assert [(kinds >> (4 * i)) & 0xF for i in range(n_kinds)] == codes
        assert np.float32(inv_step) == TC.step_reciprocal(progs).numpy()
        assert K.registry_constants(progs) is K.registry_constants(progs)
    other = (TP.GraduatedThrottleProgram(step_ms=7.0),)
    assert np.float32(K.registry_constants(other)[2]) == np.float32(
        np.float32(1.0) / np.float32(7.0))

    class Custom(TP.GraduatedThrottleProgram):
        pass

    for _ in range(2):   # raises every call, nothing cached
        with pytest.raises(NotImplementedError, match="Custom"):
            K.registry_constants((Custom(),))


def test_checks_name_what_the_kernel_does_not_take():
    progs = B.registries()["graduated"]
    st, dom, amt, _ = B.engine_case(8, progs, 0, "cpu")
    assert K.charge_checks(st, dom, amt) == (8, 40, 4)
    assert K.gate_checks(st, dom) == (8, 40)
    with pytest.raises(ValueError, match="amt"):
        K.charge_checks(st, dom, amt.long())
    with pytest.raises(ValueError, match="peak"):
        K.charge_checks(dict(st, peak=st["peak"][:-1]), dom, amt)
    with pytest.raises(ValueError, match="prog"):
        K.charge_checks(dict(st, prog=st["prog"].t().contiguous().t()),
                        dom, amt)
    with pytest.raises(ValueError, match="frozen"):
        K.gate_checks(dict(st, frozen=st["frozen"].int()), dom)
    with pytest.raises(ValueError, match="width"):
        K.charge_checks(dict(st, prog=torch.zeros(40, 17)), dom, amt)
