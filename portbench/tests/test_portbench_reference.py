"""The plain references against the program at reduced sizes on the CPU:
the float32 decoder and Jamba forward against the port's ``forward`` in
float32, the port in bfloat16 inside a limit that the float8 control
fails, and the numpy charge against the port's plain charge on random
tables."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench.harness import bench, checks, weights  # noqa: E402
from portbench.reference import charge as charge_ref  # noqa: E402
from portbench.reference import decoder, jamba  # noqa: E402
from portbench.tests import tiny  # noqa: E402

# limits between the bfloat16 program's readings and the float8
# control's at these sizes, seeds 5-10: dense 0.0044-0.0046 against
# 0.0468-0.0531, hybrid 0.0180-0.0203 against 0.1646-0.1897
TINY_REL_LIMIT = {"tiny-dense": 0.015, "tiny-hybrid": 0.06}


def _program():
    return bench.program()


def _setup(name: str, dtype: str, seed: int, seq: int):
    prog = _program()
    cfg = dict(tiny.TINY_CONFIGS[name], dtype=dtype)
    mcfg = bench.model_config(prog, cfg)
    params = weights.make_params(prog["model"].param_leaves(mcfg),
                                 cfg["init"], dtype, seed, torch.device("cpu"))
    g = np.random.default_rng(seed)
    tokens = torch.as_tensor(g.integers(0, cfg["vocab"], (1, seq)))
    perf = prog["perf"].PerfConfig(**cfg["perf"])
    with torch.inference_mode():
        logits, _ = prog["model"].forward(mcfg, params, {"tokens": tokens},
                                          perf=perf)
    ref = decoder if cfg["reference"] == "decoder" else jamba
    return cfg, params, tokens[0], logits[0], ref


@pytest.mark.parametrize("name,seq", [("tiny-dense", 48),
                                      ("tiny-hybrid", 64)])
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_reference_matches_the_program_in_float32(name, seq, seed):
    cfg, params, tokens, logits, ref = _setup(name, "float32", seed, seq)
    pos = torch.arange(seq)
    want = ref.logits_at(cfg, params, [tokens], [pos])[0]
    assert checks.rel_err([logits], [want]) < 2e-5


@pytest.mark.parametrize("name,seq", [("tiny-dense", 48),
                                      ("tiny-hybrid", 64)])
def test_lower_precision_fails(name, seq):
    """The program in the configurations' bfloat16 passes the limit; the
    reference with float8 weight products (the control) fails it."""
    for seed in (5, 6, 7):
        cfg, params, tokens, logits, ref = _setup(name, "bfloat16", seed,
                                                  seq)
        pos = torch.arange(seq)
        want = ref.logits_at(cfg, params, [tokens], [pos])[0]
        low = ref.logits_at(cfg, params, [tokens], [pos],
                            precision="float8")[0]
        prog_err = checks.rel_err([logits], [want])
        ctrl_err = checks.rel_err([low], [want])
        assert prog_err < TINY_REL_LIMIT[name] < ctrl_err, (prog_err,
                                                            ctrl_err)
        assert ctrl_err > 3 * prog_err


def _random_table(rng, n: int, step: int):
    """A random table over a tree of depth at most 4 (root, tenants,
    sessions, tool calls): frozen and throttled ancestors, hard limits,
    protections, saturated stall counters."""
    from repro_torch.core.progs import GraduatedThrottleProgram
    parent = np.full(n, -1, np.int32)
    depth = np.zeros(n, int)
    for i in range(1, n):
        cands = [j for j in range(i) if depth[j] < 3]
        p = int(rng.choice(cands))
        parent[i], depth[i] = p, depth[p] + 1
    I32 = charge_ref.INT32_MAX
    usage = rng.integers(0, 45, n).astype(np.int32)
    rows = np.tile(GraduatedThrottleProgram().default_row(), (n, 1))
    rows *= rng.uniform(0.5, 1.5, rows.shape).astype(np.float32)
    return {
        "parent": parent, "usage": usage,
        "high": np.where(rng.random(n) < 0.3, I32,
                         rng.integers(1, 40, n)).astype(np.int32),
        "max": np.where(rng.random(n) < 0.4, I32,
                        rng.integers(10, 80, n)).astype(np.int32),
        "low": np.where(rng.random(n) < 0.2, rng.integers(0, 30, n),
                        0).astype(np.int32),
        "priority": rng.integers(0, 3, n).astype(np.int32),
        "frozen": rng.random(n) < 0.1,
        "throttle_until": np.where(rng.random(n) < 0.2,
                                   step + rng.integers(-2, 4, n),
                                   0).astype(np.int32),
        "peak": (usage + rng.integers(0, 10, n)).astype(np.int32),
        "prog": rows.astype(np.float32),
        "prog_id": np.zeros(n, np.int32),
        "mem_stall": np.where(rng.random(n) < 0.2, I32,
                              rng.integers(0, 9, n)).astype(np.int32),
    }


@pytest.mark.parametrize("seed", range(8))
def test_charge_reference_matches_the_plain_charge(seed):
    from repro_torch.core.controller import _plain_charge_batch
    from repro_torch.core.progs import GraduatedThrottleProgram
    rng = np.random.default_rng(seed)
    step = int(rng.integers(0, 100))
    table = _random_table(rng, 40, step)
    dom = rng.choice(np.arange(-1, 40), 32).astype(np.int32)
    dom[rng.random(32) < 0.3] = dom[0]
    amt = rng.choice([0, 1, 1, 2, 5, 9, 40], 32).astype(np.int32)
    prog = GraduatedThrottleProgram(step_ms=10.0)
    st = {k: torch.from_numpy(v) for k, v in table.items()}
    new, granted, stalled = _plain_charge_batch(
        st, torch.from_numpy(dom), torch.from_numpy(amt), step, (prog,))
    want = charge_ref.charge(table, dom, amt, step, prog.step_ms)
    np.testing.assert_array_equal(want["granted"], granted.numpy())
    np.testing.assert_array_equal(want["stalled"], stalled.numpy())
    for k in ("usage", "peak", "throttle_until", "mem_stall", "prog"):
        np.testing.assert_array_equal(want[k], new[k].numpy())
