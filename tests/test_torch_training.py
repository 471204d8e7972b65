"""The port's training path against the JAX package on the CPU: data,
schedules, one AdamW step, three train steps of the reduced f32
``llama3.2-3b`` (two layers) on the same weights, microbatching, int8
gradient compression, the checkpoint format and crash-and-restart
through the port's own launcher."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import SHAPES, get_config, reduced
from repro.data.pipeline import make_batch as j_make_batch
from repro.models import model as JM
from repro.models.schema import init_params as j_init_params
from repro.perf import DEFAULT_PERF, replace as j_perf
from repro.training import compression as JCmp
from repro.training import optimizer as JO
from repro.training.train_step import init_train_state as j_init_state
from repro.training.train_step import make_train_step as j_make_step
from repro_torch.checkpoint import ckpt as TCk
from repro_torch.configs import SHAPES as T_SHAPES
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.data.pipeline import DataIterator, make_batch
from repro_torch.models import model as TM
from repro_torch.perf import DEFAULT_PERF as T_PERF
from repro_torch.perf import replace as t_perf
from repro_torch.training import compression as TCmp
from repro_torch.training import optimizer as TO
from repro_torch.training.train_step import init_train_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]
B, SEQ, LAYERS = 2, 64, 2


def configs():
    j = dataclasses.replace(reduced(get_config("llama3.2-3b")),
                            dtype="float32", n_layers=LAYERS)
    t = dataclasses.replace(t_reduced(t_get_config("llama3.2-3b")),
                            dtype="float32", n_layers=LAYERS)
    return j, t


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = configs()
    jparams = j_init_params(JM.param_schema(jcfg), jax.random.PRNGKey(0),
                            jcfg.dtype)
    return jcfg, tcfg, jparams


def torch_params(jparams, tcfg):
    return TM.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")


def batch_of(cfg, step, batch=B):
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=SEQ,
                                global_batch=batch)
    return j_make_batch(cfg, shape, seed=0, step=step)


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1)])
def test_make_batch_identical(seed, step):
    jcfg, tcfg = configs()
    want = j_make_batch(jcfg, SHAPES["train_4k"], seed=seed, step=step,
                        batch=3, seq=96)
    got = make_batch(tcfg, T_SHAPES["train_4k"], seed=seed, step=step,
                     batch=3, seq=96)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k]), k
    it = DataIterator(tcfg, T_SHAPES["train_4k"], seed=seed, batch=3, seq=96,
                      device="cpu")
    assert torch.equal(it.at(step)["tokens"], torch.from_numpy(want["tokens"]))


@pytest.mark.parametrize("schedule", ["cosine", "wsd"])
def test_schedules_match(schedule):
    kw = dict(lr=1.0, warmup_steps=10, total_steps=100, schedule=schedule)
    js, ts = JO.make_schedule(JO.OptConfig(**kw)), TO.make_schedule(
        TO.OptConfig(**kw))
    steps = list(range(0, 111, 3)) + [10, 11, 80, 100]
    want = np.array([float(js(s)) for s in steps], np.float32)
    got = np.array([float(ts(s)) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_step_matches(dtype):
    rng = np.random.default_rng(1)
    shapes = {"a": (5, 7), "b": (33,), "c": (2, 3, 4)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    g = {k: rng.standard_normal(s).astype(np.float32) * 0.3
         for k, s in shapes.items()}
    cfg = dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    jp = {k: jnp.asarray(v).astype(dtype) for k, v in p.items()}
    jg = {k: jnp.asarray(v).astype(dtype) for k, v in g.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, dtype)) for k, v in p.items()}
    tg = {k: torch.from_numpy(v).to(getattr(torch, dtype)) for k, v in g.items()}
    jst, tst = JO.init_opt_state(jp), TO.init_opt_state(tp)
    for lr in (1e-2, 5e-3):
        jp, jst, jn = JO.adamw_update(jg, jst, jp, jnp.float32(lr),
                                      JO.OptConfig(**cfg))
        tp, tst, tn = TO.adamw_update(tg, tst, tp, torch.tensor(lr),
                                      TO.OptConfig(**cfg))
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert int(tst["count"]) == int(jst["count"]) == 2
    tol = 1e-6 if dtype == "float32" else 1e-2
    for k in shapes:
        np.testing.assert_allclose(tp[k].float().numpy(),
                                   np.asarray(jp[k], np.float32), atol=tol)
        np.testing.assert_allclose(tst["m"][k].numpy(), np.asarray(jst["m"][k]),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(tst["v"][k].numpy(), np.asarray(jst["v"][k]),
                                   rtol=1e-6, atol=1e-12)


def run_both(pair, perf_kw, steps=3, batch=B, opt_kw=None):
    """``steps`` train steps of both packages from the same weights and
    batches: (jax losses, torch losses, jax gnorms, torch gnorms, jax
    params, torch params, jax opt, torch opt)."""
    jcfg, tcfg, jparams = pair
    opt_kw = opt_kw or dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jperf = j_perf(DEFAULT_PERF, remat="none", **perf_kw)
    tperf = t_perf(T_PERF, remat="none", **perf_kw)
    jstep = jax.jit(j_make_step(jcfg, jperf, JO.OptConfig(**opt_kw)))
    tstep = make_train_step(tcfg, tperf, TO.OptConfig(**opt_kw))
    jp, tp = jparams, torch_params(jparams, tcfg)
    jo, to = j_init_state(jcfg, jp, jperf), init_train_state(tcfg, tp, tperf)
    out = {"jl": [], "tl": [], "jn": [], "tn": []}
    for s in range(steps):
        b = batch_of(jcfg, s, batch)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()},
                           s)
        tp, to, tm = tstep(tp, to, {k: torch.from_numpy(v)
                                    for k, v in b.items()}, s)
        out["jl"].append(float(jm["loss"]))
        out["tl"].append(float(tm["loss"]))
        out["jn"].append(float(jm["grad_norm"]))
        out["tn"].append(float(tm["grad_norm"]))
    return out, (jp, tp, jo, to)


def test_three_train_steps_match(pair):
    """Losses and grad norms within 1e-5 relative; parameters within
    atol 2e-6 after three AdamW steps at lr 1e-3 (the two packages sum
    the products in different orders, so each update may differ by a
    few ulp of the lr-sized step)."""
    out, (jp, tp, jo, to) = run_both(pair, {})
    np.testing.assert_allclose(out["tl"], out["jl"], rtol=1e-5)
    np.testing.assert_allclose(out["tn"], out["jn"], rtol=1e-5)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        node = tp
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_allclose(node.detach().numpy(), np.asarray(leaf),
                                   atol=2e-6, err_msg=str(path))
    assert int(to["count"]) == 3


def test_microbatch_grads(pair):
    """Two microbatches: the port's accumulated gradient (read back from
    the first moment at lr 0) equals the JAX package's, and tracks the
    full-batch gradient within the reference test's tolerance (each
    microbatch normalizes by its own weight sum)."""
    jcfg, tcfg, jparams = pair
    opt_kw = dict(lr=0.0, weight_decay=0.0, grad_clip=1e9)
    out, (jp, tp, jo, to) = run_both(pair, {"microbatches": 2}, steps=1,
                                     batch=4, opt_kw=opt_kw)
    np.testing.assert_allclose(out["tl"], out["jl"], rtol=1e-5)
    tparams = torch_params(jparams, tcfg)
    b = {k: torch.from_numpy(v) for k, v in batch_of(jcfg, 0, 4).items()}
    leaves = TO.tree_leaves(tparams)
    for p_ in leaves:
        p_.requires_grad_(True)
    full = torch.autograd.grad(
        TM.loss_fn(tcfg, tparams, b, perf=t_perf(T_PERF, remat="none"))[0],
        leaves)
    for g_full, m, jm in zip(full, TO.tree_leaves(to["m"]),
                             jax.tree.leaves(jo["m"])):
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-4,
                                   atol=1e-7)
        np.testing.assert_allclose(m.numpy() / 0.1, g_full.numpy(),
                                   atol=5e-3, rtol=5e-2)


def test_grad_compress(pair):
    """int8 quantization with error feedback: bit-identical to the JAX
    package's per leaf, the same three steps as JAX with compression on,
    and 25 compressed steps track f32 training (the reference test's
    bound)."""
    rng = np.random.default_rng(9)
    g = rng.standard_normal(300).astype(np.float32) * 1e-3
    e = rng.standard_normal(300).astype(np.float32) * 1e-5
    jh, je = JCmp.quantize_leaf(jnp.asarray(g), jnp.asarray(e))
    th, te = TCmp.quantize_leaf(torch.from_numpy(g), torch.from_numpy(e))
    assert np.array_equal(th.numpy(), np.asarray(jh))
    assert np.array_equal(te.numpy(), np.asarray(je))
    out, _ = run_both(pair, {"grad_compress": True})
    np.testing.assert_allclose(out["tl"], out["jl"], rtol=1e-5)
    jcfg, tcfg, jparams = pair
    losses = {}
    for compress in (False, True):
        perf = t_perf(T_PERF, remat="none", grad_compress=compress)
        step = make_train_step(tcfg, perf, TO.OptConfig(
            lr=1e-3, warmup_steps=3, total_steps=25))
        params = torch_params(jparams, tcfg)
        opt = init_train_state(tcfg, params, perf)
        for s in range(25):
            b = {k: torch.from_numpy(v) for k, v in
                 batch_of(jcfg, s, 4).items()}
            params, opt, m = step(params, opt, b, s)
        losses[compress] = float(m["loss"])
    assert abs(losses[True] - losses[False]) < 0.35


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] = self.n.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_give_the_same_gradients(pair):
    """``full`` recomputes the groups' matrix products in the backward,
    ``dots`` keeps them and recomputes only the rest (the norms); both
    give the gradients of no remat, bit for bit."""
    jcfg, tcfg, jparams = pair
    b = {k: torch.from_numpy(v) for k, v in batch_of(jcfg, 0).items()}
    grads, ops = {}, {}
    for remat in ("none", "full", "dots"):
        params = torch_params(jparams, tcfg)
        leaves = TO.tree_leaves(params)
        for p_ in leaves:
            p_.requires_grad_(True)
        loss = TM.loss_fn(tcfg, params, b, perf=t_perf(T_PERF, remat=remat))[0]
        with _CountOps() as count:
            grads[remat] = torch.autograd.grad(loss, leaves)
        ops[remat] = count.n
    mm, rsqrt = torch.ops.aten.mm.default, torch.ops.aten.rsqrt.default
    assert ops["dots"][mm] == ops["none"][mm] < ops["full"][mm]
    assert ops["dots"].get(rsqrt, 0) == ops["full"][rsqrt] == 2 * LAYERS
    for remat in ("full", "dots"):
        for a, c in zip(grads["none"], grads[remat]):
            assert torch.equal(a, c)


def test_checkpoint_roundtrip_bf16(tmp_path):
    tree = {"a": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)},
            "b": [torch.randn(5).to(torch.bfloat16),
                  torch.tensor(7, dtype=torch.int32)]}
    TCk.save(str(tmp_path / "c.npz"), 4, tree)
    with np.load(tmp_path / "c.npz") as z:
        assert z["b/0"].dtype == np.uint16      # raw bf16 patterns
        assert json.loads(str(z["__manifest__"]))["b/0"] == "bfloat16"
    step, back = TCk.load(str(tmp_path / "c.npz"), tree)
    assert step == 4
    for a, c in zip(TO.tree_leaves(tree), TO.tree_leaves(back)):
        assert a.dtype == c.dtype and torch.equal(a, c)


def test_async_writer_copies_before_returning(tmp_path):
    """``AsyncWriter.save`` snapshots the tensors before it returns: the
    next step's in-place update of a CPU tensor must not reach the file
    the thread is still writing."""
    tree = {"p": torch.arange(4096, dtype=torch.float32),
            "m": [torch.ones(4096).to(torch.bfloat16)]}
    want = {"p": tree["p"].clone(), "m": [tree["m"][0].clone()]}
    writer = TCk.AsyncWriter()
    writer.save(str(tmp_path / "a.npz"), 3, tree)
    tree["p"].add_(1.0)
    tree["m"][0].mul_(3.0)
    writer.wait()
    step, back = TCk.load(str(tmp_path / "a.npz"), tree)
    assert step == 3
    for a, c in zip(TO.tree_leaves(want), TO.tree_leaves(back)):
        assert torch.equal(a, c)


def _driver(ckpt_dir, extra):
    # one thread: the runs compare bit for bit, whatever the host's cores
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
           "--device", "cpu", "--steps", "12", "--batch", "2", "--seq", "32",
           "--ckpt-every", "5", "--ckpt-dir", str(ckpt_dir),
           "--log-every", "100"] + extra
    return subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """An uninterrupted run with synchronous checkpoints: (its report,
    its checkpoint directory)."""
    ck = tmp_path_factory.mktemp("ref")
    r = _driver(ck, ["--sync-ckpt"])
    assert r.returncode == 0, r.stderr[-1500:]
    return json.loads(r.stdout.strip().splitlines()[-1]), ck


@pytest.mark.parametrize("writes", ["sync", "async"])
def test_crash_and_restart_bit_exact(tmp_path, uninterrupted, writes):
    """Kill the port's driver mid-run; the restart resumes from the last
    checkpoint and ends bit-identical (losses and every saved leaf) to an
    uninterrupted run, with synchronous and with asynchronous
    checkpoint writes (the default)."""
    extra = ["--sync-ckpt"] if writes == "sync" else []
    r1 = _driver(tmp_path / "ck", extra + ["--crash-at", "7"])
    assert r1.returncode == 42, r1.stderr[-1500:]
    r2 = _driver(tmp_path / "ck", extra)
    assert r2.returncode == 0, r2.stderr[-1500:]
    rep2 = json.loads(r2.stdout.strip().splitlines()[-1])
    assert rep2["resumed_from"] == 5
    rep3, ref = uninterrupted
    assert rep2["losses"] == rep3["losses"][6:]
    with np.load(tmp_path / "ck" / "ckpt_00000011.npz") as a, \
            np.load(ref / "ckpt_00000011.npz") as c:
        assert sorted(a.files) == sorted(c.files)
        for k in a.files:
            assert np.array_equal(a[k], c[k]), k


def test_entry_points_need_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, tcfg = configs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_params(tcfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.decode_state(tcfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.params_from_jax({}, tcfg)
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run(train.parse_args(["--reduced", "--steps", "1"]))
