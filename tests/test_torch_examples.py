"""The port's example twins (``repro_torch.examples``) against their
sources in ``examples/`` on the CPU, from the same weights (the
reference's ``init_params`` carried across with ``params_from_jax``) and
the same batches:

  serve_agents  at the source's defaults (5 sessions, pool 20, seed 0):
                the printed table identical, each mode's row the one
                below;
  quickstart    §1, §1b and §1c identical text, every §2 loss within
                1e-4 relative of the reference's own train step at the
                example's settings, §3's report identical;
  train_100m    at d 128, 2 layers, batch 2, seq 32, 6 steps, with and
                without ``--grad-compress``: the parameter-count line
                identical, each step's loss and lr within 1e-4 relative,
                checkpoints every 2 steps (the source's every 100 never
                fires in 6) kept at the same steps as the reference's
                manager keeps, each restoring bit for bit through
                ``ckpt.load`` to a copy of the tree taken at its step.
"""
import contextlib
import dataclasses
import importlib.util
import io
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch.utils._pytree import tree_flatten_with_path, tree_map

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.models import model as JM
from repro.models.schema import init_params as j_init_params
from repro.training.train_step import init_train_state as j_init_state
from repro_torch.checkpoint import ckpt as TCk
from repro_torch.checkpoint.manager import CheckpointManager as TManager
from repro_torch.examples import quickstart as QS
from repro_torch.examples import serve_agents as SA
from repro_torch.examples import train_100m as T100
from repro_torch.models import model as TM

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-4

# the source's output at its defaults: done, evict, overshoot, throttles,
# freezes, feedbacks, steps
SERVE_ROWS = {"nolimit": (5, 0, 12, 0, 0, 0, 257),
              "userspace": (5, 0, 12, 88, 0, 0, 379),
              "agentcgroup": (5, 0, 0, 0, 4, 0, 222)}
ROW_FIELDS = ("completed", "evicted", "overshoot_pages", "throttle_triggers",
              "freezes", "feedbacks", "steps")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small CPU matmuls: faster on one thread, and far faster where
    test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(path: str):
    """The source module, executed (a script at module level runs)."""
    spec = importlib.util.spec_from_file_location(
        "ref_" + Path(path).stem, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def call(fn, *a, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*a, **kw)
    return result, out.getvalue()


def jax_params(cfg, seed: int = 0):
    """The reference's weights of ``cfg`` as a numpy tree."""
    return jax.tree.map(np.asarray, j_init_params(
        JM.param_schema(cfg), jax.random.PRNGKey(seed), cfg.dtype))


def sections(text: str) -> dict:
    """Printed output by section header (``1``, ``1b``, ...)."""
    out = {}
    for part in ("\n" + text).split("\n== ")[1:]:
        out[part.split(".", 1)[0]] = part
    return out


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))


def test_serve_agents_rows_identical(monkeypatch):
    ref = load("examples/serve_agents.py")
    monkeypatch.setattr(sys, "argv", ["serve_agents.py"])
    _, want = call(ref.main)
    cfg = SA.model_config("llama3.2-3b", full=False)
    jcfg = dataclasses.replace(ref.reduced(ref.get_config("llama3.2-3b")),
                               dtype="float32")
    params = TM.params_from_jax(jax_params(jcfg), cfg, device="cpu")
    reports, got = call(SA.main, ["--device", "cpu"], params=params)
    assert got == want
    assert {m: tuple(r[k] for k in ROW_FIELDS)
            for m, r in reports.items()} == SERVE_ROWS


def test_quickstart_matches_source():
    ref, want = call(load, "examples/quickstart.py")
    # the reference's own jitted step from the example's weights and
    # batches: its loss at every step (the script prints every third)
    jparams = j_init_params(JM.param_schema(ref.cfg), jax.random.PRNGKey(0),
                            ref.cfg.dtype)
    start = jax.tree.map(np.asarray, jparams)
    jopt = j_init_state(ref.cfg, jparams, ref.perf)
    want_losses = []
    for i in range(10):
        jparams, jopt, m = ref.step(jparams, jopt, ref.data.at(i), i)
        want_losses.append(float(m["loss"]))
    params = TM.params_from_jax(start, QS.model_config(), device="cpu")
    got, text = call(QS.main, ["--device", "cpu"], params=params)

    w, g = sections(want), sections(text)
    assert list(g) == list(w) == ["1", "1b", "1c", "2", "3"]
    for sec in ("1", "1b", "1c"):
        assert g[sec] == w[sec], sec
    assert f"  step 9: loss {want_losses[9]:.3f}" in w["2"]
    assert len(got["losses"]) == 10
    assert rel_err(got["losses"], want_losses) <= REL, (got["losses"],
                                                        want_losses)
    assert got["report"] == ref.eng.report()
    assert g["3"] == w["3"]
    assert got["programs"] == (True, False, True)


class RecordingJax:
    """``jax`` for the source's module: ``jit`` records the loss and lr
    of every call of the jitted step."""

    def __init__(self):
        self.metrics = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        jitted = jax.jit(fn, **kw)

        def step(*a):
            out = jitted(*a)
            self.metrics.append((float(out[2]["loss"]), float(out[2]["lr"])))
            return out
        return step


CKPT_EVERY = 2
SMALL = ["--d-model", "128", "--layers", "2", "--batch", "2", "--seq", "32",
         "--steps", "6"]


def every_two(base, made: list):
    """``base`` saving every ``CKPT_EVERY`` steps; the port's also keeps
    a copy of each tree it saves, taken at the step."""
    class Manager(base):
        def __init__(self, directory, *, keep, every):
            super().__init__(directory, keep=keep, every=CKPT_EVERY)
            self.copies = {}
            made.append(self)

        def maybe_save(self, step, tree, *, force=False):
            saved = super().maybe_save(step, tree, force=force)
            if saved and base is TManager:
                self.copies[step] = tree_map(
                    lambda t: t.detach().clone(), tree)
            return saved
    return Manager


def same_bits(a, b) -> bool:
    fa, fb = tree_flatten_with_path(a)[0], tree_flatten_with_path(b)[0]
    return [p for p, _ in fa] == [p for p, _ in fb] and all(
        x.dtype == y.dtype and torch.equal(
            x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for (_, x), (_, y) in zip(fa, fb))


@pytest.mark.parametrize("compress", [False, True],
                         ids=["plain", "grad_compress"])
def test_train_100m_matches_source(monkeypatch, tmp_path, compress):
    argv = SMALL + (["--grad-compress"] if compress else [])
    ref = load("examples/train_100m.py")
    rec = RecordingJax()
    ref_mgrs, port_mgrs = [], []
    monkeypatch.setattr(ref, "jax", rec)
    monkeypatch.setattr(ref, "CheckpointManager", every_two(JManager,
                                                            ref_mgrs))
    monkeypatch.setattr(T100, "CheckpointManager", every_two(TManager,
                                                             port_mgrs))
    monkeypatch.setattr(sys, "argv", ["train_100m.py", *argv, "--ckpt-dir",
                                      str(tmp_path / "ref")])
    _, want = call(ref.main)
    cfg = T100.build_cfg(128, 2)
    params = TM.params_from_jax(jax_params(ref.build_cfg(128, 2)), cfg,
                                device="cpu")
    got, text = call(T100.main, argv + ["--device", "cpu", "--ckpt-dir",
                                        str(tmp_path / "port")],
                     params=params)

    assert text.splitlines()[0] == want.splitlines()[0]
    assert got["params"] == cfg.param_count()
    want_loss, want_lr = zip(*rec.metrics)
    assert len(got["losses"]) == len(want_loss) == 6
    assert rel_err(got["losses"], want_loss) <= REL
    assert rel_err(got["lrs"], want_lr) <= REL
    (jm,), (tm,) = ref_mgrs, port_mgrs
    assert tm.steps() == jm.steps() == [2, 4]
    assert set(tm.copies) == {2, 4}
    template = tm.copies[4]
    for step in tm.steps():
        at, tree = TCk.load(tm._path(step), template)
        assert at == step
        assert same_bits(tree, tm.copies[step]), step
    at, tree = tm.restore_latest(template)
    assert at == 4 and same_bits(tree, tm.copies[4])


@pytest.mark.parametrize("twin", [QS, SA, T100],
                         ids=["quickstart", "serve_agents", "train_100m"])
def test_twin_runs_on_the_card_by_default(monkeypatch, twin):
    """No silent fallback: without a card the default device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.main([])
