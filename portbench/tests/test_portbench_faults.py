"""A run with the timed path broken underneath must come out not
correct; the control (the reference with float8 weight products in the
program's place) must fail the limit.  Each drives a whole run of a
tiny cell on the CPU (the harness's look for a card skipped): set-up,
the window, the comparison."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from portbench.harness import bench  # noqa: E402
from portbench.tests import tiny  # noqa: E402

SEED = 2 ** 31 + 101


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("tinyroot"))


def _run(root, cell: str, control: bool = False) -> dict:
    ctx = bench.load_cell(root, cell)
    ctx["control"] = control
    return bench.execute(ctx, SEED, 0.6, 0, torch.device("cpu"))


def _state_unchanged(monkeypatch):
    """The decode step writes nothing into the caches it is given."""
    from repro_torch.models import model as M
    real = M.decode_step

    def step(cfg, params, state, *a, **kw):
        copy = [{k: t.clone() for k, t in pos.items()} for pos in state]
        logits, _ = real(cfg, params, copy, *a, **kw)
        return logits, state
    monkeypatch.setattr(M, "decode_step", step)


def _half_batch(monkeypatch):
    """Half of the slots decoded; the rest take the mean of their logits."""
    from repro_torch.models import model as M
    real = M.decode_step

    def step(*a, **kw):
        logits, state = real(*a, **kw)
        h = logits.shape[0] // 2
        logits[h:] = logits[:h].mean(0)
        return logits, state
    monkeypatch.setattr(M, "decode_step", step)


def _token_altered(monkeypatch):
    """Each served token is the next id after the one chosen."""
    from repro_torch.serving import engine as E
    real = E.sample

    def sample(logits, *a, **kw):
        return (real(logits, *a, **kw) + 1) % logits.shape[-1]
    monkeypatch.setattr(E, "sample", sample)


def _grant_altered(monkeypatch):
    """The in-step charge grants the first slot whatever it decided."""
    from repro_torch.core import controller as C
    real = C.charge_batch

    def charge(state, dom, amt, step, prog=None):
        new, granted, stalled = real(state, dom, amt, step, prog)
        granted = granted.clone()
        granted[0] = ~granted[0]
        return new, granted, stalled
    monkeypatch.setattr(C, "charge_batch", charge)


SERVE_FAULTS = {"state_unchanged": (_state_unchanged, "served_gap"),
                "half_batch": (_half_batch, "served_gap"),
                "token_altered": (_token_altered, "served_gap"),
                "grant_altered": (_grant_altered, "charge_mismatch_steps")}


@pytest.mark.parametrize("fault", sorted(SERVE_FAULTS))
def test_serving_fault_is_not_correct(root, monkeypatch, fault):
    plant, number = SERVE_FAULTS[fault]
    plant(monkeypatch)
    out = _run(root, "tiny-dense.bursts")
    assert out["result"]["correct"] is False
    assert out["result"]["checks"][number]["value"] > \
        out["result"]["checks"][number]["limit"]


def _ssd_state_unchanged(monkeypatch):
    """The SSD scan never moves its state: only the skip term remains."""
    from repro_torch.kernels import ops

    def ssd(x, dt, A, B, C, D, **kw):
        y = (D.float()[None, None, :, None] * x.float()).to(x.dtype)
        return y, torch.zeros(x.shape[0], x.shape[2], x.shape[3],
                              B.shape[-1])
    monkeypatch.setattr(ops, "ssd", ssd)


def _moe_half(monkeypatch):
    """The experts see the first half of the tokens; the rest take the
    mean of their outputs."""
    from repro_torch.models import moe
    real = moe.moe_forward

    def fwd(cfg, p, x, **kw):
        y, aux = real(cfg, p, x, **kw)
        h = y.shape[1] // 2
        y = torch.cat([y[:, :h], y[:, :h].mean(1, keepdim=True).expand(
            -1, y.shape[1] - h, -1)], 1)
        return y, aux
    monkeypatch.setattr(moe, "moe_forward", fwd)


def _answer_altered(monkeypatch):
    """One logit of every position moved by one unit."""
    from repro_torch.models import model as M
    real = M.forward

    def fwd(*a, **kw):
        logits, aux = real(*a, **kw)
        logits[..., 7] += 1.0
        return logits, aux
    monkeypatch.setattr(M, "forward", fwd)


PREFILL_FAULTS = {"ssd_state_unchanged": _ssd_state_unchanged,
                  "moe_half": _moe_half, "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(PREFILL_FAULTS))
def test_prefill_fault_is_not_correct(root, monkeypatch, fault):
    PREFILL_FAULTS[fault](monkeypatch)
    out = _run(root, "tiny-hybrid.prefill")
    assert out["result"]["correct"] is False


@pytest.mark.parametrize("cell,number,control", [
    ("tiny-dense.bursts", "served_gap", "control_gap"),
    ("tiny-hybrid.prefill", "off_positions_share",
     "control_off_positions_share")])
def test_sound_run_passes_and_control_fails(root, cell, number, control):
    out = _run(root, cell, control=True)
    limit = out["result"]["checks"][number]["limit"]
    assert out["result"]["correct"] is True
    assert out["numbers"][number] <= limit < out["numbers"][control]
