"""bf16 against f32 training from the same weights and batches
(``repro_torch.training.trajectory``) on the CPU, through the plain
versions, at the miniature's width and 256 positions: the drift bf16
arithmetic alone gives stays within the bar that ``chip_smoke.py``'s
train_full holds the card's bf16 losses to."""
import pytest
torch = pytest.importorskip("torch")

from repro_torch.training import trajectory as T                # noqa: E402


@pytest.fixture(scope="module")
def runs():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T, "SEQ", 256)
        out = T.compare(T.model_config(full_width=False), device="cpu")
    torch.set_num_threads(n)
    return out


def test_every_run_starts_from_the_same_weights(runs):
    assert set(runs) == {"bf16", "f32"}
    assert all(len(losses) == T.STEPS for losses in runs.values())
    # step 0 runs on the initial weights: only the arithmetic differs
    assert T.rel_drift(runs["bf16"], runs["f32"])[0] < 1e-4


def test_bf16_trajectory_within_the_bar(runs):
    v = T.verdict(runs)
    assert v["over"] == [] and v["max_held_drift"] <= T.REL_BAR, v
    assert v["held_steps"] == [0, 1, 2, 3, 4] and len(v["bf16_rel_drift"]) == 8
    # the weights moved: the loss is not where it started
    assert runs["f32"][-1] < runs["f32"][0]


def test_verdict_holds_only_the_warmup_steps():
    """A held step past ``REL_BAR`` is named; a step after the warmup,
    where the f32 run may have diverged, is printed and never held."""
    f32 = [10.0] * 8
    assert T.verdict({"f32": f32, "bf16": f32})["over"] == []
    bf16 = [10.0, 10.0, 10.0 * (1 + 2 * T.REL_BAR), 10.0, 10.0,
            20.0, 10.0, 30.0]
    v = T.verdict({"f32": f32, "bf16": bf16})
    assert v["over"] == [2] and v["bf16_rel_drift"][7] == 2.0
