"""The frontend families against the JAX package on their reduced f32
configs: ``hubert-xlarge`` (encoder-only, bidirectional, audio frames and
a mask in, the masked-frame loss) and ``pixtral-12b`` (a decoder whose
first token positions are replaced by patch embeddings, early fusion).
The JAX weights are carried over by ``params_from_jax``; each family
holds its config fields, the forward logits, the loss and every leaf's
gradient (the frontend projections and ``mask_emb`` included) within
2e-5 (1 + |b|) of the JAX package, on the batches both data pipelines
draw bit for bit from the same ``(seed, step)``.  hubert is refused by
the decode step and the engine with the reference's reason; pixtral
holds four decode steps, its greedy decode against its own forward, and
the engine's ``report()`` field for field against the JAX engine's.
The JAX results are computed once per family (a module fixture)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch.utils._pytree import tree_flatten, tree_map

from repro.configs import SHAPES, get_config, reduced
from repro.configs import registry as JR
from repro.core import domains as JD
from repro.data import pipeline as JP
from repro.models import model as JM
from repro.models.layers import embedding_schema
from repro.models.schema import init_params, tree_map_schema
from repro.perf import DEFAULT_PERF as J_PERF
from repro.perf import replace as j_perf
from repro.serving import session as JS
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch import configs as TC
from repro_torch.core import domains as TD
from repro_torch.data import pipeline as TP
from repro_torch.models import model as TM
from repro_torch.perf import DEFAULT_PERF as T_PERF
from repro_torch.perf import replace as t_perf
from repro_torch.serving import session as TS
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import EngineConfig as TEngineConfig
from repro_torch.serving.kvcache import SlotCaches, check_servable
from test_torch_engine import COMMON, MODES, sessions
from test_torch_families import _path_get, close

ARCHS = ["hubert-xlarge", "pixtral-12b"]
B, S, S_MAX, STEPS = 2, 64, 32, 4
TOL = 2e-5
J_TINY = j_perf(J_PERF, remat="none", block_q=64, block_k=64)
T_TINY = t_perf(T_PERF, remat="none")


def as_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    """One family: both configs, both parameter trees, a batch of the
    JAX data pipeline, and the JAX package's forward, loss and
    gradients (and pixtral's decode steps)."""
    arch = request.param
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    tcfg = dataclasses.replace(TC.reduced(TC.get_config(arch)),
                               dtype="float32")
    raw = init_params(JM.param_schema(cfg), jax.random.PRNGKey(0), cfg.dtype)
    np_tree = jax.tree.map(np.asarray, raw)
    params = jax.tree.map(jnp.asarray, np_tree)
    batch = JP.make_batch(cfg, SHAPES["train_4k"], seed=0, step=0, batch=B,
                          seq=S)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, _ = JM.forward(cfg, params, jb, perf=J_TINY)
    (loss, _), grads = jax.value_and_grad(
        lambda p: JM.loss_fn(cfg, p, jb, perf=J_TINY), has_aux=True)(params)
    steps = []
    if not cfg.encoder_only:
        jstate = tree_map_schema(
            lambda l: jnp.zeros(l.shape, jnp.dtype(l.dtype or cfg.dtype)),
            JM.decode_state_schema(cfg, B, S_MAX))
        step = jax.jit(lambda p, s, t, l: JM.decode_step(cfg, p, s, t, l,
                                                         perf=J_TINY))
        lengths = np.array([0, 5], np.int32)
        rng = np.random.default_rng(10)
        for i in range(STEPS):
            t = rng.integers(0, cfg.vocab, B).astype(np.int32)
            lg, jstate = step(params, jstate, jnp.asarray(t),
                              jnp.asarray(lengths + i))
            steps.append((t, lengths + i, np.asarray(lg)))
    return dict(arch=arch, cfg=cfg, tcfg=tcfg, batch=batch, params=params,
                tparams=TM.params_from_jax(np_tree, tcfg, device="cpu"),
                logits=np.asarray(logits), loss=float(loss), grads=grads,
                steps=steps)


def test_config_fields_agree(fam):
    """The full config and the reduced one have the JAX package's fields
    (the reduced: n_frontend_tokens min(n, 16); hubert's MHA 4 kv
    heads)."""
    full, tfull = get_config(fam["arch"]), TC.get_config(fam["arch"])
    for a, b in ((full, tfull), (fam["cfg"], fam["tcfg"])):
        assert dataclasses.asdict(b) == dataclasses.asdict(a)
        assert b.padded_vocab == a.padded_vocab
        assert b.param_count() == a.param_count()
    assert fam["tcfg"].n_frontend_tokens == min(full.n_frontend_tokens, 16)
    if fam["arch"] == "hubert-xlarge":
        assert fam["tcfg"].n_kv_heads == 4


def test_frontend_leaves_are_carried(fam):
    """The embedding leaves are the reference's, in its key order, and
    ``init_params`` and ``params_from_jax`` carry them."""
    cfg, tcfg = fam["cfg"], fam["tcfg"]
    leaves = TM.param_leaves(tcfg)["embed"]
    schema = embedding_schema(cfg)
    assert list(leaves) == list(schema)
    assert {k: l.shape for k, l in leaves.items()} == {
        k: tuple(l.shape) for k, l in schema.items()}
    drawn = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")["embed"]
    assert {k: tuple(t.shape) for k, t in drawn.items()} == {
        k: tuple(l.shape) for k, l in schema.items()}
    for k, t in fam["tparams"]["embed"].items():
        assert np.array_equal(t.numpy(), np.asarray(fam["params"]["embed"][k]))
    front = {"vision": {"patch_proj"}, "audio": {"frame_proj", "mask_emb"}}
    assert front[cfg.frontend] <= set(leaves)


def test_forward_matches_jax(fam):
    got, aux = TM.forward(fam["tcfg"], fam["tparams"], as_torch(fam["batch"]),
                          perf=T_TINY)
    close(got, fam["logits"])
    assert float(aux) == 0.0


def test_loss_and_grads_match_jax(fam):
    tcfg = fam["tcfg"]
    tparams = tree_map(lambda t: t.clone().requires_grad_(), fam["tparams"])
    loss, _ = TM.loss_fn(tcfg, tparams, as_torch(fam["batch"]), perf=T_TINY)
    loss.backward()
    assert abs(loss.item() - fam["loss"]) <= TOL * (1 + abs(fam["loss"]))
    paths = jax.tree_util.tree_leaves_with_path(fam["grads"])
    assert len(paths) == len(tree_flatten(tparams)[0])
    names = set()
    for path, g in paths:
        leaf = _path_get(tparams, path)
        names.add(path[-1].key)
        # hubert embeds frames, never tokens: its token table takes no
        # gradient (jax.grad gives it zeros)
        got = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        close(got, g)
    assert {"patch_proj"} <= names or {"frame_proj", "mask_emb"} <= names
    if fam["arch"] == "hubert-xlarge":
        assert np.abs(np.asarray(fam["grads"]["embed"]["mask_emb"])).max() > 0


def test_batches_match_jax_bit_for_bit(fam):
    """``make_batch`` draws the reference's batch bit for bit at two
    ``(seed, step)`` pairs: audio frames, mask, labels and weights (the
    mask); vision tokens, labels, weights (zero on the patch positions)
    and patches."""
    cfg, tcfg = fam["cfg"], fam["tcfg"]
    for seed, step in ((0, 0), (3, 17)):
        want = JP.make_batch(cfg, SHAPES["train_4k"], seed=seed, step=step,
                             batch=B, seq=S)
        got = TP.make_batch(tcfg, SHAPES["train_4k"], seed=seed, step=step,
                            batch=B, seq=S)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(
                got[k], want[k]), k
    if cfg.frontend == "audio":
        assert got["mask"].dtype == bool
        assert np.array_equal(got["weights"], got["mask"].astype(np.float32))
    else:
        n = tcfg.n_frontend_tokens
        assert got["patches"].shape == (B, n, tcfg.d_model)
        assert not got["weights"][:, :n].any() and got["weights"][:, n:].any()
    it = TP.DataIterator(tcfg, SHAPES["train_4k"], seed=3, batch=B, seq=S,
                         device="cpu").at(17)
    for k in want:
        assert np.array_equal(it[k].numpy(), want[k]), k


# ------------------------------------------------------------------ hubert


@pytest.fixture(scope="module")
def hubert():
    cfg = dataclasses.replace(TC.reduced(TC.get_config("hubert-xlarge")),
                              dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    return cfg, params


def test_hubert_attends_both_ways(hubert):
    """Encoder-only attention is bidirectional: a change to the last
    frame moves position 0's logits."""
    cfg, params = hubert
    batch = as_torch(TP.make_batch(cfg, SHAPES["train_4k"], seed=0, step=0,
                                   batch=1, seq=32))
    base, _ = TM.forward(cfg, params, batch, perf=T_TINY)
    frames = batch["frames"].clone()
    frames[:, -1] += 1.0
    moved, _ = TM.forward(cfg, params, dict(batch, frames=frames),
                          perf=T_TINY)
    assert (moved[0, 0] - base[0, 0]).abs().max().item() > 1e-4
    # and a decoder's causal mask would not: the first position's logits
    # ignore the last frame when the forward is told causal=True
    c0, _ = TM.forward(cfg, params, batch, perf=T_TINY, causal=True)
    c1, _ = TM.forward(cfg, params, dict(batch, frames=frames), perf=T_TINY,
                       causal=True)
    assert torch.equal(c0[0, 0], c1[0, 0])


def test_hubert_has_no_decode_step(hubert):
    """The reference's refusal, in the model and in the engine."""
    cfg, params = hubert
    with pytest.raises(ValueError, match="encoder-only; no decode step"):
        TM.decode_step(cfg, params, [], torch.zeros(1, dtype=torch.int32),
                       torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="encoder-only; no decode step"):
        TM.decode_state(cfg, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="encoder-only; no decode step"):
        check_servable(cfg)
    with pytest.raises(ValueError, match="encoder-only; no decode step"):
        SlotCaches(cfg, 2, 16, "cpu")


def test_hubert_trains_through_the_driver(tmp_path):
    """``launch.train --arch hubert-xlarge --reduced --device cpu``: six
    finite masked-frame losses where random weights and random cluster
    labels put them (ln 512, the padded vocab: the synthetic labels are
    drawn afresh each step, so there is nothing to learn)."""
    from repro_torch.launch import train

    args = train.parse_args([
        "--arch", "hubert-xlarge", "--reduced", "--device", "cpu",
        "--steps", "6", "--batch", "2", "--seq", "32", "--ckpt-every", "0",
        "--lr", "3e-3", "--ckpt-dir", str(tmp_path)])
    report = train.run(args)
    losses = report["losses"]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert all(abs(x - np.log(512)) < 0.5 for x in losses)


def test_card_training_refuses_d160():
    """pixtral's head dim 160 now has a flash backward on the card: the
    trainer's card check passes it, and the run goes on to ask for the
    card (here, where torch sees none, ``resolve_device`` refuses)."""
    from repro_torch.launch import train

    args = train.parse_args(["--arch", "pixtral-12b", "--device", "cuda",
                             "--layers", "1"])
    TM.check_card_training(TC.get_config("pixtral-12b"))
    with pytest.raises(RuntimeError, match="torch sees no CUDA device"):
        train.run(args)


@pytest.mark.parametrize("arch,reduce,refusal", [
    ("pixtral-12b", False, None),
    ("pixtral-12b", True, None), ("hubert-xlarge", False, None),
    ("llama3.2-3b", False, None), ("deepseek-v2-236b", False, None),
    ("deepseek-v2-236b", True, r"\(dk, dv\) \(48, 32\)"),
    ("jamba-v0.1-52b", True, "gradient of the SSD")])
def test_check_card_training(arch, reduce, refusal):
    """The model layer says which configs a backward on the card cannot
    take: the SSD gradient, and a (dk, dv) pair the flash kernels do not
    take (the reduced deepseek's 48 / 32); pixtral (d 160 and, reduced,
    32), hubert (d 80), llama (d 128) and deepseek (192 / 128) train
    there."""
    cfg = TC.get_config(arch)
    cfg = TC.reduced(cfg) if reduce else cfg
    if refusal is None:
        TM.check_card_training(cfg)
    else:
        with pytest.raises(NotImplementedError, match=refusal):
            TM.check_card_training(cfg)


# ----------------------------------------------------------------- pixtral


@pytest.fixture(scope="module")
def pixtral():
    cfg = dataclasses.replace(reduced(get_config("pixtral-12b")),
                              dtype="float32")
    tcfg = dataclasses.replace(TC.reduced(TC.get_config("pixtral-12b")),
                               dtype="float32")
    raw = jax.tree.map(np.asarray, init_params(
        JM.param_schema(cfg), jax.random.PRNGKey(0), cfg.dtype))
    return (cfg, jax.tree.map(jnp.asarray, raw), tcfg,
            TM.params_from_jax(raw, tcfg, device="cpu"))


def test_pixtral_decode_steps_match_jax(fam):
    if fam["arch"] != "pixtral-12b":
        pytest.skip("hubert has no decode step")
    tcfg, tparams = fam["tcfg"], fam["tparams"]
    state = TM.decode_state(tcfg, B, S_MAX, device="cpu")
    for tok, lengths, want in fam["steps"]:
        got, state = TM.decode_step(tcfg, tparams, state,
                                    torch.from_numpy(tok),
                                    torch.from_numpy(lengths), perf=T_TINY)
        close(got, want)
        assert np.array_equal(got.argmax(-1).numpy(), want.argmax(-1))


def test_pixtral_greedy_decode_matches_own_forward(pixtral):
    """Greedy decode over an 8-token prompt matches the teacher-forced
    forward's argmax at each position (a text prompt: the patches enter
    a forward, never a decode step)."""
    _, _, tcfg, tparams = pixtral
    prompt = torch.tensor([[5, 7, 11, 13, 17, 19, 23, 29]], dtype=torch.int32)
    logits, _ = TM.forward(tcfg, tparams, {"tokens": prompt}, perf=T_TINY)
    state = TM.decode_state(tcfg, 1, 16, device="cpu")
    got = []
    for i in range(prompt.shape[1]):
        nxt, state = TM.serve_step(tcfg, tparams, state, prompt[:, i],
                                   torch.tensor([i], dtype=torch.int32),
                                   perf=T_TINY)
        got.append(int(nxt[0]))
    assert logits[0].argmax(-1).tolist() == got


def test_pixtral_patches_replace_the_first_positions(pixtral):
    """Early fusion: the patches change the logits at every position
    (causal attention carries them forward), and the loss puts no weight
    on the positions they replace."""
    _, _, tcfg, tparams = pixtral
    batch = as_torch(TP.make_batch(tcfg, SHAPES["train_4k"], seed=1, step=2,
                                   batch=1, seq=32))
    with_patches, _ = TM.forward(tcfg, tparams, batch, perf=T_TINY)
    text = {k: v for k, v in batch.items() if k != "patches"}
    without, _ = TM.forward(tcfg, tparams, text, perf=T_TINY)
    assert (with_patches - without).abs().amax(-1).min().item() > 0
    assert not batch["weights"][:, :tcfg.n_frontend_tokens].any()


def test_pixtral_report_field_identical(pixtral):
    """The engine serves pixtral (text decode, as the reference's engine
    does): report and greedy token streams equal the JAX engine's."""
    cfg, params, tcfg, tparams = pixtral
    runs = []
    for E, Cfg, model, Sx, Dx, dev in (
            (JEngine, JEngineConfig, (cfg, params), JS, JD, {}),
            (TEngine, TEngineConfig, (tcfg, tparams), TS, TD,
             {"device": "cpu"})):
        eng = E(*model, ecfg=Cfg(**COMMON, **MODES["inkernel"]), seed=0,
                **dev)
        sess = sessions(Sx, Dx)
        for s in sess:
            eng.submit(s)
        eng.run(6000)
        runs.append((eng.report(), [s.out_tokens for s in sess]))
    (jreport, jstreams), (treport, tstreams) = runs
    assert treport == jreport
    assert treport["completed"] == 3 and treport["freezes"] >= 1
    assert tstreams == jstreams


# ----------------------------------------------------------------- registry


def test_registry_holds_the_frontends_and_refuses_mla():
    """Every architecture of the reference is registered, in its order:
    the frontends and MLA's deepseek-v2-236b, whose reduced config and
    schema the port takes, and whose latent cache the engine serves."""
    assert {"hubert-xlarge", "pixtral-12b",
            "deepseek-v2-236b"} <= set(TC.ARCH_IDS)
    assert TC.ARCH_IDS == JR.ARCH_IDS
    small = TC.reduced(TC.get_config("deepseek-v2-236b"))
    assert dataclasses.asdict(small) == dataclasses.asdict(
        reduced(get_config("deepseek-v2-236b")))
    from repro_torch.configs.base import MLAConfig

    mla = dataclasses.replace(TC.reduced(TC.get_config("llama3.2-3b")),
                              mla=MLAConfig())
    assert set(TM.param_leaves(mla)["groups"][0]["mixer"]) == {
        "w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_uk", "w_uv", "wo"}
    check_servable(mla)
