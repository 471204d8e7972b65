"""The port's hybrid model (Jamba: 7 Mamba-2 + 1 attention layers a
group, MoE every other layer) against the JAX package on the reduced
f32 ``jamba-v0.1-52b``, with the JAX weights carried over by
``params_from_jax``: the full-sequence ``forward`` (logits within 1e-4,
aux within 1e-6), six ``decode_step``s (logits within 1e-4, identical
argmax), the port's own forward against its token-by-token decode, and
the f32 leaves that stay f32 at a bf16 model dtype.

At the schema's initial scales the Mamba blocks contribute ~1e-5 (the
gated norm's eps dominates their tiny activations), so ``lively``
widens their weights, identically for both packages, until each block
moves the residual stream by O(0.01-0.1)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import get_config, reduced
from repro.models import model as JM
from repro.models.schema import init_params, tree_map_schema
from repro.perf import DEFAULT_PERF as J_PERF
from repro.perf import replace as j_perf
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.models import model as TM
from repro_torch.perf import DEFAULT_PERF as T_PERF
from repro_torch.perf import replace as t_perf

ARCH = "jamba-v0.1-52b"
B, S, S_MAX = 2, 64, 48
J_TINY = j_perf(J_PERF, scan_chunk=32, remat="none", block_q=64, block_k=64)
T_TINY = t_perf(T_PERF, scan_chunk=32, remat="none")
# Mamba leaves widened from the schema's std 0.02 (see the module note)
LIVELY = {"in_proj": 5.0, "conv_w": 25.0, "x_to_bc": 6.0, "x_to_dt": 5.0}


def lively(np_tree, cfg, seed=0):
    rng = np.random.default_rng(seed)
    out = jax.tree.map(np.array, np_tree)
    for pos, kind in zip(out["groups"], cfg.layer_kinds()):
        if kind != "mamba":
            continue
        mix = pos["mixer"]
        for name, f in LIVELY.items():
            mix[name] = mix[name] * f
        mix["a_log"] = rng.normal(0, 0.5, mix["a_log"].shape).astype(
            np.float32)
        mix["dt_bias"] = rng.normal(0, 1, mix["dt_bias"].shape).astype(
            np.float32)
        mix["d_skip"] = rng.normal(1, 0.5, mix["d_skip"].shape).astype(
            np.float32)
    return out


def configs(dtype="float32"):
    return (dataclasses.replace(reduced(get_config(ARCH)), dtype=dtype),
            dataclasses.replace(t_reduced(t_get_config(ARCH)), dtype=dtype))


@pytest.fixture(scope="module")
def pair():
    cfg, tcfg = configs()
    raw = init_params(JM.param_schema(cfg), jax.random.PRNGKey(0), cfg.dtype)
    np_tree = lively(jax.tree.map(np.asarray, raw), cfg)
    params = jax.tree.map(jnp.asarray, np_tree)
    return cfg, params, tcfg, TM.params_from_jax(np_tree, tcfg,
                                                 device="cpu")


def tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape
                                                ).astype(np.int32)


def test_layout_and_f32_leaves_at_bf16():
    """``params_from_jax`` and ``init_params`` give the reference's tree;
    a_log, d_skip and the router stay f32 when the model is bf16."""
    cfg, tcfg = configs("bfloat16")
    jp = init_params(JM.param_schema(cfg), jax.random.PRNGKey(1), cfg.dtype)
    tp = TM.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    drawn = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    f32 = {"a_log", "d_skip", "router"}
    for tree in (tp, drawn):
        for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
            node = tree
            for k in path:
                node = node[getattr(k, "key", getattr(k, "idx", None))]
            assert tuple(node.shape) == leaf.shape
            name = getattr(path[-1], "key", None)
            assert node.dtype == (torch.float32 if name in f32
                                  else torch.bfloat16), path
            assert str(leaf.dtype) == ("float32" if name in f32
                                       else "bfloat16")
    mix = tp["groups"][0]["mixer"]
    assert torch.equal(mix["a_log"], torch.zeros_like(mix["a_log"]))
    assert torch.equal(drawn["groups"][0]["mixer"]["d_skip"],
                       torch.ones_like(mix["d_skip"]))


def test_forward_matches_jax(pair):
    cfg, params, tcfg, tparams = pair
    tok = tokens(cfg, 0, (B, S))
    want, aux = JM.forward(cfg, params, {"tokens": jnp.asarray(tok)},
                           perf=J_TINY)
    got, taux = TM.forward(tcfg, tparams, {"tokens": torch.from_numpy(tok)},
                           perf=T_TINY)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert np.array_equal(got.argmax(-1).numpy(),
                          np.asarray(want).argmax(-1))
    assert abs(float(taux) - float(aux)) <= 1e-6
    assert float(aux) > 0


def test_decode_steps_match_jax(pair):
    cfg, params, tcfg, tparams = pair
    jstate = tree_map_schema(
        lambda l: jnp.zeros(l.shape, jnp.dtype(l.dtype or cfg.dtype)),
        JM.decode_state_schema(cfg, B, S_MAX))
    tstate = TM.decode_state(tcfg, B, S_MAX, device="cpu")
    lengths = np.array([0, 5], np.int32)
    step = jax.jit(lambda p, s, t, l: JM.decode_step(cfg, p, s, t, l))
    rng = np.random.default_rng(6)
    for _ in range(6):
        tok = rng.integers(0, cfg.vocab, B).astype(np.int32)
        want, jstate = step(params, jstate, jnp.asarray(tok),
                            jnp.asarray(lengths))
        got, tstate = TM.decode_step(tcfg, tparams, tstate,
                                     torch.from_numpy(tok),
                                     torch.from_numpy(lengths))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        assert np.array_equal(got.argmax(-1).numpy(),
                              np.asarray(want).argmax(-1))
        lengths = lengths + 1
    for kind, jpos, tpos in zip(cfg.layer_kinds(), jstate, tstate):
        assert set(jpos) == set(tpos) == ({"k", "v"} if kind == "attn"
                                          else {"conv", "h"})
        for k in jpos:
            # the f32 SSD states grow to O(10): held relative to their size
            np.testing.assert_allclose(tpos[k].numpy(), np.asarray(jpos[k]),
                                       rtol=1e-4, atol=1e-4)


def test_forward_matches_own_decode(pair):
    """Position t of the forward equals the decode of token t on top of
    tokens 0..t-1.  Generous MoE capacity: a decode step routes only B
    tokens, so the forward must drop nothing for the two to agree."""
    _, _, tcfg, tparams = pair
    perf = t_perf(T_TINY, capacity_factor=8.0)
    tok = torch.from_numpy(tokens(tcfg, 1, (B, 32)))
    full, _ = TM.forward(tcfg, tparams, {"tokens": tok}, perf=perf)
    state = TM.decode_state(tcfg, B, 32, device="cpu")
    for t in range(tok.shape[1]):
        got, state = TM.decode_step(tcfg, tparams, state, tok[:, t],
                                    torch.full((B,), t, dtype=torch.int32),
                                    perf=perf)
        np.testing.assert_allclose(got.numpy(), full[:, t].numpy(),
                                   atol=1e-4)


def test_engine_serves_reduced_jamba():
    """The engine serves Jamba: its Mamba states go through the gated
    merge, ``free_slot`` and freeze/thaw by their slot axis (the report
    against the JAX engine's is in ``tests/test_torch_engine.py``)."""
    from repro_torch.core import domains as TD
    from repro_torch.serving import session as TS
    from repro_torch.serving.engine import Engine, EngineConfig

    _, tcfg = configs()
    params = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    eng = Engine(tcfg, params, ecfg=EngineConfig(max_slots=2, s_max=64,
                                                 pool_pages=8),
                 device="cpu")
    eng.submit(TS.Session(sid="a", tenant="t", priority=TD.HIGH,
                          prompt=list(range(2, 20)),
                          phases=[TS.Phase(4, 8, "test"), TS.Phase(4, 0)]))
    eng.run(200)
    assert eng.done() and eng.report()["completed"] == 1
    kinds = {kind: set(pos) for kind, pos in zip(tcfg.layer_kinds(),
                                                 eng.caches.state)}
    assert kinds == {"attn": {"k", "v"}, "mamba": {"conv", "h"}}


@pytest.mark.parametrize("change", ["mla", "vision", "audio_encoder"])
def test_engine_refuses_mla_and_frontends(change):
    """An MLA model is served (its latent cache by its slot axis); an
    encoder-only model has no decode step (the reference's reason); a
    vision model is served, as the reference's engine serves it (it
    decodes text tokens)."""
    from repro_torch.configs.base import MLAConfig
    from repro_torch.serving.kvcache import SlotCaches, check_servable

    base = t_reduced(t_get_config("llama3.2-3b"))
    cfg = dataclasses.replace(base, **{
        "mla": dict(mla=MLAConfig()),
        "vision": dict(frontend="vision", n_frontend_tokens=16),
        "audio_encoder": dict(frontend="audio", encoder_only=True),
    }[change])
    if change in ("vision", "mla"):
        check_servable(cfg)
        caches = SlotCaches(cfg, 2, 32, "cpu")
        assert caches.n_free == 2
        assert set(caches.state[0]) == (
            {"ckv", "krope"} if change == "mla" else {"k", "v"})
        return
    err, match = ValueError, "encoder-only"
    with pytest.raises(err, match=match):
        check_servable(cfg)
    with pytest.raises(err, match=match):
        SlotCaches(cfg, 2, 32, "cpu")


def test_card_training_refuses_mamba_models():
    """No SSD gradient on the card, as in the reference."""
    from repro_torch.launch import train

    args = train.parse_args(["--arch", ARCH, "--device", "cuda"])
    with pytest.raises(NotImplementedError, match="gradient of the SSD"):
        train.run(args)
