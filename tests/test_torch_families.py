"""The decoder families the port gained beside llama3.2-3b and Jamba,
against the JAX package on their reduced f32 configs: the dense GQA
``phi3-medium-14b`` (G 4), ``minicpm-2b`` (MHA, tied embeddings, the wsd
schedule) and ``internlm2-20b`` (G 6), the MoE ``llama4-maverick-400b-a17b``
(top 1 of the experts plus a shared one, every other layer) and the
mLSTM/sLSTM ``xlstm-350m``.  The JAX weights are carried over by
``params_from_jax``; each family holds its config fields, the forward
logits, the loss and every leaf's gradient, and four decode steps within
2e-5 (1 + |b|) of the JAX package, and its greedy decode over an 8-token
prompt matches its own forward's argmax (``tests/test_models_smoke.py``'s
cache check).  The plain mLSTM functions hold the JAX ``ref`` ones.

At the schema's initial scales an xLSTM block moves the residual stream
by ~1e-7, so ``lively`` widens its weights (identically for both
packages) until each block moves it by O(0.1).  The JAX results are
computed once per family (a module fixture)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch.utils._pytree import tree_flatten, tree_map

from repro.configs import get_config, reduced
from repro.configs import registry as JR
from repro.kernels import ref as JREF
from repro.models import model as JM
from repro.models.schema import init_params, tree_map_schema
from repro.perf import DEFAULT_PERF as J_PERF
from repro.perf import replace as j_perf
from repro_torch import configs as TC
from repro_torch.kernels import ref as TREF
from repro_torch.models import model as TM
from repro_torch.perf import DEFAULT_PERF as T_PERF
from repro_torch.perf import replace as t_perf

ARCHS = ["phi3-medium-14b", "minicpm-2b", "internlm2-20b",
         "llama4-maverick-400b-a17b", "xlstm-350m"]
B, S, S_MAX, STEPS = 2, 64, 32, 4
TOL = 2e-5
# generous MoE capacity: nothing dropped, so a forward equals its decode
J_TINY = j_perf(J_PERF, scan_chunk=32, remat="none", block_q=64, block_k=64,
                capacity_factor=8.0)
T_TINY = t_perf(T_PERF, scan_chunk=32, remat="none", capacity_factor=8.0)
# xLSTM leaves widened from the schema's scales (see the module note)
LIVELY = ("up", "conv_w", "wq", "wk", "wv", "w_i", "w_f", "down",
          "w_z", "w_o", "r_i", "r_f", "r_z", "r_o")


def lively(np_tree, cfg, seed=0, factor=5.0):
    """xLSTM mixer leaves times ``factor``, the gate biases drawn from a
    seeded normal; other families unchanged."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(np.array, np_tree)
    for pos, kind in zip(out["groups"], cfg.layer_kinds()):
        if kind not in ("mlstm", "slstm"):
            continue
        mix = pos["mixer"]
        for name in LIVELY:
            if name in mix:
                mix[name] = mix[name] * factor
        for name in ("b_i", "b_f"):
            mix[name] = rng.normal(1.0 if name == "b_f" else 0.0, 1.0,
                                   mix[name].shape).astype(np.float32)
    return out


def close(got, want, tol=TOL):
    """|got - want| <= tol (1 + |want|), elementwise."""
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want) - tol * (1 + np.abs(want))
    assert err.max() <= 0, float((np.abs(got - want)).max())


def tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape
                                                ).astype(np.int32)


def _path_get(tree, path):
    for k in path:
        tree = tree[getattr(k, "key", getattr(k, "idx", None))]
    return tree


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    """One family: both configs, both parameter trees, and the JAX
    package's forward, loss, gradients and decode steps."""
    arch = request.param
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    tcfg = dataclasses.replace(TC.reduced(TC.get_config(arch)),
                               dtype="float32")
    raw = init_params(JM.param_schema(cfg), jax.random.PRNGKey(0), cfg.dtype)
    np_tree = lively(jax.tree.map(np.asarray, raw), cfg)
    params = jax.tree.map(jnp.asarray, np_tree)
    tok = tokens(cfg, 0, (B, S))
    batch = {"tokens": tok, "labels": tokens(cfg, 1, (B, S)),
             "weights": np.ones((B, S), np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, aux = JM.forward(cfg, params, jb, perf=J_TINY)
    (loss, _), grads = jax.value_and_grad(
        lambda p: JM.loss_fn(cfg, p, jb, perf=J_TINY), has_aux=True)(params)
    jstate = tree_map_schema(
        lambda l: jnp.zeros(l.shape, jnp.dtype(l.dtype or cfg.dtype)),
        JM.decode_state_schema(cfg, B, S_MAX))
    step = jax.jit(lambda p, s, t, l: JM.decode_step(cfg, p, s, t, l,
                                                     perf=J_TINY))
    lengths = np.array([0, 5], np.int32)
    steps = []
    for i in range(STEPS):
        t = tokens(cfg, 10 + i, (B,))
        lg, jstate = step(params, jstate, jnp.asarray(t),
                          jnp.asarray(lengths + i))
        steps.append((t, lengths + i, np.asarray(lg)))
    return dict(arch=arch, cfg=cfg, tcfg=tcfg, batch=batch,
                tparams=TM.params_from_jax(np_tree, tcfg, device="cpu"),
                logits=np.asarray(logits), aux=float(aux), loss=float(loss),
                grads=grads, steps=steps,
                jstate=jax.tree.map(np.asarray, jstate))


def test_config_fields_agree(fam):
    """The full config and the reduced one have the JAX package's fields."""
    full, tfull = get_config(fam["arch"]), TC.get_config(fam["arch"])
    for a, b in ((full, tfull), (fam["cfg"], fam["tcfg"])):
        assert dataclasses.asdict(b) == dataclasses.asdict(a)
        assert b.padded_vocab == a.padded_vocab
        assert b.layer_kinds() == a.layer_kinds()
        assert b.ffn_kinds() == a.ffn_kinds()
        assert b.param_count() == a.param_count()


def test_forward_matches_jax(fam):
    tcfg, tparams = fam["tcfg"], fam["tparams"]
    got, aux = TM.forward(tcfg, tparams,
                          {"tokens": torch.from_numpy(fam["batch"]["tokens"])},
                          perf=T_TINY)
    close(got, fam["logits"])
    assert np.array_equal(got.argmax(-1).numpy(), fam["logits"].argmax(-1))
    assert abs(float(aux) - fam["aux"]) <= TOL * (1 + abs(fam["aux"]))
    assert (fam["aux"] > 0) == (tcfg.moe is not None)


def test_loss_and_grads_match_jax(fam):
    tcfg = fam["tcfg"]
    tparams = tree_map(lambda t: t.clone().requires_grad_(), fam["tparams"])
    batch = {k: torch.from_numpy(v) for k, v in fam["batch"].items()}
    loss, _ = TM.loss_fn(tcfg, tparams, batch, perf=T_TINY)
    loss.backward()
    assert abs(loss.item() - fam["loss"]) <= TOL * (1 + abs(fam["loss"]))
    paths = jax.tree_util.tree_leaves_with_path(fam["grads"])
    assert len(paths) == len(tree_flatten(tparams)[0])
    for path, g in paths:
        leaf = _path_get(tparams, path)
        assert leaf.grad is not None, path
        close(leaf.grad, g)


def test_decode_steps_match_jax(fam):
    tcfg, tparams = fam["tcfg"], fam["tparams"]
    state = TM.decode_state(tcfg, B, S_MAX, device="cpu")
    for tok, lengths, want in fam["steps"]:
        got, state = TM.decode_step(tcfg, tparams, state,
                                    torch.from_numpy(tok),
                                    torch.from_numpy(lengths), perf=T_TINY)
        close(got, want)
        assert np.array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    # the states after the steps: the recurrent ones carry the residual
    # stream's summation-order differences of every layer below them (an
    # mLSTM's conv state is its raw up-projection, O(4) at lively
    # scales), so they are held as the hybrid test holds Jamba's, 1e-4
    for kind, jpos, tpos in zip(tcfg.layer_kinds(), fam["jstate"], state):
        assert set(jpos) == set(tpos), kind
        for k in jpos:
            assert tpos[k].dtype == torch.float32
            close(tpos[k], jpos[k], tol=TOL if kind == "attn" else 1e-4)


def test_greedy_decode_matches_own_forward(fam):
    """Greedy decode over a fixed prompt matches the teacher-forced
    forward's argmax at each position (the twin of the reference's
    ``test_decode_matches_forward_prefix``), through ``serve_step``."""
    tcfg, tparams = fam["tcfg"], fam["tparams"]
    prompt = torch.tensor([[5, 7, 11, 13, 17, 19, 23, 29]], dtype=torch.int32)
    logits, _ = TM.forward(tcfg, tparams, {"tokens": prompt}, perf=T_TINY)
    want = logits[0].argmax(-1)
    state = TM.decode_state(tcfg, 1, 16, device="cpu")
    got = []
    for i in range(prompt.shape[1]):
        nxt, state = TM.serve_step(tcfg, tparams, state, prompt[:, i],
                                   torch.tensor([i], dtype=torch.int32),
                                   perf=T_TINY)
        assert nxt.dtype == torch.int32
        got.append(int(nxt[0]))
    assert want.tolist() == got


# ------------------------------------------------------------ mLSTM functions


def _mlstm_inputs(b=2, s=128, nh=2, dh=16):
    """The inputs of the reference's ``test_mlstm_chunked_matches_sequential``
    shape, drawn with numpy."""
    rng = np.random.default_rng(22)
    q, k, v = (rng.normal(size=(b, s, nh, dh)).astype(np.float32)
               for _ in range(3))
    ig = rng.normal(size=(b, s, nh)).astype(np.float32)
    fg = rng.normal(size=(b, s, nh)).astype(np.float32) + 2.0
    return q, k, v, ig, fg


def _mlstm_state(b=2, nh=2, dh=16):
    rng = np.random.default_rng(7)
    return (rng.normal(size=(b, nh, dh, dh)).astype(np.float32),
            rng.normal(size=(b, nh, dh)).astype(np.float32),
            rng.normal(size=(b, nh)).astype(np.float32))


@pytest.mark.parametrize("name", ["mlstm_sequential", "mlstm_chunked"])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_functions_match_jax(name, with_state):
    args = _mlstm_inputs()
    st = _mlstm_state() if with_state else None
    kw = {"chunk": 32} if name == "mlstm_chunked" else {}
    want_y, want_st = getattr(JREF, name)(
        *map(jnp.asarray, args),
        state=None if st is None else tuple(map(jnp.asarray, st)), **kw)
    got_y, got_st = getattr(TREF, name)(
        *map(torch.from_numpy, args),
        state=None if st is None else tuple(map(torch.from_numpy, st)), **kw)
    close(got_y, want_y)
    for g, w in zip(got_st, want_st):
        close(g, w)


def test_mlstm_decode_step_matches_jax():
    q, k, v, ig, fg = (a[:, 0] for a in _mlstm_inputs())
    st = _mlstm_state()
    want_y, want_st = JREF.mlstm_decode_step(
        tuple(map(jnp.asarray, st)), *map(jnp.asarray, (q, k, v, ig, fg)))
    got_y, got_st = TREF.mlstm_decode_step(
        tuple(map(torch.from_numpy, st)),
        *map(torch.from_numpy, (q, k, v, ig, fg)))
    close(got_y, want_y)
    for g, w in zip(got_st, want_st):
        close(g, w)


def test_mlstm_chunked_matches_sequential():
    """The reference's own tolerances (``tests/test_kernels.py``)."""
    args = tuple(map(torch.from_numpy, _mlstm_inputs()))
    y0, (C0, _, _) = TREF.mlstm_sequential(*args)
    y1, (C1, _, _) = TREF.mlstm_chunked(*args, chunk=32)
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(C1.numpy(), C0.numpy(), atol=2e-3, rtol=1e-3)


# ------------------------------------------------------------------ registry


def test_registry_order_and_refusals():
    """The port registers the reference's runnable architectures in its
    order; the MLA one names what it waits for."""
    assert TC.ARCH_IDS == [a for a in JR.ARCH_IDS
                           if a in TC.ARCH_IDS]
    assert set(TC.ARCH_IDS) == {"jamba-v0.1-52b", "llama3.2-3b", *ARCHS,
                                "pixtral-12b", "hubert-xlarge"}
    for arch in set(JR.ARCH_IDS) - set(TC.ARCH_IDS):
        with pytest.raises(NotImplementedError, match="item 7c"):
            TC.get_config(arch)
        with pytest.raises(NotImplementedError, match="item 7c"):
            TC.reduced(get_config(arch))
