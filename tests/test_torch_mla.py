"""MLA (multi-head latent attention) and ``deepseek-v2-236b`` in the port,
against the JAX package on the reduced f32 config (dk 48 / dv 32, a
32-wide latent, top 2 of 4 experts plus 2 shared), with the JAX weights
carried over by ``params_from_jax``: ``mla_forward`` and ``mla_decode``
alone (over ragged lengths, 0 and S_max - 1 among them), the whole
model's forward, loss and every gradient, three decode steps, and the
engine's ``report()`` in inkernel mode, within 2e-5 (1 + |b|) or field
for field.  The engine's gated merge keeps a denied slot's latent rows
bit for bit, and freeze/thaw gives them back.  The flash plain version
at MLA's full dk 192 / dv 128 against the JAX kernel in interpret mode,
and the bf16 kernels' roundings at (192, 128) and (160, 160) emulated
on the CPU within the card's bar.  The JAX results are computed once (a
module fixture)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch.utils._pytree import tree_flatten, tree_map

from repro.configs import get_config, reduced
from repro.core import domains as JD
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as JA
from repro.models import model as JM
from repro.models.layers import rope_table as j_rope_table
from repro.models.schema import init_params, tree_map_schema
from repro.serving import session as JS
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch import configs as TC
from repro_torch.core import domains as TD
from repro_torch.kernels import ref as TR
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models.layers import rope_table as t_rope_table
from repro_torch.serving import session as TS
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import EngineConfig as TEngineConfig
from repro_torch.serving.kvcache import SlotCaches
from test_torch_engine import COMMON, MODES, sessions
from test_torch_families import J_TINY, T_TINY, _path_get, close, tokens
from test_torch_flash_attention import _bar_ratio, _emulated_vs_plain

ARCH = "deepseek-v2-236b"
B, S, S_MAX, STEPS = 2, 48, 40, 3


def _layer0(tree):
    """Group 0 of a stacked numpy tree."""
    return jax.tree.map(lambda a: np.asarray(a)[0], tree)


@pytest.fixture(scope="module")
def mla():
    cfg = dataclasses.replace(reduced(get_config(ARCH)), dtype="float32")
    tcfg = dataclasses.replace(TC.reduced(TC.get_config(ARCH)),
                               dtype="float32")
    raw = init_params(JM.param_schema(cfg), jax.random.PRNGKey(0), cfg.dtype)
    np_tree = jax.tree.map(np.asarray, raw)
    params = jax.tree.map(jnp.asarray, np_tree)
    batch = {"tokens": tokens(cfg, 0, (B, S)),
             "labels": tokens(cfg, 1, (B, S)),
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
    lengths = np.array([0, 7], np.int32)
    steps = []
    for i in range(STEPS):
        t = tokens(cfg, 10 + i, (B,))
        lg, jstate = step(params, jstate, jnp.asarray(t),
                          jnp.asarray(lengths + i))
        steps.append((t, lengths + i, np.asarray(lg)))
    return dict(cfg=cfg, tcfg=tcfg, np_tree=np_tree, params=params,
                batch=batch,
                tparams=TM.params_from_jax(np_tree, tcfg, device="cpu"),
                logits=np.asarray(logits), aux=float(aux), loss=float(loss),
                grads=grads, steps=steps,
                jstate=jax.tree.map(np.asarray, jstate))


def test_config_fields_agree(mla):
    full, tfull = get_config(ARCH), TC.get_config(ARCH)
    for a, b in ((full, tfull), (mla["cfg"], mla["tcfg"])):
        assert dataclasses.asdict(b) == dataclasses.asdict(a)
        assert b.param_count() == a.param_count()
        assert b.layer_kinds() == a.layer_kinds()
        assert b.ffn_kinds() == a.ffn_kinds()
    assert TM.head_dims(tfull) == (192, 128)
    assert TM.head_dims(mla["tcfg"]) == (48, 32)
    # top 6 of 160 routed experts plus 2 shared, every layer
    assert (tfull.moe.n_experts, tfull.moe.top_k, tfull.moe.n_shared,
            tfull.moe.period) == (160, 6, 2, 1)


def test_schema_matches_jax(mla):
    """The eight MLA leaves in the reference's shapes (``wo`` is (H, v,
    d)), and the latent decode state of ``mla_cache_schema``."""
    tleaves = TM.param_leaves(TC.get_config(ARCH))
    jleaves = JM.param_schema(get_config(ARCH))
    tmix, jmix = tleaves["groups"][0]["mixer"], jleaves["groups"][0]["mixer"]
    assert set(tmix) == set(jmix) == {"w_dq", "q_norm", "w_uq", "w_dkv",
                                      "kv_norm", "w_uk", "w_uv", "wo"}
    for k in tmix:
        assert tmix[k].shape == jmix[k].shape, k
    assert tmix["wo"].shape == (60, 128, 128, 5120)
    tcfg = mla["tcfg"]
    state = TM.decode_state(tcfg, 3, 16, device="cpu")
    jst = JM.decode_state_schema(mla["cfg"], 3, 16)
    assert {k: tuple(t.shape) for k, t in state[0].items()} == {
        k: tuple(l.shape) for k, l in jst[0].items()} == {
        "ckv": (1, 3, 16, 32), "krope": (1, 3, 16, 16)}


def test_mla_forward_matches_jax(mla):
    cfg, tcfg = mla["cfg"], mla["tcfg"]
    x = np.random.default_rng(3).standard_normal((B, S, cfg.d_model)
                                                 ).astype(np.float32)
    rd = cfg.mla.qk_rope_head_dim
    jp = jax.tree.map(jnp.asarray, _layer0(mla["np_tree"]["groups"][0]
                                           ["mixer"]))
    cos, sin = j_rope_table(S, rd, cfg.rope_theta)
    want = JA.mla_forward(cfg, jp, jnp.asarray(x), cos, sin, perf=J_TINY)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    tcos, tsin = t_rope_table(S, rd, tcfg.rope_theta)
    got = TA.mla_forward(tcfg, tp, torch.from_numpy(x), tcos, tsin)
    close(got, want)


def test_mla_decode_matches_jax(mla):
    """One decode step against a filled latent cache at ragged lengths
    (an empty slot, S_max - 1, and between), S_max past one block of the
    reference's blocked softmax (whose tail neither attends); the out and
    the written cache."""
    cfg, tcfg = mla["cfg"], mla["tcfg"]
    rng = np.random.default_rng(5)
    nb, s_max = 4, 2048 + 40
    m = cfg.mla
    x = rng.standard_normal((nb, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((nb, s_max, m.kv_lora_rank)).astype(np.float32)
    krope = rng.standard_normal((nb, s_max, m.qk_rope_head_dim)
                                ).astype(np.float32)
    lengths = np.array([0, s_max - 1, 700, 2047], np.int32)
    jp = jax.tree.map(jnp.asarray, _layer0(mla["np_tree"]["groups"][0]
                                           ["mixer"]))
    want, wcache = JA.mla_decode(
        cfg, jp, jnp.asarray(x), {"ckv": jnp.asarray(ckv),
                                  "krope": jnp.asarray(krope)},
        jnp.asarray(lengths))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    cache = {"ckv": torch.from_numpy(ckv.copy()),
             "krope": torch.from_numpy(krope.copy())}
    got = TA.mla_decode(tcfg, tp, torch.from_numpy(x), cache,
                        torch.from_numpy(lengths))
    close(got, want)
    for k in ("ckv", "krope"):
        close(cache[k], wcache[k])


def test_forward_matches_jax(mla):
    tcfg, tparams = mla["tcfg"], mla["tparams"]
    got, aux = TM.forward(tcfg, tparams,
                          {"tokens": torch.from_numpy(mla["batch"]["tokens"])},
                          perf=T_TINY)
    close(got, mla["logits"])
    assert np.array_equal(got.argmax(-1).numpy(), mla["logits"].argmax(-1))
    assert abs(float(aux) - mla["aux"]) <= 2e-5 * (1 + abs(mla["aux"]))
    assert mla["aux"] > 0


def test_loss_and_grads_match_jax(mla):
    tcfg = mla["tcfg"]
    tparams = tree_map(lambda t: t.clone().requires_grad_(), mla["tparams"])
    batch = {k: torch.from_numpy(v) for k, v in mla["batch"].items()}
    loss, _ = TM.loss_fn(tcfg, tparams, batch, perf=T_TINY)
    loss.backward()
    assert abs(loss.item() - mla["loss"]) <= 2e-5 * (1 + abs(mla["loss"]))
    paths = jax.tree_util.tree_leaves_with_path(mla["grads"])
    assert len(paths) == len(tree_flatten(tparams)[0])
    for path, g in paths:
        leaf = _path_get(tparams, path)
        assert leaf.grad is not None, path
        close(leaf.grad, g)


def test_decode_steps_match_jax(mla):
    tcfg, tparams = mla["tcfg"], mla["tparams"]
    state = TM.decode_state(tcfg, B, S_MAX, device="cpu")
    for tok, lengths, want in mla["steps"]:
        got, state = TM.decode_step(tcfg, tparams, state,
                                    torch.from_numpy(tok),
                                    torch.from_numpy(lengths), perf=T_TINY)
        close(got, want)
        assert np.array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    for jpos, tpos in zip(mla["jstate"], state):
        assert set(jpos) == set(tpos) == {"ckv", "krope"}
        for k in jpos:
            close(tpos[k], jpos[k])


# -------------------------------------------------------------- the engine


@pytest.fixture(scope="module")
def engine_runs(mla):
    """The engine tests' sessions on both engines in inkernel mode: (report,
    token streams) of the JAX engine and of the port's."""
    runs = []
    for E, Cfg, model, Sx, Dx, dev in (
            (JEngine, JEngineConfig, (mla["cfg"], mla["params"]), JS, JD, {}),
            (TEngine, TEngineConfig, (mla["tcfg"], mla["tparams"]), TS, TD,
             {"device": "cpu"})):
        eng = E(*model, ecfg=Cfg(**COMMON, **MODES["inkernel"]), seed=0,
                **dev)
        sess = sessions(Sx, Dx)
        for s in sess:
            eng.submit(s)
        eng.run(6000)
        runs.append((eng.report(), [s.out_tokens for s in sess]))
    return runs


def test_report_field_identical(engine_runs):
    (jreport, jstreams), (treport, tstreams) = engine_runs
    assert treport == jreport
    assert treport["completed"] == 3
    assert treport["freezes"] >= 1 and treport["thaws"] >= 1
    assert tstreams == jstreams


def _slot_leaves(state, slot):
    return [t[:, slot].clone() for pos in state for t in pos.values()]


def test_gated_merge_keeps_denied_latent_rows(mla):
    """A step whose gate denies slot 0 and grants slot 1: every latent
    leaf of slot 0 is bit-identical after it (its ``ckv``/``krope`` row
    at its length was written by the decode and put back), while slot 1
    gained its row.  The merge shapes the gate to each leaf's rank: a
    latent row is (group, slot, L), not a (group, slot, Hkv, hd) k/v
    row."""
    tcfg, tparams = mla["tcfg"], mla["tparams"]
    eng = TEngine(tcfg, tparams, ecfg=TEngineConfig(**COMMON), seed=0,
                  device="cpu")
    for s in sessions(TS, TD)[:2]:
        eng.submit(s)
    for _ in range(6):
        eng.step()
    state = eng.caches.state
    dom = torch.tensor([eng.sessions[sid].dom_idx for sid in
                        eng.slot_session[:2]] + [-1, -1], dtype=torch.int32)
    lengths = torch.tensor([eng.sessions[sid].length for sid in
                            eng.slot_session[:2]] + [0, 0], dtype=torch.int32)
    before = [_slot_leaves(state, b) for b in (0, 1)]
    nxt, _, granted, _ = eng._device_step(
        torch.tensor([3, 5, 0, 0], dtype=torch.int32), lengths, dom,
        torch.zeros(4, dtype=torch.int32),
        torch.tensor([False, True, False, False]), inkernel=False)
    assert granted.tolist() == [False, True, False, False]
    assert int(nxt[0]) == 3
    for a, b in zip(before[0], _slot_leaves(state, 0)):
        assert torch.equal(a, b)
    row = int(lengths[1])
    for a, b in zip(before[1], _slot_leaves(state, 1)):
        assert not torch.equal(a[:, row], b[:, row])
        assert torch.equal(a[:, :row], b[:, :row])


def test_freeze_thaw_gives_latent_rows_back(mla):
    """A slot's latent caches, filled from a seeded draw, come back
    bit-identical in the slot a thaw picks; the frozen slot is zeroed."""
    caches = SlotCaches(mla["tcfg"], 3, 32, "cpu")
    g = torch.Generator().manual_seed(0)
    for pos in caches.state:
        for t in pos.values():
            t.copy_(torch.randn(t.shape, generator=g))
    assert [caches.alloc_slot() for _ in range(3)] == [0, 1, 2]
    want = _slot_leaves(caches.state, 1)
    caches.free_slot(0)
    caches.freeze_slot("s", 1, pages=2)
    assert all(not t.any() for t in _slot_leaves(caches.state, 1))
    slot, _ = caches.thaw_slot("s")
    assert slot == 0
    for a, b in zip(want, _slot_leaves(caches.state, slot)):
        assert torch.equal(a, b)


# ------------------------------------------------------ flash at 192 / 128


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_at_mla_widths(causal):
    """The plain flash forward (the CPU path and the card's yardstick) at
    dk 192 / dv 128, G 1 and G 4, against the JAX Pallas kernel in
    interpret mode (S 128: its blocks must divide S) and its own naive
    oracle; its backward against autograd through the naive oracle,
    f32."""
    rng = np.random.default_rng(192)
    n = 128
    for H, hkv in ((2, 2), (4, 1)):
        q = rng.standard_normal((1, n, H, 192)).astype(np.float32)
        k = rng.standard_normal((1, n, hkv, 192)).astype(np.float32)
        v = rng.standard_normal((1, n, hkv, 128)).astype(np.float32)
        want = np.asarray(flash_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            block_q=64, block_k=64, interpret=True))
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        out, lse = TR.flash_fwd(tq, tk, tv, causal=causal)
        assert out.shape == (1, n, H, 128) and lse.shape == (1, H, n)
        close(out, want)
        naive = TR.attention_naive(tq, tk, tv, causal=causal)
        close(out, naive.detach().numpy())
        do = torch.from_numpy(rng.standard_normal(out.shape).astype(
            np.float32))
        grads = TR.flash_bwd(tq.detach(), tk.detach(), tv.detach(),
                             out.detach(), lse, do, causal=causal)
        wants = torch.autograd.grad(naive, (tq, tk, tv), do)
        for g, w in zip(grads, wants):
            close(g, w.numpy())


@pytest.mark.parametrize("dk,dv", [(192, 128), (160, 160)])
@pytest.mark.parametrize("G", [1, 4])
def test_bf16_kernel_rounding_within_bar(dk, dv, G):
    """The paired backward keeps the kernels' roundings (p^T handed over
    in f32, P and dS split into bf16 hi + lo): emulated at MLA's and
    pixtral's widths, causal at S 273, they hold the card's bf16 bar
    against the plain versions."""
    got, want = _emulated_vs_plain(273, 2 * G, 2, dk, True, seed=dk + G,
                                   dv=dv)
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        ratio, rel = _bar_ratio(a, b)
        assert ratio <= 1.0 and rel <= 1e-2, (name, ratio, rel)
