"""The published DeepSeek-V2 configuration in the port's schema: the
benchmark's ``portbench/configs/deepseek-v2-236b.json`` built as it is by
the harness's ``model_config`` (its ``moe`` and ``mla`` sections given as
mappings, the YaRN section inside ``mla``), every value landing on the
config the model runs, the file's published keys agreeing with the
port's, and the new router, share, YaRN and leading-dense settings at
their defaults giving the JAX package's fields and behaviour."""
import dataclasses
import json
from pathlib import Path

import pytest
torch = pytest.importorskip("torch")

from portbench.harness import bench  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import (MLAConfig, ModelConfig,  # noqa: E402
                                      MoEConfig, YarnConfig)
from repro_torch.models import model as M  # noqa: E402

FILE = (Path(__file__).resolve().parents[1] / "portbench" / "configs"
        / "deepseek-v2-236b.json")
# the JAX package's fields of the two sections, which the init-only
# settings leave as they are
MOE_FIELDS = ["n_experts", "top_k", "d_ff_expert", "n_shared", "period",
              "aux_coef", "router_dtype"]
MLA_FIELDS = ["kv_lora_rank", "q_lora_rank", "qk_nope_head_dim",
              "qk_rope_head_dim", "v_head_dim"]


@pytest.fixture(scope="module")
def published():
    raw = FILE.read_text()
    cfg = json.loads(raw)
    mcfg = bench.model_config(bench.program(), cfg)
    assert FILE.read_text() == raw
    return cfg, mcfg


def test_the_harness_builds_the_file_unchanged(published):
    cfg, m = published
    assert isinstance(m, ModelConfig)
    assert isinstance(m.moe, MoEConfig) and isinstance(m.mla, MLAConfig)
    for k in ("n_layers", "d_model", "n_heads", "d_ff", "vocab",
              "rope_theta", "norm_eps", "dtype", "group_size"):
        assert getattr(m, k) == cfg[k], k
    for k, v in cfg["moe"].items():
        assert getattr(m.moe, k) == v, k
    for k, v in cfg["mla"].items():
        if k != "rope_scaling":
            assert getattr(m.mla, k) == v, k
    assert m.mla.rope_scaling == YarnConfig(**cfg["mla"]["rope_scaling"])
    assert m.first_dense == 1 and m.n_groups == 29


def test_the_published_keys_agree_with_the_ports(published):
    """The catalog's keys (the published config.json, the two cut ones
    as held here) say what the port's keys say."""
    cfg, m = published
    pairs = {"hidden_size": m.d_model, "num_attention_heads": m.n_heads,
             "num_key_value_heads": m.n_kv_heads,
             "intermediate_size": m.d_ff, "vocab_size": m.vocab,
             "num_hidden_layers": m.n_layers, "rms_norm_eps": m.norm_eps,
             "rope_theta": m.rope_theta,
             "tie_word_embeddings": m.tie_embeddings,
             "first_k_dense_replace": m.moe.first_dense,
             "moe_intermediate_size": m.moe.d_ff_expert,
             "moe_layer_freq": m.moe.period,
             "n_routed_experts": m.moe.n_experts,
             "n_shared_experts": m.moe.n_shared,
             "num_experts_per_tok": m.moe.top_k, "n_group": m.moe.n_group,
             "topk_group": m.moe.topk_group,
             "routed_scaling_factor": m.moe.routed_scale,
             "norm_topk_prob": m.moe.norm_topk}
    for k in MLA_FIELDS:
        pairs[k] = getattr(m.mla, k)
    for k, v in pairs.items():
        assert cfg[k] == v, k
    assert cfg["rope_scaling"] == cfg["mla"]["rope_scaling"]
    assert cfg["topk_method"] == "group_limited_greedy"
    assert cfg["scoring_func"] == "softmax"
    # the router ranks the published 160; this card holds group 0's 20
    assert m.moe.router_width == cfg["reduced"]["n_routed_experts"] == 160
    assert m.moe.router_width // m.moe.n_group == m.moe.n_experts
    assert m.moe.first_expert == 0


def test_sections_given_as_mappings_equal_the_dataclasses(published):
    cfg, m = published
    built = dataclasses.replace(
        m, moe=MoEConfig(**cfg["moe"]), mla=MLAConfig(**cfg["mla"]))
    assert built == m
    assert ModelConfig(name="x", family="moe", n_layers=2, d_model=8,
                       n_heads=2, n_kv_heads=2, d_ff=16, vocab=16,
                       ssm={"d_state": 4}).ssm.d_state == 4


def test_new_settings_default_to_the_jax_packages_behaviour():
    moe = MoEConfig(n_experts=4, top_k=2, d_ff_expert=8)
    assert [f.name for f in dataclasses.fields(MoEConfig)] == MOE_FIELDS
    assert [f.name for f in dataclasses.fields(MLAConfig)] == MLA_FIELDS
    assert (moe.router_width, moe.first_expert, moe.n_group, moe.topk_group,
            moe.routed_scale, moe.norm_topk, moe.first_dense) == \
        (4, 0, 1, 1, 1.0, True, 0)
    # a twin cut to fewer experts ranks all of its own
    assert dataclasses.replace(moe, n_experts=2).router_width == 2
    pub = MoEConfig(n_experts=20, top_k=6, d_ff_expert=8, n_routed=160,
                    n_group=8, topk_group=3, routed_scale=16.0,
                    norm_topk=False, first_dense=1)
    kept = dataclasses.replace(pub, d_ff_expert=16)
    assert (kept.router_width, kept.n_group, kept.routed_scale,
            kept.norm_topk, kept.first_dense) == (160, 8, 16.0, False, 1)
    assert MLAConfig().rope_scaling is None
    twin = get_config("deepseek-v2-236b")
    assert twin.first_dense == 0 and twin.n_groups == 60
    assert twin.moe.router_width == 160 and twin.mla.rope_scaling is None
    assert "lead" not in M.param_leaves(twin)
    assert M.state_kinds(twin) == twin.layer_kinds()


def test_the_leading_dense_layer_has_its_own_leaves_and_state(published):
    _, m = published
    leaves = M.param_leaves(m)
    assert leaves["lead"]["ffn"]["w_gate"].shape == (1, 5120, 12288)
    assert leaves["lead"]["mixer"]["w_dkv"].shape == (1, 5120, 576)
    assert leaves["groups"][0]["ffn"]["router"].shape == (29, 5120, 160)
    assert leaves["groups"][0]["ffn"]["wg"].shape == (29, 20, 5120, 1536)
    assert M.state_kinds(m) == ["attn", "attn"]
    state = M.decode_state(m, 2, 16, device="cpu")
    assert [tuple(s["ckv"].shape) for s in state] == [(29, 2, 16, 512),
                                                      (1, 2, 16, 512)]


@pytest.mark.parametrize("bad", [
    {"first_expert": 150},                  # experts 150-169 of 160
    {"n_group": 7},                         # 160 experts in 7 groups
    {"topk_group": 9}])
def test_a_share_or_grouping_the_router_cannot_hold_is_refused(bad):
    kw = {"n_routed": 160, "n_group": 8, "topk_group": 3, **bad}
    with pytest.raises(ValueError):
        MoEConfig(n_experts=20, top_k=6, d_ff_expert=8, **kw)


def _tiny_published():
    """The published form at d 32: a leading dense layer, 8 groups of
    2 held experts of 16, YaRN."""
    cfg = json.loads(FILE.read_text())
    cfg.update(n_layers=3, d_model=32, n_heads=2, n_kv_heads=2,
               head_dim=16, d_ff=64, vocab=300, dtype="float32")
    cfg["moe"] = dict(cfg["moe"], n_experts=2, n_routed=16, d_ff_expert=16,
                      top_k=4, first_expert=2)
    cfg["mla"] = dict(cfg["mla"], kv_lora_rank=8, q_lora_rank=16,
                      qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8)
    return bench.model_config(bench.program(), cfg)


def test_the_engine_carries_the_leading_layers_latent_rows():
    """The gated merge keeps a denied slot's latent rows of every layer,
    the leading dense one's included, bit for bit, and writes the
    granted slot's row; a freeze and a thaw give every row back."""
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.session import Phase, Session
    cfg = _tiny_published()
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    eng = Engine(cfg, params, ecfg=EngineConfig(max_slots=4, s_max=32,
                                                pool_pages=64),
                 seed=0, device="cpu")
    for i in range(2):
        eng.submit(Session(sid=f"s{i}", tenant="t", priority=1,
                           prompt=[3 + i] * 6, phases=[Phase(4, 0, "x")]))
    for _ in range(4):
        eng.step()
    state = eng.caches.state
    assert len(state) == 2 and state[-1]["ckv"].shape[0] == 1
    slots = [eng.sessions[f"s{i}"].slot for i in range(2)]
    before = [[t[:, s].clone() for pos in state for t in pos.values()]
              for s in slots]
    lengths = torch.zeros(4, dtype=torch.int32)
    for i, s in enumerate(slots):
        lengths[s] = eng.sessions[f"s{i}"].length
    dom = torch.full((4,), -1, dtype=torch.int32)
    dom[slots[0]], dom[slots[1]] = (eng.sessions["s0"].dom_idx,
                                    eng.sessions["s1"].dom_idx)
    gate = torch.zeros(4, dtype=torch.bool)
    gate[slots[1]] = True
    eng._device_step(torch.arange(4, dtype=torch.int32), lengths, dom,
                     torch.zeros(4, dtype=torch.int32), gate, False)
    after = [[t[:, s] for pos in state for t in pos.values()] for s in slots]
    assert all(torch.equal(a, b) for a, b in zip(before[0], after[0]))
    row = int(lengths[slots[1]])
    for a, b in zip(before[1], after[1]):
        assert not torch.equal(a[:, row], b[:, row])
        assert torch.equal(a[:, :row], b[:, :row])
    want = [t[:, slots[1]].clone() for pos in state for t in pos.values()]
    eng.caches.freeze_slot("x", slots[1], pages=1)
    slot, _ = eng.caches.thaw_slot("x")
    got = [t[:, slot] for pos in state for t in pos.values()]
    assert all(torch.equal(a, b) for a, b in zip(want, got))
