"""The port's MoE FFN against the JAX package on the reduced f32
``jamba-v0.1-52b`` (4 experts, top 2, d_ff_expert 128): the router, the
load-balance loss, the capacity-gather dispatch (generous capacity, the
default 1.25, and 0.5, which drops assignments) and the token-blocked
dense dispatch, on the same weights and inputs.  Outputs within 1e-5
(XLA and torch sum the products in different orders); routing ids,
keep masks and the kept count exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import moe as JMoE
from repro.models.schema import init_params
from repro.perf import DEFAULT_PERF as J_PERF
from repro.perf import replace as j_perf
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.models import moe as TMoE
from repro_torch.perf import DEFAULT_PERF as T_PERF
from repro_torch.perf import replace as t_perf

T_TOKENS = 48


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(reduced(get_config("jamba-v0.1-52b")),
                              dtype="float32")
    tcfg = dataclasses.replace(t_reduced(t_get_config("jamba-v0.1-52b")),
                               dtype="float32")
    p = init_params(JMoE.moe_schema(cfg), jax.random.PRNGKey(0), cfg.dtype)
    # routers of std 0.02 give near-uniform probabilities; a wider router
    # makes the routing, and so the drops, depend on the logits
    p = dict(p, router=p["router"] * 50)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    x = np.random.default_rng(0).standard_normal(
        (T_TOKENS, cfg.d_model)).astype(np.float32)
    return cfg, tcfg, p, tp, x


def test_configs_agree(setup):
    cfg, tcfg, *_ = setup
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert tcfg.layer_kinds() == cfg.layer_kinds()
    assert tcfg.ffn_kinds() == cfg.ffn_kinds()
    assert tcfg.param_count() == cfg.param_count()


def test_router_and_aux_loss(setup):
    cfg, tcfg, p, tp, x = setup
    probs, ids, gates = JMoE._router(cfg, p, jnp.asarray(x))
    tprobs, tids, tgates = TMoE._router(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(probs), atol=1e-6)
    assert np.array_equal(tids.numpy(), np.asarray(ids))
    np.testing.assert_allclose(tgates.numpy(), np.asarray(gates), atol=1e-6)
    aux = JMoE._aux_loss(cfg, probs, ids)
    taux = TMoE._aux_loss(tcfg, tprobs, tids)
    assert abs(float(taux) - float(aux)) <= 1e-7


def test_router_breaks_ties_toward_the_lower_index(setup):
    """Equal router logits: ``lax.top_k`` picks the lower expert ids."""
    cfg, tcfg, p, tp, _ = setup
    x = np.zeros((3, cfg.d_model), np.float32)
    _, ids, _ = JMoE._router(cfg, p, jnp.asarray(x))
    _, tids, _ = TMoE._router(tcfg, tp, torch.from_numpy(x))
    assert np.array_equal(tids.numpy(), np.asarray(ids))
    assert np.array_equal(tids.numpy(), [[0, 1]] * 3)


@pytest.mark.parametrize("cf", [8.0, 1.25, 0.5])
def test_gather_dispatch(setup, cf):
    cfg, tcfg, p, tp, x = setup
    _, ids, gates = JMoE._router(cfg, p, jnp.asarray(x))
    want = JMoE._gather_dispatch(cfg, p, jnp.asarray(x), ids, gates,
                                 capacity_factor=cf)
    TMoE.drop_log = []
    try:
        got = TMoE._gather_dispatch(tcfg, tp, torch.from_numpy(x),
                                    torch.from_numpy(np.array(ids)),
                                    torch.from_numpy(np.array(gates)),
                                    capacity_factor=cf)
        drops = int(TMoE.drop_log[0])
    finally:
        TMoE.drop_log = None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the drops are the reference's: assignments past an expert's first
    # ``cap`` in token order
    cap = TMoE.capacity(tcfg, T_TOKENS, cf)
    counts = np.bincount(np.asarray(ids).reshape(-1), minlength=4)
    assert drops == int(np.maximum(counts - cap, 0).sum())
    if cf == 0.5:
        assert drops > 0


def test_dense_dispatch_and_forward(setup):
    cfg, tcfg, p, tp, x = setup
    xb = x.reshape(2, T_TOKENS // 2, -1)
    for impl in ("dense", "a2a"):
        want, aux = JMoE.moe_forward(cfg, p, jnp.asarray(xb),
                                     perf=j_perf(J_PERF, moe_impl=impl))
        got, taux = TMoE.moe_forward(tcfg, tp, torch.from_numpy(xb),
                                     perf=t_perf(T_PERF, moe_impl=impl))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        assert abs(float(taux) - float(aux)) <= 1e-7
    _, ids, gates = JMoE._router(cfg, p, jnp.asarray(x))
    want = JMoE._dense_dispatch(cfg, p, jnp.asarray(x), ids, gates,
                                token_block=16)
    got = TMoE._dense_dispatch(tcfg, tp, torch.from_numpy(x),
                               torch.from_numpy(np.array(ids)),
                               torch.from_numpy(np.array(gates)),
                               token_block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
