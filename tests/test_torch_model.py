"""The port's dense decode step against the JAX package on the reduced
f32 ``llama3.2-3b`` of ``tests/conftest.py``: the JAX weights carried
over with ``params_from_jax``, then one and several ``decode_step``s on
the same tokens.  Logits agree within atol 1e-4 (XLA and torch sum the
matrix products in different orders) and the argmax is identical."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.models import model as JM
from repro.models.schema import tree_map_schema
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.models import model as TM

B, S_MAX = 3, 48


@pytest.fixture(scope="module")
def pair(tiny_llama):
    cfg, params = tiny_llama
    tcfg = dataclasses.replace(t_reduced(t_get_config("llama3.2-3b")),
                               dtype="float32")
    np_tree = jax.tree.map(np.asarray, params)
    return cfg, params, tcfg, TM.params_from_jax(np_tree, tcfg, device="cpu")


def test_configs_agree(pair):
    cfg, _, tcfg, _ = pair
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(cfg, f.name), f.name
    assert tcfg.padded_vocab == cfg.padded_vocab
    assert tcfg.head_dim_ == cfg.head_dim_


def test_params_layout(pair):
    cfg, params, _, tparams = pair
    flat_j = jax.tree_util.tree_leaves_with_path(params)
    for path, leaf in flat_j:
        node = tparams
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        assert tuple(node.shape) == leaf.shape
        assert np.array_equal(node.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("n_steps", [1, 6])
def test_decode_steps_match(pair, n_steps):
    cfg, params, tcfg, tparams = pair
    rng = np.random.default_rng(n_steps)
    jstate = tree_map_schema(
        lambda l: jnp.zeros(l.shape, jnp.dtype(l.dtype or cfg.dtype)),
        JM.decode_state_schema(cfg, B, S_MAX))
    tstate = TM.decode_state(tcfg, B, S_MAX, device="cpu")
    lengths = np.array([0, 5, 17], np.int32)
    step = jax.jit(lambda p, s, t, l: JM.decode_step(cfg, p, s, t, l))
    for _ in range(n_steps):
        tokens = rng.integers(0, cfg.vocab, B).astype(np.int32)
        want, jstate = step(params, jstate, jnp.asarray(tokens),
                            jnp.asarray(lengths))
        got, tstate = TM.decode_step(tcfg, tparams, tstate,
                                     torch.from_numpy(tokens),
                                     torch.from_numpy(lengths))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        assert np.array_equal(got.argmax(-1).numpy(),
                              np.asarray(want).argmax(-1))
        lengths = lengths + 1
    for jpos, tpos in zip(jstate, tstate):
        for k in ("k", "v"):
            np.testing.assert_allclose(tpos[k].numpy(), np.asarray(jpos[k]),
                                       atol=1e-5)


def test_init_params_is_seeded_and_shaped(pair):
    _, _, tcfg, tparams = pair
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = TM.init_params(tcfg, g1, device="cpu")
    b = TM.init_params(tcfg, g2, device="cpu")
    assert torch.equal(a["embed"]["tok"], b["embed"]["tok"])
    assert a["embed"]["tok"].shape == tparams["embed"]["tok"].shape
    assert a["groups"][0]["mixer"]["wq"].shape == \
        tparams["groups"][0]["mixer"]["wq"].shape
