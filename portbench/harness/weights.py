"""The cell's weights, drawn on the device from the seed in a few large
calls, in the dtype they are served in.

The tree follows the program's parameter schema (each leaf's shape,
initialiser kind and whether it stays float32), so the program takes it
as it is; the values are the benchmark's own.  The normal leaves of one
dtype share one buffer, filled by ``normal_`` in chunks of at most
``CHUNK`` values, then scaled leaf by leaf: std ``init.normal`` for the
schema's "normal" leaves and ``init.small`` for its "small" ones, unless
the configuration's ``init.leaves`` names a leaf with its own ``std``
(and ``mean``).
"""
from __future__ import annotations

import math

import torch

CHUNK = 1 << 30

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _walk(tree, path=()):
    """(path, leaf) of every schema leaf, depth first in key order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(v) for v in tree]
    return None


def make_params(leaves: dict, init: dict, dtype: str, seed: int,
                device) -> dict:
    """``leaves``: the schema, a tree of objects with ``shape``, ``init``
    (normal, small, zeros, ones) and ``f32``; ``init``: the
    configuration's scales.  Returns the tree of tensors."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = _skeleton(leaves)
    own_scales = init.get("leaves", {})
    drawn: dict = {}
    for path, leaf in _walk(leaves):
        dt = torch.float32 if leaf.f32 else _DTYPES[dtype]
        if leaf.init in ("zeros", "ones") and path[-1] not in own_scales:
            fill = torch.zeros if leaf.init == "zeros" else torch.ones
            _put(out, path, fill(leaf.shape, dtype=dt, device=device))
        else:
            drawn.setdefault(dt, []).append((path, leaf))
    for dt, items in drawn.items():
        sizes = [math.prod(leaf.shape) for _, leaf in items]
        buf = torch.empty(sum(sizes), dtype=dt, device=device)
        for c0 in range(0, buf.numel(), CHUNK):
            buf[c0:c0 + CHUNK].normal_(generator=gen)
        off = 0
        for (path, leaf), n in zip(items, sizes):
            own = own_scales.get(path[-1], {})
            std = own.get("std", init["small"] if leaf.init == "small"
                          else init["normal"])
            t = buf[off:off + n].view(leaf.shape)
            t.mul_(std)
            if own.get("mean"):
                t.add_(own["mean"])
            _put(out, path, t)
            off += n
    return out
