"""Counted costs and peak memory of one call on tensors that hold no data
(the port's counterpart of ``repro/analysis/hlo.py::analyze`` and of the
reference dry run's ``compiled.memory_analysis()``).

The reference reads a step's costs out of its optimized HLO, and must
correct for ``cost_analysis`` counting a ``while`` body once.  The port
runs the step itself on meta tensors and counts what it dispatches:
``CostCounter`` is a ``TorchDispatchMode``, so it sees every aten op of
the call (the forward, the autograd backward, the recompute under remat,
the optimizer) as often as it runs, and there is no trip count to
correct.  The hand-written kernels are no aten ops: each wrapper gives
its call and its ``cost(...)`` to the active counter instead
(``kernels/fake.py``).  What is counted:

  flops   the products, by ``torch.utils.flop_counter``'s formulas (mm,
          addmm, bmm, baddbmm, convolution, the library's attention),
          plus each kernel's recorded operations;
  bytes   every op that is not a view reads its tensor inputs and writes
          its outputs once (a bare allocation or ``_unsafe_view`` moves
          nothing), but an op that touches a slice of a large operand
          counts the slice, as ``hlo.py``'s ``_SLICED_READS`` and
          ``_SLICED_WRITES`` do: a gather its result twice (read and
          written), an in-place scatter its update twice; plus each
          kernel's recorded bytes;
  coll_bytes_total, coll_dcn_bytes
          0: one card, no collective;
  kernels each kernel's calls (``launches``), operations and bytes.

``flops_by_op`` and ``bytes_by_op`` split the totals by aten op and
kernel.

Only work on the traced device counts (``device``, the meta device of a
dry run): an op whose tensors all lie elsewhere, as the learning-rate
schedule's host scalars do, is not the card's.

Peak live bytes: each storage on the traced device counts once, from
the op that first shows it until it is freed, rounded up to 512 bytes as
the CUDA caching allocator rounds a block, so the peak is the counterpart
of ``torch.cuda.max_memory_allocated``.  ``tag`` names the storages of a
tree (params, optimizer, state); the peak is split by tag at the moment
it is reached, the untagged remainder under ``rest``.
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import fake

BLOCK = 512                     # the CUDA caching allocator's rounding
TAGS = ("params", "optimizer", "state", "rest")
aten = torch.ops.aten
# no traffic: bare allocations, and a view whose schema does not say so
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default,
               aten.empty_like.default, aten.new_empty.default,
               aten.new_empty_strided.default, aten._unsafe_view.default}
# gathers read only the rows they return
_GATHERS = {aten.index.Tensor, aten.index_select.default,
            aten.gather.default, aten.embedding.default}
# in-place scatters write only their update: its position among the args
_SCATTERS = {aten.index_put_.default: 2, aten._index_put_impl_.default: 2,
             aten.scatter_.src: 3, aten.scatter_add_.default: 3,
             aten.index_add_.default: 3, aten.index_copy_.default: 3}


def block_bytes(n: int) -> int:
    """``n`` bytes as the caching allocator hands them out."""
    return -(-n // BLOCK) * BLOCK


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts the costs and the live device memory of what runs inside
    it (``with CostCounter() as cc: ...``) on ``device`` (a device type),
    kernels included; ``reset`` starts the costs and the peak again from
    what is live, and ``result`` gives them."""

    def __init__(self, device: str = "meta"):
        super().__init__()
        self.device = device
        self._tokens: list = []              # the mode re-enters itself
        self.flops = 0.0
        self.bytes = 0.0
        self.flops_by_op: dict = defaultdict(float)
        self.bytes_by_op: dict = defaultdict(float)
        self.kernels: dict = {}
        self._live: dict = {}                # id(storage) -> [bytes, tag]
        self.by_tag = dict.fromkeys(TAGS, 0)
        self.peak = 0
        self.peak_by_tag = dict(self.by_tag)

    # ------------------------------------------------------ the mode

    def __enter__(self):
        self._tokens.append(fake.set_recorder(self.kernel))
        return super().__enter__()

    def __exit__(self, *exc):
        fake.reset_recorder(self._tokens.pop())
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # a composite op (matmul, einsum) reaches the mode whole where
        # autograd is off (inference mode): count the ops it runs as
        with self:
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        ins = _tensors((args, kwargs))
        out = func(*args, **kwargs)
        outs = _tensors(out)
        mine = [t for t in ins + outs if t.device.type == self.device]
        if not mine:
            return out
        for t in mine:
            self._track(t)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            n = formula(*args, **kwargs, out_val=out)
            self.flops += n
            self.flops_by_op[func.overloadpacket.__name__] += n
        if func in _GATHERS:
            n = 2 * sum(map(_nbytes, outs))
        elif func in _SCATTERS:
            n = 2 * _nbytes(args[_SCATTERS[func]])
        elif not func.is_view and func not in _NO_TRAFFIC:
            n = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        else:
            n = 0
        self.bytes += n
        self.bytes_by_op[func.overloadpacket.__name__] += n
        return out

    def kernel(self, name: str, cost: dict) -> None:
        """One call of a hand-written kernel (``kernels/fake.py``)."""
        k = self.kernels.setdefault(name, {"launches": 0, "ops": 0.0,
                                           "bytes": 0.0})
        k["launches"] += 1
        k["ops"] += cost["ops"]
        k["bytes"] += cost["bytes"]
        self.flops += cost["ops"]
        self.bytes += cost["bytes"]
        self.flops_by_op[name] += cost["ops"]
        self.bytes_by_op[name] += cost["bytes"]

    # ----------------------------------------------------- memory

    def _track(self, t: torch.Tensor) -> list:
        st = t.untyped_storage()
        key = id(st)
        ent = self._live.get(key)
        size = block_bytes(st.nbytes())
        if ent is None:
            ent = self._live[key] = [size, "rest"]
            weakref.finalize(st, self._free, key)
            self._add("rest", size)
        elif ent[0] != size:                 # resized in place
            self._add(ent[1], size - ent[0])
            ent[0] = size
        return ent

    def _add(self, tag: str, n: int) -> None:
        self.by_tag[tag] += n
        live = sum(self.by_tag.values())
        if live > self.peak:
            self.peak = live
            self.peak_by_tag = dict(self.by_tag)

    def _free(self, key: int) -> None:
        size, tag = self._live.pop(key)
        self.by_tag[tag] -= size

    def tag(self, tree, tag: str) -> None:
        """Count the storages of every tensor in ``tree`` under ``tag``
        from now on."""
        for t in _tensors(tree):
            ent = self._track(t)
            self.by_tag[ent[1]] -= ent[0]
            self.by_tag[tag] += ent[0]
            ent[1] = tag

    @property
    def live(self) -> int:
        return sum(self.by_tag.values())

    def reset(self) -> None:
        """Zero the costs; the peak starts again from what is live."""
        self.flops = self.bytes = 0.0
        self.flops_by_op.clear()
        self.bytes_by_op.clear()
        self.kernels = {}
        self.peak = self.live
        self.peak_by_tag = dict(self.by_tag)

    def result(self) -> dict:
        """The counted costs under ``analyze``'s keys, the kernels, and
        the peak live bytes split by tag."""
        return {"flops": self.flops, "bytes": self.bytes,
                "coll_bytes": {}, "coll_bytes_total": 0.0,
                "coll_dcn_bytes": 0.0, "coll_count": 0,
                "flops_by_op": dict(self.flops_by_op),
                "bytes_by_op": dict(sorted(self.bytes_by_op.items(),
                                           key=lambda kv: -kv[1])),
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "peak_bytes": self.peak,
                "peak_by_tag": dict(self.peak_by_tag)}
