"""What one step of a program does on one device, counted while it runs
(under ``FakeTensorMode`` on a fake world, or for real): the dry run's
counterpart of XLA's cost and memory analyses.

``TraceCounts`` is a ``TorchDispatchMode``. It sees the local ops (a
DTensor op passes on to DTensor's own dispatch, whose local ops and
collectives come back to it) and counts, for the rank it runs on:

* ``flops``: the aten ops' FLOPs by ``torch.utils.flop_counter``'s formulas
  (FlopCounterMode's registry: the products and attention ops), plus what
  the kernels' trace route adds (``add_kernel``, ``kernels/trace.py``);
* ``bytes``: every op's input and output bytes, each tensor once an op,
  views and allocations counted as zero: eager traffic with no fusion,
  which is what the port does on the card; plus the kernels' bytes;
* ``collectives``: every functional collective (``perf/collectives.py``);
* memory: each storage the step allocates, from its allocation to its
  release, beside the inputs ``track`` registered (params, optimizer
  state, the batch or cache). The peak's bytes come out by category:
  ``params``, ``optimizer``, ``inputs``, ``grads`` (storages ``mark``ed as
  such: the gradients a ``loss_and_grads`` returns), ``activations``
  (storages autograd packs for the backward) and ``temporaries`` (the
  rest). A storage's category is its last one, read after the step.

DTensor works out an op's output shape by running the op on global-shaped
fake tensors (``ShardingPropagator._propagate_tensor_meta_non_cached``);
those runs are not the step's and are not counted.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode, is_traceable_wrapper_subclass_type
from torch.utils.flop_counter import flop_registry

from . import collectives as _coll

aten = torch.ops.aten

#: ops that move no bytes of their own: allocations and aliases
_NO_TRAFFIC = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
               aten.new_empty_strided, aten.detach, aten.alias, aten.lift_fresh,
               aten._local_scalar_dense, aten.set_}

#: products whose flop formulas take their tensor arguments alone
_PRODUCTS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm}

_ACTIVE: list = []


def active():
    """The innermost ``TraceCounts`` running, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def add_kernel(name: str, flops: float, nbytes: float) -> None:
    """Add one kernel call's FLOPs and bytes (the bound's counts) to the
    active trace; nothing outside one."""
    t = active()
    if t is not None:
        t.flops += flops
        t.bytes += nbytes
        t.kernel_flops += flops
        t.kernel_bytes += nbytes
        t.kernel_calls[name] += 1


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _local(t):
    return t.to_local() if is_traceable_wrapper_subclass_type(type(t)) else t


class TraceCounts(TorchDispatchMode):
    """See the module docstring. Enter it (after the ``FakeTensorMode``, if
    any) around the step; read ``flops``, ``bytes``, ``collectives``,
    ``peak_bytes`` and ``peak_by_category()`` after."""

    CATEGORIES = ("params", "optimizer", "inputs", "grads", "activations", "temporaries")

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.kernel_calls: Counter = Counter()
        self.collectives: list = []
        self._skip = 0
        self._live: dict = {}  # storage key -> nbytes
        self._cur = 0
        self.peak_bytes = 0
        self._dirty = False
        self._peak: list = []  # (key, nbytes) of the live storages at the peak
        self._category: dict = {}  # storage key -> final category

    # -- memory ---------------------------------------------------------
    def _alloc(self, t: torch.Tensor, category: str) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            if category != "temporaries":
                self._category[key] = category
            return
        n = st.nbytes()
        self._live[key] = n
        self._category[key] = category
        self._cur += n
        weakref.finalize(st, self._free, key)
        if self._cur > self.peak_bytes:
            self.peak_bytes = self._cur
            self._dirty = True

    def _free(self, key) -> None:
        if self._dirty:
            self._peak = list(self._live.items())
            self._dirty = False
        self._cur -= self._live.pop(key, 0)

    def track(self, tree, category: str) -> None:
        """Register the local storages of ``tree``'s tensors (DTensors'
        shards) as live, in ``category``: the step's inputs."""
        for t in _tensors(tree):
            self._alloc(_local(t), category)

    def mark(self, tree, category: str) -> None:
        """Put the storages of ``tree``'s tensors in ``category`` (their
        final one)."""
        for t in _tensors(tree):
            key = _local(t).untyped_storage()._cdata
            if key in self._live:
                self._category[key] = category

    def peak_by_category(self) -> dict:
        """The live bytes at the peak, by each storage's final category."""
        if self._dirty:
            self._peak = list(self._live.items())
            self._dirty = False
        out = dict.fromkeys(self.CATEGORIES, 0)
        for key, n in self._peak:
            out[self._category.get(key, "temporaries")] += n
        return out

    def _pack(self, t):
        if isinstance(t, torch.Tensor) and not is_traceable_wrapper_subclass_type(type(t)):
            key = t.untyped_storage()._cdata
            if self._category.get(key) == "temporaries":
                self._category[key] = "activations"
        return t

    # -- the mode -------------------------------------------------------
    @contextlib.contextmanager
    def counting(self):
        """The mode, autograd's pack hook (activations) and the skip of
        DTensor's shape propagation, while the context lasts."""
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        orig = ShardingPropagator._propagate_tensor_meta_non_cached

        def propagate(prop, *a, **kw):
            self._skip += 1
            try:
                return orig(prop, *a, **kw)
            finally:
                self._skip -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        _ACTIVE.append(self)
        try:
            with self, torch.autograd.graph.saved_tensors_hooks(self._pack, lambda t: t):
                yield self
        finally:
            _ACTIVE.remove(self)
            ShardingPropagator._propagate_tensor_meta_non_cached = orig

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(is_traceable_wrapper_subclass_type(t) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._skip:
            return out
        packet = func.overloadpacket
        c = _coll.collective_of(func, args, kwargs, out)
        if c is not None:
            self.collectives.append(c)
        elif packet in flop_registry:
            if packet in _PRODUCTS:  # the ".dtype" overloads' out_dtype is not a shape
                args = tuple(a for a in args if isinstance(a, torch.Tensor))
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        outs = _tensors(out)
        for t in outs:
            self._alloc(t, "temporaries")
        if (c is None and outs and not func.is_view and packet not in _NO_TRAFFIC
                and packet is not torch.ops._c10d_functional.wait_tensor):
            ins = _tensors(args) + _tensors(kwargs)
            self.bytes += float(sum(t.numel() * t.element_size() for t in ins + outs))
        return out
