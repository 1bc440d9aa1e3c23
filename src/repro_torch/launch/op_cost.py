"""Op-level cost and memory counter: the port's counterpart of the
reference's ``launch/hlo_cost.py``.

The reference parses the optimized HLO of a compiled cell and attributes
flops and bytes to its instructions (while bodies times their trip counts).
PyTorch has no HLO: eager mode dispatches one ATen op per kernel, so this
module counts what is dispatched.  ``OpCounter`` is a ``TorchDispatchMode``
that sees every op below autograd (the backward's too) and records

* **flops**: ``2*M*N*K`` for each matrix product (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``: what ``matmul`` and ``einsum`` lower to), by the dtype it
  computes in; one per output element for the arithmetic ops, the set of the
  reference's ``_ELEMENTWISE_FLOP_OPS`` (``hlo_cost.py:40``) in ATen's names;
* **bytes**: operand and result bytes of every op that runs a kernel (views
  run none).  Every eager op is a kernel boundary, so this is the traffic
  proxy the reference takes at fusion boundaries;
* **the hand kernels' work**: a kernel wrapper that finds a counter of its
  device (``kernels.accounting.counter``) opens ``OpCounter.kernel`` with
  its cost, from the kernel's own formula, and the ops inside (its empty
  outputs, on the CPU its plain version) are not counted again.  Its flops
  are the work the kernel does (attention: the visible (query, key) pairs),
  which the roofline reads; the reference's HLO count of the same function
  (every key block of its ``lax.scan``, whatever the mask) is kept apart in
  ``hlo_matmul_flops``, for comparing totals with the reference;
* **live storage bytes**: every new storage on the counted device adds its
  size, a ``weakref.finalize`` on it takes the size off when it dies, and
  the running maximum is the peak.

Composite ops whose decomposition depends on the device (``one_hot`` checks
its classes with host reads on the CPU, compares against an ``arange`` on
``meta``, scatters on CUDA) are counted once, at the function level, so
that one shape gives the same counts on ``meta``, the CPU and the card.
Ops on no tensor of the counted device (the CPU RNG state a checkpoint
stashes) are not counted.

Collectives: the reference reads them from the compiled HLO
(``parse_collectives``, ``src/repro/launch/dryrun.py:39``).  The port's
are the explicit copies of ``models.sharding.Distribution``, each recorded
in its ``CollectiveLog``; ``parse_collectives`` sums that log by kind with
the reference's keys.  The counts are the port's own schedule, not XLA's
(the weights are gathered at each use, for one), so they differ from the
reference's in number and bytes.
"""
from __future__ import annotations

import collections
import contextlib
import weakref
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import accounting

MATMUL_OPS = ("mm", "bmm", "addmm", "baddbmm")
# the reference's _ELEMENTWISE_FLOP_OPS in ATen's names (in-place and out=
# variants count the same), with the fused activations and the backward
# ops autograd dispatches for them
ELEMENTWISE_OPS = frozenset({
    "add", "sub", "rsub", "mul", "div", "pow", "exp", "exp2", "log", "log2",
    "rsqrt", "sqrt", "tanh", "neg", "maximum", "minimum", "abs",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "logical_and",
    "logical_or", "logical_xor", "logical_not", "remainder", "fmod", "sign",
    "floor", "ceil", "round", "expm1", "log1p", "sigmoid", "atan2", "where",
    "clamp", "clamp_min", "clamp_max", "eq", "ne", "lt", "le", "gt", "ge",
    "cos", "sin", "silu", "softplus", "relu", "gelu", "reciprocal",
    "masked_fill", "lerp", "addcmul", "addcdiv", "sum", "mean", "amax",
    "amin", "max", "min", "prod", "logsumexp", "cumsum", "_softmax",
    "_log_softmax", "var", "norm", "silu_backward", "softplus_backward",
    "threshold_backward", "sigmoid_backward", "tanh_backward",
    "gelu_backward", "_softmax_backward_data", "_log_softmax_backward_data",
})
# ops that write their output without reading an operand's data
_WRITE_ONLY = frozenset({"zeros_like", "ones_like", "full_like", "zeros",
                         "ones", "full", "fill", "zero", "arange", "scalar_tensor",
                         "copy"})
_NO_KERNEL = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided", "_local_scalar_dense", "set",
                        "resize", "lift_fresh", "record_stream"})
_COMPOSITES = {F.one_hot: "one_hot"}


COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")


def parse_collectives(log) -> dict:
    """Count and per-position result bytes of the calls in a
    ``CollectiveLog`` (None: a run without a mesh, no call) by kind, their
    total, and ``wire_bytes``: the total with each all-reduce counted twice
    (a ring moves about twice its payload: reduce-scatter + all-gather), as
    ``hlo_cost.py:13`` counts it."""
    out = {k: {"count": 0, "bytes": 0} for k in COLLECTIVE_KINDS}
    for kind, _, nbytes in (log.calls if log is not None else ()):
        out[kind]["count"] += 1
        out[kind]["bytes"] += nbytes
    out["total_bytes"] = sum(v["bytes"] for v in out.values())
    out["wire_bytes"] = out["total_bytes"] + out["all-reduce"]["bytes"]
    return out


def dtype_name(dtype: torch.dtype) -> str:
    return {torch.bfloat16: "bf16", torch.float16: "f16",
            torch.float32: "f32", torch.float64: "f64"}.get(
        dtype, str(dtype).removeprefix("torch."))


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storage_bytes(tree, device=None) -> int:
    """Bytes of the distinct storages of the tensors in ``tree`` (on
    ``device`` only, when given): what holding ``tree`` costs."""
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and (device is None
                                            or t.device == device):
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def storage_keys(tree, device=None) -> set:
    return {t.untyped_storage()._cdata for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)
            and (device is None or t.device == device)}


def _name(func) -> str:
    """The op's name without its in-place underscore (``add_`` -> ``add``)."""
    return func.overloadpacket.__name__.rstrip("_")


def matmul_flops(name: str, args) -> int:
    """``2*M*N*K`` (times the batch) of a matrix-product op."""
    a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") else args[:2]
    if name in ("mm", "addmm"):
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


class _Composites(TorchFunctionMode):
    """Counts the ops of ``_COMPOSITES`` as one op each (bytes of their
    operand and result, one flop per output element: a compare) and keeps
    their device-dependent decompositions out of the counts."""

    def __init__(self, counter: "OpCounter"):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _COMPOSITES.get(func) if callable(func) else None
        if name is None or self.counter._quiet:
            return func(*args, **kwargs)
        with self.counter.quiet():
            out = func(*args, **kwargs)
        if self.counter._on_device((args, out)):
            self.counter._add(name, bytes_=tensor_bytes(args[0])
                              + tensor_bytes(out), elementwise=out.numel())
        return out


class OpCounter(TorchDispatchMode):
    """Counts flops, bytes and live storage of the ops run inside it, on
    ``device`` (the counted device: only its ops are counted and only its
    storages tracked).

        with OpCounter("meta") as c:
            c.track(args)          # the arguments are live from the start
            out = fn(*args)
        c.summary()

    Not re-entrant across threads: one counter at a time, as the dry-run
    runs one cell at a time."""

    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.matmul = collections.Counter()     # dtype name -> flops
        # the same with the hand kernels at the reference's HLO count
        self.hlo_matmul = collections.Counter()
        self.elementwise = 0
        self.bytes = 0
        self.ops = collections.Counter()        # op name -> counted calls
        self.kernels = {}  # name -> {"calls", "flops", "bytes", "hlo_flops"}
        self.live = 0
        self.peak = 0
        self._storages = {}  # storage cdata -> bytes, for the live ones
        self._quiet = 0
        self._composites = _Composites(self)

    # ---- entering ----------------------------------------------------------
    def __enter__(self):
        accounting.ACTIVE.append(self)
        self._composites.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._composites.__exit__(*exc)
            accounting.ACTIVE.remove(self)

    @contextlib.contextmanager
    def quiet(self):
        """Ops inside are not counted (their storages still are)."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    # ---- memory ------------------------------------------------------------
    def track(self, tree) -> int:
        """Counts the storages of ``tree`` on the device as live (the
        arguments of a counted call); returns their bytes."""
        before = self.live
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor) and t.device == self.device:
                self._register(t.untyped_storage())
        return self.live - before

    def _register(self, st) -> None:
        key, n = st._cdata, st.nbytes()
        if key in self._storages or n == 0:
            return
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._storages.pop(key, 0)

    # ---- counting ----------------------------------------------------------
    def _on_device(self, tree) -> bool:
        return any(isinstance(t, torch.Tensor) and t.device == self.device
                   for t in tree_leaves(tree))

    def _add(self, name, *, bytes_=0, elementwise=0, matmul=0,
             hlo_matmul=None, dtype=None):
        self.ops[name] += 1
        self.bytes += bytes_
        self.elementwise += elementwise
        if matmul:
            self.matmul[dtype_name(dtype)] += matmul
            self.hlo_matmul[dtype_name(dtype)] += \
                matmul if hlo_matmul is None else hlo_matmul

    @contextlib.contextmanager
    def kernel(self, name: str, *, flops: int, nbytes: int, hlo_flops: int,
               dtype: torch.dtype):
        """One call of a hand-written kernel, the ops inside uncounted:
        ``flops`` matrix-product flops in ``dtype`` (the work it does),
        ``nbytes`` (inputs read once, outputs written once) and
        ``hlo_flops``, the reference's HLO count of the function it
        replaces."""
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0,
                                           "hlo_flops": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        k["hlo_flops"] += hlo_flops
        self._add(name, bytes_=nbytes, matmul=flops, hlo_matmul=hlo_flops,
                  dtype=dtype)
        with self.quiet():
            yield

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        in_keys = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            if t.device == self.device:
                st = t.untyped_storage()
                if st._cdata not in in_keys:
                    self._register(st)
        if not self._quiet and self._on_device((ins, outs)):
            self._count(func, args, kwargs, ins, outs, in_keys)
        return out

    def _count(self, func, args, kwargs, ins, outs, in_keys) -> None:
        name = _name(func)
        mutable = func._schema.is_mutable
        if name in _NO_KERNEL or (not mutable and outs and all(
                t.untyped_storage()._cdata in in_keys for t in outs)):
            return  # no kernel: an allocation, a host read or a view
        if "out" in kwargs:  # written, not read
            ins = [t for t in ins if t is not kwargs["out"]]
        if name in _WRITE_ONLY:
            ins = [t for t in ins[1:]] if mutable else []
        nbytes = sum(map(tensor_bytes, ins)) + sum(map(tensor_bytes, outs))
        if name in MATMUL_OPS:
            n = matmul_flops(name, args)
            ew = outs[0].numel() if name in ("addmm", "baddbmm") else 0
            self._add(name, bytes_=nbytes, matmul=n, elementwise=ew,
                      dtype=args[1 if name in ("addmm", "baddbmm") else 0]
                      .dtype)
        elif name in ELEMENTWISE_OPS:
            self._add(name, bytes_=nbytes,
                      elementwise=sum(t.numel() for t in outs))
        else:
            self._add(name, bytes_=nbytes)

    # ---- results -----------------------------------------------------------
    @property
    def flops(self) -> int:
        return sum(self.matmul.values()) + self.elementwise

    def summary(self) -> dict:
        return {"flops": self.flops, "matmul_flops": dict(self.matmul),
                "hlo_matmul_flops": dict(self.hlo_matmul),
                "elementwise_flops": self.elementwise, "bytes": self.bytes,
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "peak_bytes": self.peak}

