"""Distribution context: the LM mesh, the logical-axis sharding rules, and
the sharded values and collectives the models run over them (the port of
the reference's ``models/sharding.py``).

Logical activation/parameter axes used across the model zoo:

  batch       mini-batch dim                  -> ("pod", "data") (DP)
  batch_full  batch reshard across whole mesh -> ("pod", "data", "model")
  seq         sequence dim (Megatron-style SP)-> "model"
  kv_seq      KV-cache sequence dim           -> "model" (decode) / "data"+"model" (500k)
  embed       residual/d_model                -> replicated
  heads       packed q-head projection dim    -> "model" (when divisible)
  kv_heads    packed kv-head projection dim   -> "model" (when divisible)
  ff          MLP hidden dim                  -> "model"
  vocab       vocabulary dim                  -> "model"
  experts     MoE expert dim                  -> "model"
  ssm_inner   mamba inner channel dim         -> "model"
  ssm_heads   mamba head dim                  -> "model"
  layers      stacked-layer leading dim       -> replicated

The reference hands its specs to GSPMD and ``shard_map``.  The port runs
the mesh in one process, the way the GNN meshes run (``launch/mesh.py``):

* a **sharded value** (``Sharded``) is one local tensor per mesh position
  (row-major), each on its position's device, and its spec: the mesh axes
  each dim is split over (major to minor), or None for a value whose
  positions hold what a ``shard_map`` body holds (partials, dispatch
  buffers);
* **local work** maps a plain function over the positions (``map``);
* **collectives** (``all_gather``, ``psum``, ``pmax``, ``all_to_all``,
  ``reduce_scatter``) are explicit copies over named axes: each group
  gathers (or sums, or takes the maximum) in position order on its first
  position's device and copies the result to the others, so any binding of
  positions to devices gives the same bits; each call is recorded in the
  ``CollectiveLog`` (its kind and per-position result bytes,
  ``launch/op_cost.py`` reads it).  Under autograd each is one node whose
  backward is its transpose, taken the same way and logged too (an
  all-gather's is a reduce-scatter, a psum's a psum, an all_to_all's the
  reverse one); ``pmax`` is not differentiated.  A group of one position
  does nothing and records nothing;
* ``remat(fn, *args)`` runs a region (a layer, a CE chunk) as one autograd
  node that recomputes it in its backward;
* ``Distribution.constrain(x, *logical_axes)`` reshards to the spec the
  rules give: an ``all_gather`` where a dim becomes replicated, a local
  slice where one becomes sharded, an ``all_to_all`` where a shard moves
  from one dim to another;
* ``shift`` (a collective-permute: each position gets its predecessor's
  value along an axis) and ``chain`` (an exclusive scan in position order,
  one hop into each position) carry what a sequence block hands the next;
* weights at their use (``at_use``): decode keeps every weight in its
  sharded layout and ``matmul`` runs the products on the shards
  (column-parallel where the weight's output dim is sharded, row-parallel
  with a ``psum`` where the input's contracting dim is), as GSPMD runs the
  reference's decode (the Mamba mixer's w_out aside:
  ``mamba2._decode_out``); prefill and training gather the weights whole,
  in the dtype they are read in where autograd records nothing.  The log
  marks the collectives that moved a parameter (``param_calls``).

Axes of size 1 split nothing, so a value's spec leaves them out; on a 1 x 1
mesh every value is local and the models run the meshless path's ops.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Optional, Sequence

import torch
from torch.utils import _pytree

from repro_torch.kernels import accounting
from repro_torch.launch.mesh import LMMesh
from repro_torch.models.params import Def, resolve_spec


def on_mesh(dist) -> bool:
    """Whether ``dist`` (a ``Distribution`` or None) has a mesh: the
    models' mesh paths run where it has one, the meshless paths
    otherwise."""
    return dist is not None and dist.mesh is not None


def default_rules(mesh: Optional[LMMesh]) -> dict:
    """Logical axis -> mesh axes, adapted to whichever axes the mesh has."""
    if mesh is None:
        return {}
    names = mesh.axis_names
    dp = tuple(a for a in ("pod", "data") if a in names)
    tp = "model" if "model" in names else None
    return {
        "batch": dp if dp else None,
        "batch_full": dp + ((tp,) if tp else ()),
        "seq": tp,
        "kv_seq": tp,
        "kv_seq_wide": dp + ((tp,) if tp else ()),
        "embed": None,
        "heads": tp,
        "kv_heads": tp,
        "ff": tp,
        "vocab": tp,
        "experts": tp,
        "ssm_inner": tp,
        "ssm_heads": tp,
        "ssm_state": None,
        "layers": None,
    }


def _axes(entry) -> tuple:
    """A spec entry (None, an axis name or a tuple of them) as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _entry(axes: tuple):
    """The reference's ``PartitionSpec`` entry for a tuple of axes."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


# ------------------------------------------------------------ collectives --

# the parameter leaves the models read in f32 wherever they use them (norm
# gains, the SSM's convolution taps and per-head scalars); every other
# weight is cast to the activations' type at its use
READ_IN_F32 = frozenset({
    "attn_norm", "mlp_norm", "cross_norm", "pre_norm", "final_norm",
    "enc_norm", "q_norm", "k_norm", "norm", "conv_x_w", "conv_x_b",
    "conv_B_w", "conv_B_b", "conv_C_w", "conv_C_b", "A_log", "D", "dt_bias"})


# the type of a row-parallel product's partial sums (``Distribution.matmul``;
# tools/row_partials.py holds f64 against it on the card)
ROW_PARTIALS = torch.float32


@dataclasses.dataclass
class CollectiveLog:
    """Every collective a run made: (kind, mesh axes, result bytes of one
    position), in call order; ``launch.op_cost.parse_collectives`` sums
    them by kind.  ``params`` holds the indices of the calls that moved a
    parameter (``Distribution.gather_all`` and ``at_use``)."""
    calls: list = dataclasses.field(default_factory=list)
    params: set = dataclasses.field(default_factory=set)

    def record(self, kind: str, axes: tuple, nbytes: int) -> None:
        self.calls.append((kind, tuple(axes), int(nbytes)))

    def clear(self) -> None:
        self.calls.clear()
        self.params.clear()

    @property
    def param_calls(self) -> list:
        """The calls that moved a parameter, in call order."""
        return [self.calls[i] for i in sorted(self.params)]

    @contextlib.contextmanager
    def moving_params(self):
        """Marks the calls made inside as parameter moves."""
        n0 = len(self.calls)
        try:
            yield
        finally:
            self.params.update(range(n0, len(self.calls)))


class Sharded:
    """One local tensor per active mesh position (``shards[i]`` for
    position ``i``, on ``mesh.device(i)``), and the spec: a tuple of mesh
    axes per dim (empty: replicated over the mesh), or None where the
    positions hold local values with no global layout.

    Under autograd each position's tensor gets its own gradient, and the
    gradient of a value replicated over some axes is the sum of its
    copies' gradients: the collectives' transposes take those sums (in
    position order), and a parameter replicated over some axes has its
    positions' gradients summed over them (``launch.train.train_step``)."""

    def __init__(self, shards: dict, spec: Optional[tuple], mesh: LMMesh):
        self.shards = dict(shards)
        self.spec = None if spec is None else tuple(tuple(a) for a in spec)
        self.mesh = mesh
        first = self.first
        # (a pytree map, as ``torch.utils.checkpoint`` makes over its
        # arguments, may rebuild one over values that are not tensors)
        if self.spec is not None and isinstance(first, torch.Tensor) \
                and len(self.spec) != first.dim():
            raise ValueError(f"spec {self.spec} for a {first.dim()}-D value")

    @property
    def first(self) -> torch.Tensor:
        return self.shards[self.mesh.active[0]]

    def local(self, i: int) -> torch.Tensor:
        return self.shards[i]

    @property
    def dtype(self) -> torch.dtype:
        return self.first.dtype

    @property
    def local_shape(self) -> tuple:
        return tuple(self.first.shape)

    @property
    def shape(self) -> tuple:
        """The global shape (the local one where there is no spec)."""
        if self.spec is None:
            return self.local_shape
        return tuple(n * math.prod(self.mesh.shape[a] for a in ax)
                     for n, ax in zip(self.local_shape, self.spec))

    def pspec(self) -> tuple:
        """The spec in the reference's ``PartitionSpec`` entries."""
        return tuple(_entry(ax) for ax in self.spec)

    def __repr__(self) -> str:
        return (f"Sharded(shape={self.shape}, spec={self.spec}, "
                f"dtype={self.dtype}, positions={len(self.shards)})")


def _flatten(sv: Sharded):
    keys = tuple(sorted(sv.shards))
    return [sv.shards[k] for k in keys], (keys, sv.spec, sv.mesh)


def _unflatten(values, context) -> Sharded:
    keys, spec, mesh = context
    return Sharded(dict(zip(keys, values)), spec, mesh)


_pytree.register_pytree_node(Sharded, _flatten, _unflatten)


@dataclasses.dataclass
class Distribution:
    """Carries the mesh, the rules and the collective log through the
    model code.  ``mesh=None`` gives single-device semantics: the models
    take their meshless path."""

    mesh: Optional[LMMesh] = None
    rules: dict = dataclasses.field(default_factory=dict)
    log: CollectiveLog = dataclasses.field(default_factory=CollectiveLog)

    def __post_init__(self):
        if self.mesh is not None and not self.rules:
            self.rules = default_rules(self.mesh)

    @staticmethod
    def single_device() -> "Distribution":
        return Distribution(mesh=None, rules={})

    # ---- the reference's queries ------------------------------------------
    def axis_size(self, logical: str) -> int:
        if self.mesh is None:
            return 1
        return math.prod(self.mesh.shape.get(a, 1)
                         for a in self.axes_of(logical))

    def mesh_axes(self, logical: str):
        """Mesh axis name(s) for a logical axis (for the collectives)."""
        if self.mesh is None:
            return None
        return self.rules.get(logical)

    def axes_of(self, logical: str) -> tuple:
        """``mesh_axes`` as a tuple (empty: none)."""
        return _axes(self.mesh_axes(logical))

    def spec(self, *axes: Optional[str], shape: Optional[Sequence[int]] = None
             ) -> tuple:
        """The reference's ``PartitionSpec`` entries for the given logical
        axes (divisibility-checked when a shape is provided)."""
        if self.mesh is None:
            return ()
        if shape is None:
            parts, used = [], set()
            for ax in axes:
                m = _axes(self.rules.get(ax) if ax else None)
                m = tuple(x for x in m if x not in used
                          and x in self.mesh.shape)
                used.update(m)
                parts.append(_entry(m))
            return tuple(parts)
        return resolve_spec(Def(tuple(shape), tuple(axes)), self.rules,
                            self.mesh)

    def nshards(self, logical: Optional[str], dim: int) -> int:
        """How many ways a dim of this size actually shards."""
        if self.mesh is None or logical is None:
            return 1
        n = 1
        for a in _axes(self.rules.get(logical)):
            s = self.mesh.shape.get(a, 1)
            if dim % (n * s) == 0:
                n *= s
        return n

    # ---- layouts ------------------------------------------------------------
    def layout(self, *axes: Optional[str], shape: Sequence[int]) -> tuple:
        """The spec the rules give ``shape`` under ``axes``, as the tuples
        of mesh axes a ``Sharded`` keeps (axes of size 1 left out)."""
        return self.norm(self.spec(*axes, shape=shape))

    def norm(self, pspec: Sequence) -> tuple:
        return tuple(tuple(a for a in _axes(e) if self.mesh.shape[a] > 1)
                     for e in pspec)

    def group_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.mesh.shape[a] for a in axes)

    def _local_slice(self, t: torch.Tensor, i: int, dim: int,
                     axes: tuple) -> torch.Tensor:
        n = self.group_size(axes)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {t.shape[dim]} does not "
                             f"split over {axes} ({n} ways)")
        size = t.shape[dim] // n
        return t.narrow(dim, self.mesh.rank(i, axes) * size, size)

    def shard(self, x: torch.Tensor, spec: Sequence) -> Sharded:
        """A full tensor laid out by ``spec`` (tuples of mesh axes per dim;
        pspec entries are taken too): each position's block, on its device.
        Where the device is x's, the block is a view of x; on ``meta`` each
        block is a tensor of its own (so its bytes are the position's)."""
        spec = self.norm(spec)
        spec = spec + ((),) * (x.dim() - len(spec))
        out = {}
        for i in self.mesh.active:
            t = x
            for d, ax in enumerate(spec):
                if ax:
                    t = self._local_slice(t, i, d, ax)
            dev = self.mesh.device(i)
            if dev.type == "meta":
                t = torch.empty(t.shape, dtype=t.dtype, device="meta")
            out[i] = t.to(dev)
        return Sharded(out, spec, self.mesh)

    def zeros(self, defs, dtype: torch.dtype):
        """A tree of ``Def`` leaves as zero ``Sharded`` values laid out by
        the rules, each position's block made on its device (in the
        ``Def``'s dtype, else ``dtype``): a decode state or cache."""
        if not isinstance(defs, Def):
            return {k: self.zeros(v, dtype) for k, v in defs.items()}
        spec = self.norm(resolve_spec(defs, self.rules, self.mesh))
        local = tuple(n // self.group_size(ax)
                      for n, ax in zip(defs.shape, spec))
        return Sharded({i: torch.zeros(local, dtype=defs.dtype or dtype,
                                       device=self.mesh.device(i))
                        for i in self.mesh.active}, spec, self.mesh)

    def full(self, x: Sharded, device=None) -> torch.Tensor:
        """The global tensor ``x`` stands for, assembled on ``device``
        (default: the first position's) from every position's block (for
        results and tests; not a collective of the model).  Needs every
        position."""
        if len(self.mesh.active) != self.mesh.size:
            raise ValueError("one position cannot assemble a global value")
        dev = device if device is not None else self.mesh.device(0)
        blocks = {i: x.local(i).to(dev) for i in self.mesh.positions()}

        def build(fixed: dict, d: int) -> torch.Tensor:
            if d == len(x.spec):
                i = self.mesh.index({a: fixed.get(a, 0)
                                     for a in self.mesh.axis_names})
                return blocks[i]
            ax = x.spec[d]
            if not ax:
                return build(fixed, d + 1)
            parts = []
            for r in range(self.group_size(ax)):
                c = {}
                for a in reversed(ax):
                    c[a] = r % self.mesh.shape[a]
                    r //= self.mesh.shape[a]
                parts.append(build({**fixed, **c}, d + 1))
            return torch.cat(parts, dim=d)

        return build({}, 0)

    # ---- local work ---------------------------------------------------------
    def map(self, fn: Callable, *args, spec=None, pos: bool = False):
        """``fn`` over the active positions: a ``Sharded`` argument gives
        its local tensor, a dict of them its local dict, anything else is
        passed as is (with ``pos``, the position index comes first).
        Returns a ``Sharded`` with ``spec`` (a tuple of ``Sharded``, with a
        tuple of specs, where ``fn`` returns a tuple)."""
        outs = {i: fn(*(((i,) if pos else ())
                        + tuple(_local(a, i) for a in args)))
                for i in self.mesh.active}
        first = outs[self.mesh.active[0]]
        if isinstance(first, tuple):
            specs = spec if spec is not None else (None,) * len(first)
            return tuple(Sharded({i: o[n] for i, o in outs.items()},
                                 specs[n], self.mesh)
                         for n in range(len(first)))
        return Sharded(outs, spec, self.mesh)

    def block_start(self, x: Sharded, dim: int, i: int) -> int:
        """Where position ``i``'s block of ``x`` starts along ``dim``."""
        return self.mesh.rank(i, x.spec[dim]) * x.local_shape[dim]

    def select(self, x: Sharded, index: int) -> Sharded:
        """``x[index]`` along the leading dim (a stacked layer).  Where that
        dim is sharded (ZeRO-3's layers over "data"), only the position of
        each group that holds ``index`` sends it to the others (logged as
        an all-gather of the one layer's bytes, not the stack's), and the
        gradient is the copies' gradients summed in position order back
        into the holder's block (a reduce-scatter of the one layer)."""
        if not x.spec[0]:
            return self.map(lambda t: t[index], x, spec=x.spec[1:])
        axes = x.spec[0]
        rows = x.local_shape[0]
        owner, li = divmod(index, rows)
        groups = self._groups(axes)

        def fwd(loc):
            out = {}
            for group, active in groups:
                src = loc.get(group[owner], loc[active[0]])
                self._spread(src[li], active, out)
            return out

        def bwd(gs):
            out = {}
            for group, active in groups:
                acc = self._sum(gs, group, active)
                holder = group[owner]
                if acc is None or holder not in self.mesh.active:
                    continue
                g = acc.new_zeros((rows,) + tuple(acc.shape))
                g[li] = acc.to(g.device)
                out[holder] = g.to(self.mesh.device(holder))
            if out:
                self.log.record("reduce-scatter", axes,
                                _nbytes(next(iter(out.values()))[0]))
            return out

        res = self._collective(x, x.spec[1:], fwd, bwd)
        self.log.record("all-gather", axes, _nbytes(res.first))
        return res

    def gather_all(self, x: Sharded, keep: Optional[int] = None) -> Sharded:
        """``x`` whole on every position: every sharded dim all-gathered
        but ``keep`` (a weight at its use; the vocab dim of the tables and
        the experts' dim stay sharded).  Logged as parameter moves."""
        with self.log.moving_params():
            for d, ax in enumerate(x.spec):
                if ax and d != keep:
                    x = self.all_gather(x, d)
        return x

    def at_use(self, tree, layer: Optional[int] = None, mode: str = "train",
               name: Optional[str] = None):
        """A parameter tree (nested dicts of ``Sharded`` leaves; ``name``
        the leaf's key) at its use in a pass of ``mode``, each leaf's layer
        ``layer`` first where one is given (``select``: ZeRO-3's layer dim
        fetched from its holder):

        * ``"decode"``: as stored, every leaf in its sharded layout (the
          products run on the shards: ``matmul``);
        * ``"train"``: gathered whole in f32, so that the gather's
          transpose, the gradient's reduce-scatter, sums in f32;
        * any other (prefill): gathered whole (``gather_all``); a weight
          read in the activations' bf16 (all but ``READ_IN_F32``) is cast
          to it on its shard first where autograd records nothing: the
          bits of a cast after the gather, at half the bytes on the
          wire."""
        if isinstance(tree, dict):
            return {k: self.at_use(v, layer, mode, k)
                    for k, v in tree.items()}
        with self.log.moving_params():
            x = tree if layer is None else self.select(tree, layer)
            if mode == "decode":
                return x
            if (mode != "train" and name not in READ_IN_F32
                    and any(x.spec) and x.dtype == torch.float32
                    and not _records(x)):
                x = self.map(lambda t: t.to(torch.bfloat16), x, spec=x.spec)
            return self.gather_all(x)

    def matmul(self, x: Sharded, w: Sharded) -> Sharded:
        """``x @ w.to(x.dtype)`` for a weight ``w`` (d_in, d_out), whole or
        in its sharded layout.  Where x's last (contracting) dim is whole,
        each position multiplies by the columns of ``w`` it holds
        (column-parallel where they are sharded: no communication, the
        result sharded as ``w``'s columns).  Where that dim is sharded,
        each position multiplies its block by the matching rows of ``w``
        (its own where ``w``'s rows are sharded the same way, else a slice
        of the whole) in ``ROW_PARTIALS`` (the products of the rounded
        operands, as a GEMM accumulates them), the partial products are
        summed over those axes (``psum``, row-parallel) and rounded to x's
        type once.  Any other sharded dim of ``w`` is gathered first."""
        ax = x.spec[-1]
        if w.spec[0] not in ((), ax):
            w = self.gather_all(w, keep=1)
        if {a for s in x.spec for a in s} & set(w.spec[1]):
            w = self.gather_all(w, keep=0)
        spec = x.spec[:-1] + (w.spec[1],)
        if not ax:
            return self.map(lambda xi, wi: xi @ wi.to(xi.dtype), x, w,
                            spec=spec)
        own_rows = w.spec[0] == ax

        def part(i, xi, wi):
            if not own_rows:
                wi = self._local_slice(wi, i, 0, ax)
            return xi.to(ROW_PARTIALS) @ wi.to(xi.dtype).to(ROW_PARTIALS)

        out = self.psum(self.map(part, x, w, pos=True, spec=spec), ax)
        return self.map(lambda o, xi: o.to(xi.dtype), out, x, spec=spec)

    # ---- collectives --------------------------------------------------------
    def _groups(self, axes: tuple) -> list:
        """(group, its active members) for every group over ``axes`` that
        has an active member; a group's positions in rank order."""
        seen, out = set(), []
        for i in self.mesh.active:
            g = tuple(self.mesh.group(i, axes))
            if g not in seen:
                seen.add(g)
                out.append((g, [p for p in g if p in self.mesh.active]))
        return out

    def _members(self, x: Sharded, group: tuple, active: list) -> list:
        """The group's local tensors in rank order; on a one-position run
        the absent peers' are copies of the active one's."""
        stand_in = x.local(active[0])
        return [x.local(p) if p in x.shards else stand_in for p in group]

    def _spread(self, result: torch.Tensor, active: list, out: dict) -> None:
        """The group's result (made on its first position's device) to
        every active member: one copy per other device."""
        for p in active:
            out[p] = result.to(self.mesh.device(p))

    def _sum(self, local: dict, group: tuple, active: list):
        """The group's tensors summed in rank order on the first member's
        device (absent peers stand in by the first active member's; a
        member without a tensor, None, adds nothing); None where none has
        one."""
        acc = None
        for p in group:
            t = local.get(p if p in self.mesh.active else active[0])
            if t is not None:
                acc = t if acc is None else acc + t.to(acc.device)
        return acc

    def _collective(self, x: Sharded, spec, fwd: Callable, bwd: Callable
                    ) -> Sharded:
        """``fwd`` over every active position's tensor ({position: tensor}
        -> {position: tensor}) as one autograd node whose gradient is
        ``bwd`` (the same maps over the outputs' gradients, None for an
        output no loss reached), so that the backward's sums are taken in
        position order too, never in the autograd engine's."""
        act = self.mesh.active

        def run(fn, ts, default=None):
            out = fn(dict(zip(act, ts)))
            return [out.get(i, default) for i in act]

        outs = _Collective.apply(lambda xs: run(fwd, xs),
                                 lambda gs: run(bwd, gs),
                                 *(x.local(i) for i in act))
        return Sharded(dict(zip(act, outs)), spec, self.mesh)

    def all_gather(self, x: Sharded, dim: int) -> Sharded:
        """``dim`` made whole: every position gets its group's blocks (the
        group over ``x.spec[dim]``) concatenated in rank order.  Its
        gradient is the transpose, a ``reduce_scatter``: each copy's
        gradient summed over the group in rank order, each position
        keeping its block's rows."""
        axes = x.spec[dim]
        if not axes:
            return x
        groups = self._groups(axes)
        size = x.local_shape[dim]

        def fwd(loc):
            out = {}
            for group, active in groups:
                dev = self.mesh.device(group[0]) if group[0] in loc \
                    else self.mesh.device(active[0])
                stand_in = loc[active[0]]
                parts = [loc.get(p, stand_in).to(dev) for p in group]
                self._spread(torch.cat(parts, dim=dim), active, out)
            return out

        def bwd(gs):
            return self._scatter(gs, groups, dim, size, axes)

        spec = list(x.spec)
        spec[dim] = ()
        res = self._collective(x, tuple(spec), fwd, bwd)
        self.log.record("all-gather", axes, _nbytes(res.first))
        return res

    def _scatter(self, local: dict, groups: list, dim: int, size: int,
                 axes: tuple) -> dict:
        """Each group's tensors summed in rank order, and each member's
        ``size`` rows of ``dim`` at its rank, on its device (logged as a
        reduce-scatter)."""
        out = {}
        for group, active in groups:
            acc = self._sum(local, group, active)
            if acc is None:
                continue
            for p in active:
                r = group.index(p)
                out[p] = acc.narrow(dim, r * size, size).to(
                    self.mesh.device(p))
        if out:
            self.log.record("reduce-scatter", axes,
                            _nbytes(next(iter(out.values()))))
        return out

    def reduce_scatter(self, x: Sharded, dim: int, axes) -> Sharded:
        """The sum over the group along ``axes``, in position order, of
        which each position keeps its rank's block of ``dim`` (``axes``
        join that dim's spec as its minor axes).  Its gradient is the
        ``all_gather`` of the blocks' gradients."""
        axes = tuple(a for a in _axes(axes) if self.mesh.shape[a] > 1)
        if not axes:
            return x
        n = self.group_size(axes)
        if x.local_shape[dim] % n:
            raise ValueError(f"dim {dim} of {x.local_shape} does not split "
                             f"{n} ways")
        size = x.local_shape[dim] // n
        groups = self._groups(axes)

        def bwd(gs):
            out = {}
            for group, active in groups:
                if all(gs.get(p) is None for p in active):
                    continue
                dev = self.mesh.device(group[0] if group[0] in gs
                                       else active[0])
                like = next(g for g in gs.values() if g is not None)
                parts = []
                for p in group:
                    g = gs.get(p if p in self.mesh.active else active[0])
                    parts.append(torch.zeros_like(like, device=dev)
                                 if g is None else g.to(dev))
                self._spread(torch.cat(parts, dim=dim), active, out)
            if out:
                self.log.record("all-gather", axes,
                                _nbytes(next(iter(out.values()))))
            return out

        spec = None
        if x.spec is not None:
            spec = list(x.spec)
            spec[dim] = spec[dim] + axes
            spec = tuple(spec)
        res = self._collective(
            x, spec, lambda loc: self._scatter(loc, groups, dim, size, axes),
            bwd)
        return res

    def psum(self, x: Sharded, axes) -> Sharded:
        """The sum over the group along ``axes``, in position order.  Its
        gradient is the ``psum`` of the copies' gradients (a replicated
        value's gradient is the sum of its copies')."""
        axes = tuple(a for a in _axes(axes) if self.mesh.shape[a] > 1)
        if not axes:
            return x
        groups = self._groups(axes)

        def reduce(loc, log):
            out = {}
            for group, active in groups:
                acc = self._sum(loc, group, active)
                if acc is not None:
                    self._spread(acc, active, out)
            if log and out:
                self.log.record("all-reduce", axes,
                                _nbytes(next(iter(out.values()))))
            return out

        res = self._collective(x, x.spec, lambda loc: reduce(loc, False),
                               lambda gs: reduce(gs, True))
        self.log.record("all-reduce", axes, _nbytes(res.first))
        return res

    def pmax(self, x: Sharded, axes) -> Sharded:
        """The maximum over the group along ``axes``, taken in position
        order; not differentiated (its uses, the softmax shifts, are
        constants to their gradients)."""
        axes = tuple(a for a in _axes(axes) if self.mesh.shape[a] > 1)
        if not axes:
            return x
        out = {}
        for group, active in self._groups(axes):
            members = [t.detach() for t in self._members(x, group, active)]
            dev = members[0].device
            acc = members[0]
            for t in members[1:]:
                acc = torch.maximum(acc, t.to(dev))
            self._spread(acc, active, out)
        res = Sharded(out, x.spec, self.mesh)
        self.log.record("all-reduce", axes, _nbytes(res.first))
        return res

    def all_to_all(self, x: Sharded, axes, split_dim: int,
                   concat_dim: int) -> Sharded:
        """The tiled ``all_to_all`` over ``axes``: each position splits its
        local along ``split_dim`` into one block per group member, and the
        member of rank r gets every member's r-th block, concatenated along
        ``concat_dim`` in rank order.  Its gradient is the reverse
        ``all_to_all`` (``split_dim`` and ``concat_dim`` swapped)."""
        axes = tuple(a for a in _axes(axes) if self.mesh.shape[a] > 1)
        if not axes:
            return x
        n = self.group_size(axes)
        groups = self._groups(axes)
        if x.local_shape[split_dim] % n:
            raise ValueError(f"dim {split_dim} of {x.local_shape} does not "
                             f"split {n} ways")

        def exchange(loc, split, concat, log):
            out = {}
            for group, active in groups:
                present = [loc.get(p) for p in active]
                if all(t is None for t in present):
                    continue
                like = next(t for t in present if t is not None)
                stand_in = loc.get(active[0])
                blocks = []
                for p in group:
                    t = loc.get(p) if p in self.mesh.active else stand_in
                    if t is None:
                        t = torch.zeros_like(like)
                    blocks.append(t.chunk(n, dim=split))
                for p in active:
                    r, dev = group.index(p), self.mesh.device(p)
                    out[p] = torch.cat([b[r].to(dev) for b in blocks],
                                       dim=concat)
            if log and out:
                self.log.record("all-to-all", axes,
                                _nbytes(next(iter(out.values()))))
            return out

        spec = None
        if x.spec is not None:
            spec = list(x.spec)
            spec[concat_dim] = tuple(a for a in spec[concat_dim]
                                     if a not in axes)
            spec[split_dim] = spec[split_dim] + axes
            spec = tuple(spec)
        res = self._collective(
            x, spec, lambda loc: exchange(loc, split_dim, concat_dim, False),
            lambda gs: exchange(gs, concat_dim, split_dim, True))
        self.log.record("all-to-all", axes, _nbytes(res.first))
        return res

    def shift(self, x: Sharded, axes, fill: Optional[Sharded] = None
              ) -> Sharded:
        """A collective-permute in position order along ``axes``: the
        position of rank r gets the tensor of rank r - 1, the first rank
        zeros (or its own tensor of ``fill``, where one is given).  Logged
        as one collective-permute of a position's result bytes (each
        position receives one message).  Its gradient is the reverse
        shift, taken the same way and logged too: rank r - 1 gets rank r's
        gradient, the last rank none."""
        axes = tuple(a for a in _axes(axes) if self.mesh.shape[a] > 1)
        groups = self._groups(axes) if axes else []

        def move(loc, step):
            out = {}
            for group, active in groups:
                for p in active:
                    r = group.index(p) - step
                    if not 0 <= r < len(group):
                        continue
                    q = group[r] if group[r] in self.mesh.active \
                        else active[0]
                    if loc.get(q) is not None:
                        t = loc[q].to(self.mesh.device(p))
                        out[p] = t.view_as(t)
            return out

        def fwd(loc):
            out = move(loc, 1)
            for i in self.mesh.active:
                if i not in out:
                    out[i] = torch.zeros_like(loc[i])
            return out

        def bwd(gs):
            out = move(gs, -1)
            if out:
                self.log.record("collective-permute", axes,
                                _nbytes(next(iter(out.values()))))
            return out

        if axes:
            res = self._collective(x, x.spec, fwd, bwd)
            self.log.record("collective-permute", axes, _nbytes(res.first))
        else:
            res = self.map(torch.zeros_like, x, spec=x.spec)
        if fill is None:
            return res
        return self.map(lambda i, t, f: f if self.mesh.rank(i, axes) == 0
                        else t, res, fill, pos=True, spec=res.spec)

    def chain(self, step: Callable, axes, *xs, spec=None):
        """An exclusive scan in position order along ``axes``: within each
        group, the first rank runs ``step(i, None, *locals)``, and each
        later rank ``step(i, carry, *locals)`` from the carry the rank
        before it returned, sent on to its device (one hop); ``step``
        returns (carry, out).  Each position receives one carry and sends
        one, so the scan is logged as one collective-permute of a carry's
        bytes, and its backward (the reverse chain of the carries'
        gradients, one hop each) as another.  Returns (the outs, ``spec``;
        the carries each position passed on, no global layout).  An absent
        peer's step (a position standing for all) runs on the present
        position's values, uncounted by an op counter."""
        axes = tuple(a for a in _axes(axes) if self.mesh.shape[a] > 1)
        groups = self._groups(axes) if axes else [
            ((i,), [i]) for i in self.mesh.active]

        def back(g):
            self.log.record("collective-permute", axes, _nbytes(g))

        outs, carries, nbytes = {}, {}, 0
        for g, (group, active) in enumerate(groups):
            carry = None
            for r, p in enumerate(group):
                q = p if p in self.mesh.active else active[0]
                if carry is not None:
                    nbytes = _nbytes(carry)
                    carry = _Hop.apply(carry, self.mesh.device(q),
                                       back if (g, r) == (0, 1) else None)
                counter = (accounting.counter(self.mesh.device(q))
                           if p not in self.mesh.active else None)
                with counter.quiet() if counter else contextlib.nullcontext():
                    carry, out = step(q, carry, *(_local(a, q) for a in xs))
                if p in self.mesh.active:
                    outs[p], carries[p] = out, carry
        if nbytes:
            self.log.record("collective-permute", axes, nbytes)
        return (Sharded(outs, spec, self.mesh),
                Sharded(carries, None, self.mesh))

    # ---- resharding ---------------------------------------------------------
    def reshard(self, x, spec: tuple) -> Sharded:
        """``x`` in the layout ``spec`` (tuples of mesh axes per dim).  The
        local slices where a dim becomes sharded are ``narrow``s of each
        position's own tensor, whose gradient is that tensor's zero
        padding: a replicated value's copies each get their slice's
        gradient, and the value's gradient is their sum, as everywhere on
        the mesh (``Sharded``)."""
        if not isinstance(x, Sharded):
            return self.shard(x, spec)
        cur, tgt = list(x.spec), list(spec)
        if cur == tgt:
            return x
        # the minor axis of one dim moving to another (there the minor
        # one too): one all_to_all
        moved = [(d1, d2) for d1 in range(len(cur)) for d2 in range(len(cur))
                 if d1 != d2 and cur[d1] and tgt[d1] == cur[d1][:-1]
                 and tgt[d2] == cur[d2] + cur[d1][-1:]]
        for d1, d2 in moved[:1]:
            x = self.all_to_all(x, cur[d1][-1:], split_dim=d2, concat_dim=d1)
            cur = list(x.spec)
        # dims leaving their layout are made whole, then cut to the target
        for d in range(len(cur)):
            if cur[d] != tgt[d] and cur[d]:
                x = self.all_gather(x, d)
        cur = list(x.spec)
        if cur == tgt:
            return x
        out = {}
        for i in self.mesh.active:
            t = x.local(i)
            for d in range(len(tgt)):
                if tgt[d] and not cur[d]:
                    t = self._local_slice(t, i, d, tgt[d])
            out[i] = t
        return Sharded(out, tuple(tgt), self.mesh)

    def constrain(self, x, *axes: Optional[str]):
        """Reshard to the spec the rules give the logical ``axes``; the
        value itself where there is no mesh."""
        if self.mesh is None:
            return x
        return self.reshard(x, self.layout(*axes, shape=_shape(x)))


def remat(fn: Callable, *args):
    """``fn(*args)`` without keeping its activations: the region runs under
    ``no_grad`` and is one autograd node whose backward runs it again with
    grad on and backpropagates through it, into the gradients of the
    tensors among ``args`` (``Sharded`` values and dicts of them are seen
    through; parameters' blocks among them get theirs).  Every collective
    in the region runs again and is logged again.  It stands for
    ``torch.utils.checkpoint``'s non-reentrant form, whose recompute starts
    at the first saved tensor any thread unpacks: with positions on several
    devices, one autograd thread per device would start it at once and
    interleave their recomputed tensors; this node's backward runs once.
    The meshless paths keep that form: it gives the same bits (the 1 x 1
    mesh's train step is the meshless one's) but stops recomputing once the
    last tensor the backward needs is rebuilt, so it skips each layer's
    down projection, which this node recomputes: on the meshless gemma3-1b
    step at 4 x 4096 that is 2 B S d_ff d_model flops a layer, 6.8 TFLOP a
    step, and with this node there the profiled step's matrix products
    took 177.104 ms against 165.698 (an H100 80GB HBM3 at 700 W,
    ``chip_smoke.py`` phase 14).
    Returns what ``fn`` returns (tensors and ``Sharded`` values of it now
    requiring grad where an input did)."""
    flat, spec = _pytree.tree_flatten(args)
    out_spec, extras = [], []
    tensor = object()  # a tensor's place among the outputs

    def run(*leaves):
        out = fn(*_pytree.tree_unflatten(list(leaves), spec))
        out_flat, treespec = _pytree.tree_flatten(out)
        out_spec[:] = [treespec]
        extras[:] = [tensor if isinstance(o, torch.Tensor) else o
                     for o in out_flat]
        return [o for o in out_flat if isinstance(o, torch.Tensor)]

    outs = iter(_Remat.apply(run, *flat))
    return _pytree.tree_unflatten(
        [next(outs) if e is tensor else e for e in extras], out_spec[0])


class _Remat(torch.autograd.Function):
    """``remat``'s node: forward under ``no_grad``, backward a recompute and
    a backward through it (a reentrant checkpoint over flat leaves)."""

    @staticmethod
    def forward(ctx, run, *leaves):
        ctx.run = run
        ctx.is_tensor = [isinstance(t, torch.Tensor) for t in leaves]
        ctx.others = [None if t else leaf
                      for t, leaf in zip(ctx.is_tensor, leaves)]
        ctx.save_for_backward(*(leaf for t, leaf in zip(ctx.is_tensor, leaves)
                                if t))
        with torch.no_grad():
            return tuple(run(*leaves))

    @staticmethod
    def backward(ctx, *grads):
        saved = iter(ctx.saved_tensors)
        leaves = []
        for t, other in zip(ctx.is_tensor, ctx.others):
            if not t:
                leaves.append(other)
                continue
            x = next(saved)
            leaves.append(x.detach().requires_grad_(x.requires_grad))
        with torch.enable_grad():
            outs = ctx.run(*leaves)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        if pairs:
            torch.autograd.backward([o for o, _ in pairs],
                                    [g for _, g in pairs])
        return (None,) + tuple(
            (x.grad if isinstance(x, torch.Tensor) and x.requires_grad
             else None) for x in leaves)


class _Hop(torch.autograd.Function):
    """One hop of ``Distribution.chain``: the carry to the next rank's
    device; its gradient back to the sender's (``on_back`` called with it:
    the reverse chain's log entry)."""

    @staticmethod
    def forward(ctx, t, device, on_back):
        ctx.src, ctx.on_back = t.device, on_back
        out = t.to(device)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        if ctx.on_back is not None:
            ctx.on_back(g)
        return g.to(ctx.src), None, None


class _Collective(torch.autograd.Function):
    """One collective over every active position as one autograd node:
    ``fwd`` maps the positions' tensors (in ``mesh.active`` order) to
    theirs, ``bwd`` the outputs' gradients (None where no loss reached an
    output) to the inputs' (None: no gradient)."""

    @staticmethod
    def forward(ctx, fwd, bwd, *xs):
        ctx.set_materialize_grads(False)
        ctx.bwd = bwd
        outs, seen = [], set()
        for t in fwd(list(xs)):
            # each position's output is its own tensor, with its own
            # gradient (one tensor spread to positions on one device)
            outs.append(t.view_as(t) if id(t) in seen else t)
            seen.add(id(t))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None) + tuple(ctx.bwd(list(gs)))


def _local(a, i: int):
    """Position ``i``'s part of ``a``: a ``Sharded``'s local tensor, a dict
    of them its local dict, anything else as is."""
    if isinstance(a, Sharded):
        return a.local(i)
    if isinstance(a, dict):
        return {k: _local(v, i) for k, v in a.items()}
    return a


def _records(x: Sharded) -> bool:
    """Whether autograd records what is done with ``x``."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in x.shards.values())


def _shape(x) -> tuple:
    return x.shape if isinstance(x, Sharded) else tuple(x.shape)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()

