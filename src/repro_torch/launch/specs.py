"""Per-(arch x shape) cell construction: the step function and its
arguments, for one card or over an LM mesh (the port of the reference's
``launch/specs.py``).

``build_cell`` returns what the dry-run (and a real run) needs: the step
function and its arguments, ``meta`` tensors by default (shapes and types,
nothing allocated) or real tensors on a device the caller names.  Without
a mesh ``out_shardings`` is None.  On a mesh (``launch.mesh.LMMesh``) the
cells of the ``transformer`` families run the mesh train step, prefill and
decode step over parameters, optimizer state and caches laid out by the
rules ``shape_rules`` gives (``Sharded`` per position; ``meta["dist"]``
holds the ``Distribution`` and its collective log), and ``out_shardings``
holds the reference's specs of the new state (train) or of the logits and
caches.  A train cell's parameters take ZeRO-3's layout with
``cfg.zero3`` and its moments ZeRO-1's with ``cfg.zero1``
(``models.params.zero_pspec``, the reference's ``_fsdp`` and
``_moment``).  The SSM, hybrid and encoder-decoder families on a mesh
(``MESH_FAMILIES``) raise.

* **train**: ``launch.train.train_step(..., donate=True)`` with
  ``adamw(lr)``: the state (params, AdamW's m, v and count, the step) is
  handed over, as the reference's dry-run donates it;
* **prefill**: the family's ``prefill`` (for the audio and encoder-decoder
  families ``encdec.prefill`` over ``frames`` and ``tokens``);
* **decode**: ``decode_step`` over a cache that is handed over and written
  in place; bf16, but the SSM state ``h`` in f32, as in the reference.

Tokens are int64 (the reference's are int32); AdamW's ``count`` and the
step are host ints (the reference's are int32 scalars), and so is the
decode position.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.serve_lm import ENCDEC_FAMILIES, target_len
from repro_torch.launch.mesh import LMMesh
from repro_torch.models import encdec, get_module, ssm_lm, transformer
from repro_torch.models.params import (init_from_defs, layout_pspecs,
                                       pspecs_from_defs, shard_params,
                                       specs_from_defs)
from repro_torch.models.sharding import (MESH_FAMILIES, Distribution,
                                         default_rules)

MESH_FAMILIES_PORTED = ("dense", "moe", "vlm")  # the transformer's families


@dataclasses.dataclass
class Cell:
    name: str
    fn: Callable
    args: tuple  # meta or real tensor trees (and host ints)
    out_shardings: Any  # None: one card
    meta: dict


def shape_rules(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """The rules of this cell: ``default_rules``, with the KV cache of a
    long-context decode (seq_len > 100,000: its batch cannot shard) spread
    over every data and model axis."""
    rules = default_rules(mesh)
    if mesh is None:
        return rules
    names = mesh.axis_names
    dp = tuple(a for a in ("pod", "data") if a in names)
    tp = "model" if "model" in names else None
    if shape.kind == "decode" and shape.seq_len > 100_000:
        rules["kv_seq"] = dp + ((tp,) if tp else ())
    return rules


def mesh_support(cfg: ModelConfig, shape: ShapeConfig):
    """None where the cell runs on a mesh, else why not (the ROADMAP item
    that ports it)."""
    if cfg.family not in MESH_FAMILIES_PORTED:
        return MESH_FAMILIES
    return None


def _check_mesh(cfg: ModelConfig, shape: ShapeConfig, mesh) -> None:
    if mesh is None:
        return
    if not isinstance(mesh, LMMesh):
        raise TypeError(f"a cell's mesh is a launch.mesh.LMMesh, got "
                        f"{type(mesh).__name__}")
    why = mesh_support(cfg, shape)
    if why is not None:
        raise NotImplementedError(f"{cfg.name} {shape.name} on a mesh is "
                                  f"not ported yet ({why})")


def _tokens(shape: tuple, vocab: int, device, rng) -> torch.Tensor:
    if rng is None:
        return torch.empty(shape, dtype=torch.int64, device="meta")
    return torch.from_numpy(rng.integers(0, vocab, size=shape)).to(device)


def _token_specs(cfg: ModelConfig, shape: ShapeConfig, with_labels=True, *,
                 device="meta", rng=None) -> dict:
    """The batch: tokens (and labels) (B, S) int64; the encoder-decoder's
    ``frames`` (B, S, d_model) bf16 and its tokens (B, St).  Meta tensors,
    or draws from the numpy ``rng`` on ``device``."""
    B, S = shape.global_batch, shape.seq_len
    V = cfg.vocab_size
    out = {}
    if cfg.family in ENCDEC_FAMILIES:
        if rng is None:
            out["frames"] = torch.empty((B, S, cfg.d_model),
                                        dtype=torch.bfloat16, device="meta")
        else:
            out["frames"] = torch.from_numpy(rng.normal(
                size=(B, S, cfg.d_model)).astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        S = target_len(cfg, S)
    out["tokens"] = _tokens((B, S), V, device, rng)
    if with_labels:
        out["labels"] = _tokens((B, S), V, device, rng)
    return out


def _serve_cache_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                       device="meta", dist=None) -> dict:
    """The decode cache of this cell (bf16 KV, f32 SSM state ``h``): meta
    tensors, or zeros on ``device``; with a mesh (``dist``) laid out by
    the rules, per position."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family in ENCDEC_FAMILIES:
        defs = encdec.cache_defs(cfg, B, S, target_len(cfg, S))
    elif cfg.family in ("ssm", "hybrid"):
        defs = {k: (dataclasses.replace(d, dtype=torch.float32) if k == "h"
                    else d) for k, d in ssm_lm.state_defs(cfg, B, S).items()}
    else:
        defs = transformer.cache_defs(cfg, B, S)
    specs = specs_from_defs(defs, torch.bfloat16)
    if torch.device(device).type != "meta":
        specs = {k: torch.zeros(t.shape, dtype=t.dtype, device=device)
                 for k, t in specs.items()}
    if dist is not None:
        return shard_params(specs, defs, dist)
    return specs


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh=None) -> tuple:
    """Meta-tensor stand-ins for every argument of this cell's step
    function (nothing allocated)."""
    return build_cell(cfg, shape, mesh).args


def _params(cfg: ModelConfig, device, seed: int) -> dict:
    defs = get_module(cfg).defs(cfg)
    if torch.device(device).type == "meta":
        return specs_from_defs(defs, torch.float32)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_from_defs(defs, gen, device)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh=None, *,
               lr: float = 3e-4, device="meta", seed: int = 0) -> Cell:
    """The cell of ``cfg`` at ``shape`` on one card, or on ``mesh``.
    ``device="meta"`` gives meta arguments; another device gives real ones
    there: f32 parameters drawn from ``seed`` by a ``torch.Generator`` of
    that device, zero optimizer state and caches, and tokens (and frames)
    drawn from ``numpy.random.default_rng(seed)``.  On a mesh the
    parameters and caches are then laid out on its positions (views of
    those on ``device`` where a position is bound to it; every position's
    own ``meta`` blocks on a meta mesh)."""
    from repro_torch.launch.train import train_step
    from repro_torch.train.optimizer import adamw

    _check_mesh(cfg, shape, mesh)
    mod = get_module(cfg)
    rng = None if torch.device(device).type == "meta" \
        else np.random.default_rng(seed)
    params = _params(cfg, device, seed)
    name = f"{cfg.name}__{shape.name}"
    if mesh is not None:
        return _mesh_cell(cfg, shape, mesh, mod, params, device, rng, name,
                          lr)

    if shape.kind == "train":
        opt = adamw(lr)

        def train_fn(state, batch):
            new, opt_state, loss = train_step(cfg, state["params"], opt,
                                              state["opt"], batch,
                                              donate=True)
            return ({"params": new, "opt": opt_state,
                     "step": state["step"] + 1}, {"loss": loss})

        state = {"params": params, "opt": opt.init(params), "step": 0}
        batch = _token_specs(cfg, shape, device=device, rng=rng)
        return Cell(name, train_fn, (state, batch), None, {"kind": "train"})

    if shape.kind == "prefill":
        batch = _token_specs(cfg, shape, with_labels=False, device=device,
                             rng=rng)
        if cfg.family in ENCDEC_FAMILIES:
            def prefill_fn(params, batch):
                return encdec.prefill(cfg, params, batch)
        else:
            def prefill_fn(params, batch):
                return mod.prefill(cfg, params, batch["tokens"])
        return Cell(name, prefill_fn, (params, batch), None,
                    {"kind": "prefill"})

    # ---- decode ----
    cache = _serve_cache_specs(cfg, shape, device=device)
    tokens = _tokens((shape.global_batch, 1), cfg.vocab_size, device, rng)

    def serve_step(params, cache, tokens, pos):
        return mod.decode_step(cfg, params, cache, tokens, pos)

    return Cell(name, serve_step, (params, cache, tokens, 0), None,
                {"kind": "decode"})


def _mesh_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: LMMesh, mod,
               params: dict, device, rng, name: str, lr: float) -> Cell:
    """A cell of a ``transformer`` family on ``mesh``."""
    dist = Distribution(mesh=mesh, rules=shape_rules(cfg, shape, mesh))
    defs = mod.defs(cfg)
    if shape.kind == "train":
        return _mesh_train_cell(cfg, shape, dist, defs, params, device, rng,
                                name, lr)
    params = shard_params(params, defs, dist)
    meta = {"kind": shape.kind, "dist": dist,
            "param_specs": pspecs_from_defs(defs, dist.rules, mesh)}
    B, V = shape.global_batch, cfg.padded_vocab
    logits_spec = dist.spec("batch", None, "vocab", shape=(B, 1, V))
    if shape.kind == "prefill":
        batch = _token_specs(cfg, shape, with_labels=False, device=device,
                             rng=rng)

        def prefill_fn(params, batch):
            return mod.prefill(cfg, params, batch["tokens"], dist=dist)

        return Cell(name, prefill_fn, (params, batch), None,
                    meta | {"logits_spec": logits_spec})
    cache = _serve_cache_specs(cfg, shape, device=device, dist=dist)
    tokens = _tokens((B, 1), cfg.vocab_size, device, rng)

    def serve_step(params, cache, tokens, pos):
        return mod.decode_step(cfg, params, cache, tokens, pos, dist=dist)

    cache_specs = pspecs_from_defs(transformer.cache_defs(
        cfg, B, shape.seq_len), dist.rules, mesh)
    return Cell(name, serve_step, (params, cache, tokens, 0),
                (logits_spec, cache_specs), meta)


def _mesh_train_cell(cfg: ModelConfig, shape: ShapeConfig, dist, defs,
                     params: dict, device, rng, name: str, lr: float) -> Cell:
    """The train cell on ``dist``'s mesh: the reference's state {"params",
    "opt": {"m", "v", "count"}, "step"}, its parameters in ZeRO-3's layout
    where ``cfg.zero3``, its moments in ZeRO-1's where ``cfg.zero1``;
    ``train_step(..., donate=True, dist=)``; ``out_shardings`` the
    reference's (the new state's specs, and None for the metrics)."""
    from repro_torch.launch.train import train_step
    from repro_torch.train.optimizer import adamw

    param_specs = layout_pspecs(defs, dist, zero=cfg.zero3)
    moment_specs = (layout_pspecs(defs, dist, zero=True) if cfg.zero1
                    else param_specs)
    params = shard_params(params, defs, dist, param_specs)
    opt = adamw(lr)

    def train_fn(state, batch):
        new, opt_state, loss = train_step(cfg, state["params"], opt,
                                          state["opt"], batch, donate=True,
                                          dist=dist)
        return ({"params": new, "opt": opt_state,
                 "step": state["step"] + 1}, {"loss": loss})

    state = {"params": params,
             "opt": opt.init(params, dist, moment_specs), "step": 0}
    batch = _token_specs(cfg, shape, device=device, rng=rng)
    state_specs = {"params": param_specs,
                   "opt": {"m": moment_specs, "v": moment_specs,
                           "count": ()},
                   "step": ()}
    return Cell(name, train_fn, (state, batch), (state_specs, None),
                {"kind": "train", "dist": dist, "param_specs": param_specs,
                 "moment_specs": moment_specs})
