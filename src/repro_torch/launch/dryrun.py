"""Dry-run of every (arch x shape) cell on one H100: flops, bytes, memory
and a roofline per cell, without running the model on a card (the port of
the reference's ``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k

or the whole sweep, every cell in turn in one process (the reference
runs a subprocess per cell to isolate XLA's compiles; a meta pass needs no
isolation, so ``--timeout`` is accepted and unused):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single

The reference lowers and compiles each cell for a TPU mesh and reads the
compiled HLO's cost and XLA's memory analysis.  The port runs each cell's
step function once on ``meta`` tensors (shapes and types, no storage, no
kernel) under ``op_cost.OpCounter``: flops, bytes and the hand kernels'
work as eager mode would dispatch them, and the peak of live storage.  The
roofline's compute term and ``useful_flops_ratio`` read the work the
kernels do (attention: the visible (query, key) pairs), not the
reference's HLO count of the same function.
``lower_s`` is the time to build the cell's meta arguments and
``compile_s`` the time of that accounting pass; ``xla_cost_analysis``
carries the counter's own totals (there is no XLA).  ``--mesh single`` is
one H100.  ``--mesh multi`` is the reference's multi-pod production mesh,
2 x 16 x 16 ``("pod", "data", "model")`` H100s, every position on
``meta`` (``launch.mesh.make_production_mesh``): the cells of the
``transformer`` families (``train``, ``prefill``, ``decode``) run their
mesh step with one position standing for all of them (``LMMesh.run_only``),
the
busiest (``accounted_position``): ``tests/test_torch_lm_mesh.py`` shows
that the positions run the same shapes, bytes and collectives, but for
the decode slot's write, which position 0 makes, and the same flops, but
for the prefill attention's visible pairs, which the last sequence block
has most of.  So ``memory`` and the counts are that position's,
``collectives`` its calls summed by ``op_cost.parse_collectives`` (the
backward's transposes and the gradient sums of a train cell included) and
``collective_s`` their wire bytes over the NVLink rate; the train cells
(``train_4k``) run the mesh train step with ``--variant``'s layout
(``sp_attn``, ``zero1``, ``zero3``); the other families are not ported on
a mesh: their records say why (``status`` "not_ported") and the sweep
counts them apart from its failures.  ``--mesh both`` runs single then multi.

``run_cell(..., device="cuda", shape=..., overrides=...)`` also runs the
cell for real on that device, at a (reduced) ``ShapeConfig`` and config
overrides (fewer layers) the caller gives: the counted flops there, the
step time and ``torch.cuda.max_memory_allocated`` beside the accounting.
Records go to ``build/repro_torch/dryrun/<arch>__<shape>__<mesh>.json``
(``...__<mesh>__<variant>.json`` for a variant), written anew on every run.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import statistics
import time
from pathlib import Path

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.launch import op_cost
from repro_torch.utils import resolve_device

RESULTS_DIR = (Path(__file__).resolve().parents[3] / "build" / "repro_torch"
               / "dryrun")

# one NVIDIA H100 SXM (data sheet)
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core rate
F32_FLOPS_PER_S = 67e12    # f32 without TF32 (the port's rule): CUDA cores
HBM_BYTES_PER_S = 3.35e12  # device-memory rate
H100_BYTES = 80 * 2 ** 30  # the H100's 80 GiB of HBM3, where no card is seen
PEAK_FLOPS = {"bf16": BF16_FLOPS_PER_S, "f16": BF16_FLOPS_PER_S}
# NVLink 4 of one H100, each direction (18 links x 25 GB/s); a mesh of
# hundreds of cards also crosses nodes, where the rate is lower, so the
# collective term is a lower bound
LINK_BYTES_PER_S = 450e9
N_CHIPS = 1
ONE_POSITION = ("the busiest position stands for every position: they run "
                "the same shapes, bytes and collectives, but for the decode "
                "slot's write, which position 0 makes, and the same flops, "
                "but for the prefill (and sp train) attention's pairs, which "
                "the last sequence block has most of "
                "(tests/test_torch_lm_mesh.py, "
                "tests/test_torch_lm_mesh_train.py)")


def accounted_position(mesh, kind: str) -> int:
    """The position the dry-run accounts: in decode 0 (it holds slot 0 and
    writes it); in prefill and training the last (its sequence block is the
    last, which the ``sp`` attention's queries see most of; under
    ``batch_full`` every position's work is the same)."""
    return 0 if kind == "decode" else mesh.size - 1
SKIP_REASON = ("long_500k needs sub-quadratic attention "
               "(pure full-attention arch; see DESIGN.md)")


def device_bytes() -> int:
    """The card's memory where one is present, else the H100's 80 GiB."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return H100_BYTES


def _flat_defs(tree, path=()):
    from repro_torch.models.params import Def

    if isinstance(tree, Def):
        yield path, tree
        return
    for k in tree:
        yield from _flat_defs(tree[k], path + (k,))


def model_flops_estimate(cfg, shape) -> dict:
    """MODEL_FLOPS = 6 * N * D (N_active for MoE), N excluding embeddings."""
    from repro_torch.models import get_module

    n_total = n_expert = n_embed = 0
    for path, d in _flat_defs(get_module(cfg).defs(cfg)):
        n = math.prod(d.shape)
        keys = "/".join(f"[{k!r}]" for k in path)  # the reference's key paths
        if "embed'" in keys or "lm_head" in keys or "dec_embed" in keys:
            n_embed += n
            continue
        n_total += n
        if "experts" in d.axes:
            n_expert += n
    n_active = n_total - n_expert * (1 - cfg.top_k / max(cfg.n_experts, 1)) \
        if cfg.n_experts else n_total
    mult = 6 if shape.kind == "train" else 2
    if cfg.family in ("audio", "encdec"):
        # enc tokens traverse only encoder params (and vice versa)
        frac_enc = cfg.n_enc_layers / max(cfg.n_enc_layers + cfg.n_dec_layers, 1)
        n_enc, n_dec = n_total * frac_enc, n_total * (1 - frac_enc)
        if shape.kind == "decode":
            t_enc, t_dec = 0, shape.global_batch
        else:
            t_enc = shape.global_batch * shape.seq_len
            t_dec = shape.global_batch * max(shape.seq_len // cfg.target_ratio, 16)
        mf = mult * (n_enc * t_enc + n_dec * t_dec)
        tokens = t_enc + t_dec
    else:
        tokens = (shape.global_batch if shape.kind == "decode"
                  else shape.global_batch * shape.seq_len)
        mf = mult * n_active * tokens
    return {"n_params_nonembed": int(n_total), "n_params_embed": int(n_embed),
            "n_active": int(n_active), "tokens": int(tokens),
            "model_flops": float(mf)}


def _grad_mode(cell):
    return torch.enable_grad() if cell.meta["kind"] == "train" \
        else torch.no_grad()


def account(cell, device="meta") -> tuple:
    """One counted call of ``cell.fn`` on its arguments: (the counter's
    summary, the memory record with the reference's keys, the outputs).
    ``argument_bytes`` and ``output_bytes`` are the distinct storages on
    ``device`` of the arguments and the outputs, ``alias_bytes`` those of
    the outputs that are arguments (state handed over and updated in
    place), ``peak_bytes`` the most bytes live at once (the arguments from
    the start), ``temp_bytes`` what makes peak = argument + output + temp -
    alias, as in XLA's memory analysis."""
    with op_cost.OpCounter(resolve_device(device)) as c:
        c.track(cell.args)
        with _grad_mode(cell):
            out = cell.fn(*cell.args)
    dev = c.device
    arg = op_cost.storage_bytes(cell.args, dev)
    outb = op_cost.storage_bytes(out, dev)
    shared = op_cost.storage_keys(out, dev) & op_cost.storage_keys(
        cell.args, dev)
    alias = op_cost.storage_bytes(
        [t for t in tree_leaves(out)
         if isinstance(t, torch.Tensor) and t.device == dev
         and t.untyped_storage()._cdata in shared], dev)
    mem = {"argument_bytes": arg, "output_bytes": outb,
           "temp_bytes": c.peak - arg - outb + alias, "alias_bytes": alias,
           "peak_bytes": c.peak}
    return c.summary(), mem, out


def roofline(summary: dict, mf: dict, colls: dict | None = None,
             n_chips: int = N_CHIPS) -> dict:
    compute_s = sum(f / PEAK_FLOPS.get(dt, F32_FLOPS_PER_S)
                    for dt, f in summary["matmul_flops"].items()) \
        + summary["elementwise_flops"] / F32_FLOPS_PER_S
    terms = {"compute_s": compute_s,
             "memory_s": summary["bytes"] / HBM_BYTES_PER_S,
             "collective_s": (colls["wire_bytes"] / LINK_BYTES_PER_S
                              if colls else 0.0)}
    return {**terms, "dominant": max(terms, key=terms.get),
            "model_flops": mf["model_flops"],
            "useful_flops_ratio": mf["model_flops"]
            / max(summary["flops"] * n_chips, 1.0)}


def _reduced(cfg, full, shape, overrides) -> list:
    cuts = [f"{f} {getattr(full, f)} -> {getattr(shape, f)}"
            for f in ("global_batch", "seq_len")
            if getattr(full, f) != getattr(shape, f)]
    return cuts + [f"{k} {getattr(cfg, k)} -> {v}"
                   for k, v in (overrides or {}).items()]


def _finite(kind: str, out) -> bool:
    """The loss (train) or the logits (prefill, decode) are finite."""
    return bool(torch.isfinite(out[1]["loss"] if kind == "train"
                               else out[0]).all())


def run_on_device(cfg, shape, device, steps: int, seed: int = 0) -> dict:
    """The cell for real on ``device``: one counted call (its counts and
    the counter's peak), then ``steps`` timed calls, each on the state the
    last one handed over (train), at the next position (decode) or on the
    same prompts (prefill).  Each timed call's peak is
    ``max_memory_allocated`` over it, less what was allocated before it,
    plus its arguments' bytes (so that memory held outside the cell does
    not count), after a ``gc.collect()``: the first call of a cell in a
    process can leave its frames in a reference cycle (PyTorch's lazy
    imports: ``torch.fx.wrap`` keeps its caller's frame), holding that
    call's arguments and temporaries until Python's collector runs.
    ``step_s`` is the median of the timed calls.  ``finite``: every
    call's loss or logits are finite."""
    from repro_torch.launch.specs import build_cell

    device = resolve_device(device)
    cuda = device.type == "cuda"
    cell = build_cell(cfg, shape, None, device=device, seed=seed)
    kind = cell.meta["kind"]
    args = list(cell.args)
    cell.args = ()
    summary, mem, out = account(dataclasses.replace(cell, args=tuple(args)),
                                device)
    finite = _finite(kind, out)
    times, peaks = [], []
    for _ in range(steps):
        if kind == "train":
            args[0] = out[0]
        elif kind == "decode":
            args[3] += 1
        del out
        gc.collect()  # a first call's import-time cycles can hold its frames
        arg_bytes = op_cost.storage_bytes(args, device)
        if cuda:
            torch.cuda.synchronize(device)
            pre = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        with _grad_mode(cell):
            out = cell.fn(*args)
        if cuda:
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
        if cuda:
            peaks.append(torch.cuda.max_memory_allocated(device) - pre
                         + arg_bytes)
        finite = finite and _finite(kind, out)
    del out, args
    return {"device": str(device), "steps": steps,
            "step_s": statistics.median(times) if times else None,
            "step_times_s": times, "counts": summary, "memory": mem,
            "measured_peak_bytes": max(peaks) if peaks else None,
            "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                     if cuda else None),
            "finite": finite}


def run_cell(arch: str, shape_name: str, mesh_kind: str = "single",
             out_path=None, variant: str = "baseline", *, shape=None,
             overrides: dict | None = None, device=None,
             steps: int = 2) -> dict:
    """The record of one cell: accounted on ``meta`` at ``shape`` (default:
    the named shape) with ``overrides`` applied to the config, and, with a
    ``device``, also run there (``run_on_device``) under ``"run"``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES, applicable_shapes
    from repro_torch.launch.specs import build_cell
    from repro_torch.launch.variants import apply_variant

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import mesh_support

    cfg = apply_variant(get_config(arch), variant)
    if shape_name not in applicable_shapes(cfg):
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "status": "skipped", "reason": SKIP_REASON}
        _write(rec, out_path)
        return rec
    full = SHAPES[shape_name]
    shape = shape or full
    mesh, n_chips = None, N_CHIPS
    if mesh_kind != "single":
        if mesh_kind != "multi":
            raise ValueError(f"mesh {mesh_kind!r}: single or multi")
        why = mesh_support(cfg, shape)
        if why is not None:
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                   "variant": variant, "status": "not_ported",
                   "reason": f"not ported on a mesh yet: {why}"}
            _write(rec, out_path)
            return rec
        if device is not None:
            raise ValueError("a mesh cell is accounted on meta only")
        mesh = make_production_mesh(multi_pod=True)
        n_chips = mesh.size
        mesh = mesh.run_only(accounted_position(mesh, shape.kind))
    reduced = _reduced(cfg, full, shape, overrides)
    cfg = dataclasses.replace(cfg, **(overrides or {}))

    t0 = time.time()
    cell = build_cell(cfg, shape, mesh)
    t_lower = time.time() - t0
    summary, mem, out = account(cell)
    del out
    t_compile = time.time() - t0 - t_lower
    mf = model_flops_estimate(cfg, shape)
    cap = device_bytes()
    dist = cell.meta.get("dist")
    colls = op_cost.parse_collectives(dist.log if dist is not None
                                      else None)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "variant": variant, "status": "ok", "n_chips": n_chips,
        "lower_s": round(t_lower, 2), "compile_s": round(t_compile, 2),
        "flops_per_device": float(summary["flops"]),
        "bytes_per_device": float(summary["bytes"]),
        "xla_cost_analysis": {"flops": float(summary["flops"]),
                              "bytes": float(summary["bytes"])},
        "memory": mem,
        "collectives": colls,
        "roofline": roofline(summary, mf, colls, n_chips),
        "model_flops_detail": mf,
        "device_bytes": cap, "fits": mem["peak_bytes"] <= cap,
        "counts": summary, "reduced": reduced,
    }
    if mesh is not None:
        rec["mesh_shape"] = mesh.shape
        rec["positions_accounted"] = {"position": mesh.active[0],
                                      "why": ONE_POSITION}
        rec["param_specs"] = cell.meta["param_specs"]
    if device is not None:
        rec["run"] = run_on_device(cfg, shape, device, steps)
    _write(rec, out_path)
    return rec


def _write(rec: dict, out_path) -> None:
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=2)


def record_path(arch: str, shape: str, mesh: str, variant: str) -> Path:
    tail = "" if variant == "baseline" else f"__{variant}"
    return RESULTS_DIR / f"{arch}__{shape}__{mesh}{tail}.json"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out")
    ap.add_argument("--timeout", type=int, default=2400,
                    help="accepted for the reference's CLI; unused")
    args = ap.parse_args(argv)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if not args.all:
        for m in meshes:
            out = args.out or record_path(args.arch, args.shape, m,
                                          args.variant)
            rec = run_cell(args.arch, args.shape, m, out_path=out,
                           variant=args.variant)
            dom = rec.get("roofline", {}).get("dominant", "-")
            print(json.dumps({k: rec[k] for k in ("arch", "shape", "mesh",
                                                  "status") if k in rec}
                             | {"dominant": dom}))
            if rec["status"] == "not_ported":
                raise SystemExit(f"{args.arch} {args.shape} on --mesh {m}: "
                                 f"{rec['reason']}")
        return

    from repro_torch.configs import ARCH_IDS, SHAPES

    cells = [(a, s, m) for a in ARCH_IDS for s in SHAPES for m in meshes]
    print(f"dry-run sweep: {len(cells)} cells")
    failures, not_ported = [], []
    for i, (arch, shape, m) in enumerate(cells):
        t0 = time.time()
        try:
            rec = run_cell(arch, shape, m, variant=args.variant,
                           out_path=record_path(arch, shape, m,
                                                args.variant))
        except Exception as e:  # noqa: BLE001 -- reported, the sweep goes on
            print(f"[{i+1}/{len(cells)}] {arch} {shape} {m}: FAIL "
                  f"{e!r:.300}")
            failures.append((arch, shape, m, repr(e)[:500]))
            continue
        if rec["status"] == "not_ported":
            not_ported.append((arch, shape, m, rec["reason"]))
        dom = rec.get("roofline", {}).get("dominant", "-")
        print(f"[{i+1}/{len(cells)}] {arch} {shape} {m}: {rec['status']} "
              f"({time.time() - t0:.1f}s) {dom}")
    print(f"done; {len(not_ported)} not ported on a mesh, "
          f"{len(failures)} failures")
    for reason in sorted({r for *_, r in not_ported}):
        print(f"not ported ({sum(r == reason for *_, r in not_ported)} "
              f"cells): {reason}")
    for f in failures:
        print("FAIL:", f)
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
