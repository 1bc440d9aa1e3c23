"""Training entry point (the port of the reference's ``launch/train.py``).

LM (the dense architectures, synthetic next-token data):

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --smoke --steps 20 --batch 4 --seq 128 [--device cuda]

Legion GNN (the paper's workload):

    PYTHONPATH=src python -m repro_torch.launch.train --gnn sage \\
        --dataset PR --steps 100 --mem-per-device 64e6 --topology nv4

It runs on the card unless ``--device cpu`` is given.  LM weights are
random, drawn from ``--seed`` with a CPU ``torch.Generator`` (the
reference's can be carried over with ``models.convert.params_from_jax``);
batches are numpy draws from ``--seed + step``, as in the reference.

``--ckpt DIR`` writes checkpoints there (every ``--ckpt-every`` steps and
at the end; the reference's file format, ``train/checkpoint.py``);
``--resume`` restarts from the newest one and continues the per-step batch
sequence.  For the GNN they are ``train_gnn``'s ``checkpoint_dir`` and
``resume``, which also restore the sampler, cache-manager and store state.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.utils import resolve_device


def make_batch(cfg, batch: int, seq: int, seed: int, step: int,
               device="cuda") -> dict:
    """Step ``step``'s synthetic batch, the reference's draw: tokens
    (batch, seq + 1) from ``default_rng(seed + step)`` over the vocabulary,
    ``tokens[:, :-1]`` in and ``tokens[:, 1:]`` as labels (int64), on
    ``device`` (the card unless the caller asks for the CPU; raises
    without one)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed + step)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         size=(batch, seq + 1)))
    return {"tokens": toks[:, :-1].to(device),
            "labels": toks[:, 1:].to(device)}


def train_step(cfg, params: dict, opt, opt_state: dict, batch: dict):
    """One step: loss and gradients through ``transformer.loss_fn``, then
    AdamW.  Functional, like the reference's: returns (new params, new
    optimizer state, loss) and leaves ``params`` as they were."""
    from repro_torch.models import get_module
    from repro_torch.train.optimizer import apply_updates, tree_map

    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = get_module(cfg).loss_fn(cfg, leaves, batch)
    loss.backward()
    grads = tree_map(lambda p: p.grad if p.grad is not None
                     else torch.zeros_like(p), leaves)
    del leaves
    updates, opt_state = opt.update(grads, opt_state, params)
    return apply_updates(params, updates), opt_state, loss.detach()


def train_lm(args):
    """The LM loop; returns the losses of the steps it ran."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_module
    from repro_torch.models.params import init_from_defs
    from repro_torch.train.checkpoint import (AsyncCheckpointer,
                                              latest_checkpoint,
                                              restore_checkpoint)
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.pipeline import StragglerMonitor
    from repro_torch.utils import synchronize

    cfg = get_config(args.arch, smoke=args.smoke)
    dev = resolve_device(args.device)
    params = init_from_defs(get_module(cfg).defs(cfg),
                            torch.Generator().manual_seed(args.seed), dev)
    opt = adamw(args.lr)
    opt_state = opt.init(params)
    step0 = 0
    ckpt = AsyncCheckpointer(args.ckpt) if args.ckpt else None
    if ckpt and args.resume:
        path = latest_checkpoint(args.ckpt)
        if path:
            step0, (params, opt_state) = restore_checkpoint(
                path, (params, opt_state))
            print(f"resumed from step {step0}")
    mon = StragglerMonitor()
    losses = []
    reached = step0
    try:
        for step in range(step0, args.steps):
            t0 = time.perf_counter()
            batch = make_batch(cfg, args.batch, args.seq, args.seed, step,
                               dev)
            new_params, new_opt, loss = train_step(cfg, params, opt,
                                                   opt_state, batch)
            synchronize(dev)
            # the step is done: its state and the step count move together,
            # so after an exception before here (a Ctrl-C in the wait) the
            # final checkpoint is labelled with this step and holds the
            # parameters before it
            params, opt_state, reached = new_params, new_opt, step + 1
            mon.record(time.perf_counter() - t0)
            losses.append(float(loss))
            if step % max(args.steps // 10, 1) == 0:
                print(f"step {step:5d} loss {losses[-1]:.4f}")
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, (params, opt_state))
    finally:
        if ckpt:
            # the step actually reached, never one the run did not get to
            ckpt.save(reached, (params, opt_state))
            ckpt.close()
    print("straggler summary:", mon.summary())
    return losses


def train_gnn_cli(args):
    from repro_torch.core.cliques import topology_matrix
    from repro_torch.core.planner import build_plan
    from repro_torch.graph.csr import synthetic_instance
    from repro_torch.models.gnn import GNNConfig
    from repro_torch.train.loop import train_gnn

    g = synthetic_instance(args.dataset, max_vertices=args.max_vertices,
                           seed=args.seed)
    print(f"dataset {args.dataset}: |V|={g.n} |E|={g.nnz} D={g.feat_dim}")
    plan = build_plan(g, topology_matrix(args.topology),
                      mem_per_device=float(args.mem_per_device),
                      planner=args.planner, seed=args.seed)
    for ci, p in enumerate(plan.cost_plans):
        print(f"clique {ci}: alpha={p['alpha']:.2f} predicted "
              f"N_total={p['N_total']:.0f}")
    cfg = GNNConfig(model=args.gnn, feat_dim=g.feat_dim, hidden=args.hidden,
                    batch_size=args.batch, fanouts=(25, 10), lr=args.lr)
    res = train_gnn(g, plan, cfg, steps=args.steps, seed=args.seed,
                    device=args.device, checkpoint_dir=args.ckpt,
                    checkpoint_every=args.ckpt_every, resume=args.resume)
    if res.resilience.get("resumed_from_step") is not None:
        print(f"resumed from step {res.resilience['resumed_from_step']}")
    if res.losses:
        print(f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}  "
              f"acc {res.accs[-1]:.3f}")
    print(f"feature hit rate {res.counter.feature_hit_rate:.3f}  "
          f"topology hit rate {res.counter.topo_hit_rate:.3f}  "
          f"PCIe tx {res.counter.pcie_transactions}")
    print("straggler summary:", res.straggler)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", help="LM architecture id")
    ap.add_argument("--gnn", choices=["sage", "gcn"], help="GNN model")
    ap.add_argument("--dataset", default="PR", help="paper dataset profile")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--topology", default="nv4")
    ap.add_argument("--planner", default="alpha_sweep",
                    choices=["alpha_sweep", "knapsack"])
    ap.add_argument("--mem-per-device", default="64e6")
    ap.add_argument("--max-vertices", type=int, default=100_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.gnn:
        return train_gnn_cli(args)
    if args.arch:
        return train_lm(args)
    raise SystemExit("pass --arch <id> or --gnn sage|gcn")


if __name__ == "__main__":
    main()
