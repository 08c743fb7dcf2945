"""Training launcher of the port.

    python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 100 \
        --batch 8 --seq 256 --smoke --device cpu     # CPU-scale run
    python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 100

With REPRO_COORD_ADDR (``host:port``) / REPRO_NUM_PROC / REPRO_PROC_ID set,
``torch.distributed`` is initialized before anything touches a device
(NCCL on the card, gloo on the CPU); the data-parallel layout over that
group is not ported yet.
"""
from __future__ import annotations

import argparse
import os


def maybe_init_distributed(device):
    if os.environ.get("REPRO_COORD_ADDR"):
        import torch.distributed as dist
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://{os.environ['REPRO_COORD_ADDR']}",
            world_size=int(os.environ["REPRO_NUM_PROC"]),
            rank=int(os.environ["REPRO_PROC_ID"]))


def main(argv=None):
    from repro_torch.configs import get_config
    from repro_torch.core._threefry import seed_key
    from repro_torch.device import resolve_device
    from repro_torch.models.transformer.model import Transformer
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import lm_batches
    from repro_torch.train.loop import (init_state, lm_loss,
                                        make_train_step, run)
    from repro_torch.train.optim import cosine_schedule

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-scale)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-codec", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    maybe_init_distributed(dev)
    full, smoke, family = get_config(args.arch)
    if family != "lm":
        raise SystemExit("train.py drives LM archs; see examples/ for GNN")
    cfg = smoke if args.smoke else full

    model = Transformer(cfg, seed=0, device=dev)
    state = init_state(seed_key(1), model.params, cfg.optimizer)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{cfg.name}: {n_params/1e6:.1f}M params, "
          f"optimizer={cfg.optimizer}")

    if args.resume and args.ckpt_dir and ckpt.latest_step(args.ckpt_dir):
        state = ckpt.restore(args.ckpt_dir, state)
        print(f"resumed from step {int(state.step)}")

    step_fn = make_train_step(
        lm_loss(model), optimizer=cfg.optimizer,
        lr_schedule=cosine_schedule(args.lr, 20, args.steps * 2),
        accum=args.accum, grad_codec=args.grad_codec)

    hooks = []
    if args.ckpt_dir:
        hooks.append(ckpt.checkpoint_hook(args.ckpt_dir, args.ckpt_every))
    data = lm_batches(cfg, batch=args.batch, seq=args.seq,
                      accum=args.accum, device=dev)
    state = run(state, step_fn, data, n_steps=args.steps, hooks=hooks,
                log_every=10)
    for h in hooks:
        if hasattr(h, "wait"):
            h.wait()
    print(f"done at step {int(state.step)}")


if __name__ == "__main__":
    main()
