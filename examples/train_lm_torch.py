"""Train a language model end-to-end with the port's full substrate (data
pipeline, AdamW, checkpointing, restart): the twin of
``examples/train_lm.py``.  The default is a ~10M-param tinyllama-shaped
config, so a few hundred steps finish in minutes on a CPU and in seconds
on a GPU.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu
"""
import argparse
import os
import tempfile

from repro_torch.configs import tinyllama_11b
from repro_torch.core._threefry import seed_key
from repro_torch.device import resolve_device
from repro_torch.models.transformer.model import Transformer
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import lm_batches
from repro_torch.train.loop import init_state, lm_loss, make_train_step, run
from repro_torch.train.optim import cosine_schedule


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    # ~10M params: tinyllama shape at d_model 256
    cfg = tinyllama_11b.CONFIG.scaled(
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=2, d_head=32,
        d_ff=688, vocab=8_192, dtype="float32", param_dtype="float32",
        seq_parallel=False, optimizer="adamw")
    model = Transformer(cfg, seed=0, device=dev)
    n = sum(p.numel() for p in model.parameters())
    print(f"training {n / 1e6:.1f}M params for {args.steps} steps")

    state = init_state(seed_key(1), model.params)
    step_fn = make_train_step(
        lm_loss(model), optimizer="adamw",
        lr_schedule=cosine_schedule(3e-4, 20, args.steps))
    hook = ckpt.checkpoint_hook(args.ckpt_dir, every=50, blocking=False)
    data = lm_batches(cfg, batch=args.batch, seq=args.seq, device=dev)
    state = run(state, step_fn, data, n_steps=args.steps, hooks=[hook],
                log_every=20)
    hook.wait()
    print(f"final checkpoint at step {ckpt.latest_step(args.ckpt_dir)}")


if __name__ == "__main__":
    main()
