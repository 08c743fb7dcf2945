"""Batched LM serving on the PyTorch port: prefill a batch of prompts,
decode greedily (the twin of ``examples/serve_lm.py``).

    PYTHONPATH=src python examples/serve_lm_torch.py --batch 4 --steps 32 \
        [--device cpu]

tinyllama-1.1b's SMOKE config with the port's own seeded init; the
prompts are ``jax.random.randint(PRNGKey(1), (batch, prompt_len), 0,
vocab)``, drawn bit for bit by ``core/_threefry.py``.  The ids are then
checked against one full forward over prompt and output: each generated
id must be the forward's argmax at its position wherever the top two
logits there differ by more than the decode path's tolerance.  Runs on
the CUDA card unless ``--device`` names another device.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import tinyllama_11b
from repro_torch.core import _threefry
from repro_torch.device import resolve_device
from repro_torch.models.transformer.model import Transformer
from repro_torch.serve.decode import generate

#: the decode path's tolerance against the forward
#: (``tests/test_models_lm.py``)
TOL = 2e-3


def check(model, prompts, out) -> int:
    """Raise unless every clear argmax of the forward equals the generated
    id; the number of positions checked."""
    seq = torch.cat([prompts, out[:, :-1]], dim=1)
    with torch.no_grad():
        logits, _ = model(seq)
    logits = logits[:, prompts.shape[1] - 1:].float()
    top2 = torch.topk(logits, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > TOL
    wrong = clear & (logits.argmax(-1) != out)
    if bool(wrong.any()):
        raise AssertionError(f"{int(wrong.sum())} generated ids differ from "
                             "the forward's argmax")
    return int(clear.sum())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = tinyllama_11b.SMOKE
    model = Transformer(cfg, seed=0, device=dev)
    prompts = torch.as_tensor(_threefry.randint(
        1, (args.batch, args.prompt_len), 0, cfg.vocab), device=dev)
    t0 = time.perf_counter()
    out = generate(model, prompts, args.steps)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = args.batch * args.steps
    print(f"generated {tuple(out.shape)} in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s batched greedy decode)")
    print("sample ids:", np.asarray(out[0][:16].cpu()))
    checked = check(model, prompts, out)
    print(f"serve_lm_torch: {checked} of {toks} ids checked against the "
          f"forward on {dev.type} OK")


if __name__ == "__main__":
    main()
