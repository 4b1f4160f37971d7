"""Batched serving example: prefill + KV-cache decode on an assigned arch
(the PyTorch port's twin of ``examples/serve_example.py``; imports only
``repro_torch``).

  PYTHONPATH=src python examples/serve_example_torch.py [--arch qwen3_0_6b] [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import REFERENCE_PLAN, build_model
from repro_torch.runtime.serve import ServeConfig, Server


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0_6b", choices=list(ARCH_IDS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch).reduced()   # reduced: runs on the CPU too
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=args.device)
    server = Server(model, params, REFERENCE_PLAN,
                    ServeConfig(max_new_tokens=args.max_new,
                                temperature=args.temperature))

    rng = np.random.default_rng(0)
    inputs = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=args.device)}
    if cfg.family == "encdec":
        inputs["frames"] = torch.as_tensor(
            rng.normal(size=(args.batch, cfg.encoder_seq, cfg.d_model)),
            dtype=torch.bfloat16, device=args.device)
    if cfg.vision_patches:
        inputs["patch_feats"] = torch.as_tensor(
            rng.normal(size=(args.batch, cfg.vision_patches, cfg.vision_dim)),
            dtype=torch.bfloat16, device=args.device)

    t0 = time.time()
    out = server.generate(inputs)
    dt = time.time() - t0
    toks_total = args.batch * args.max_new
    print(f"arch={args.arch} batch={args.batch} prompt={args.prompt_len} "
          f"new={args.max_new} device={args.device}")
    print(f"generated {toks_total} tokens in {dt:.2f}s "
          f"({toks_total/dt:.1f} tok/s incl. first-call costs)")
    for i, row in enumerate(out.tolist()):
        print(f"  seq{i}: {row}")


if __name__ == "__main__":
    main()
