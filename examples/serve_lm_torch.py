"""Serving example on the PyTorch/CUDA port: prefill + batched greedy decode.

The port's counterpart of ``serve_lm.py``: random weights from a seeded
``torch.Generator``, or with ``--ckpt DIR`` the parameters of the latest
checkpoint that ``train_lm_torch.py`` wrote there, a batch of prompts from
numpy's seed, ``prefill`` through the hand-written flash-attention kernel on
the card, then greedy ``decode_step``s against the cache.  Every ``--arch``
of ``repro_torch.configs.ARCH_IDS`` serves; an encoder-decoder one
(seamless-m4t-medium) gets its encoder's input, ``frames`` (B,
frontend_len, d_model), from numpy's seed as well.

    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu \\
        --arch xlstm-1.3b                       # any ARCH_ID, smoke size
    PYTHONPATH=src python examples/serve_lm_torch.py --full \\
        --prompt-len 2048 --tokens 32          # qwen2.5-3b at full width
    PYTHONPATH=src python examples/serve_lm_torch.py --full \\
        --arch qwen3-moe-235b-a22b --layers 4  # full width, depth cut
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu \
        --arch qwen2.5-3b --ckpt DIR            # trained parameters

``--device`` defaults to the CUDA card (and fails without one); ``--full``
serves the full configuration instead of the reduced smoke one, and
``--layers`` cuts its depth (qwen3-moe's 94 layers and llama4-scout's 48
do not fit one 80 GB card).  The times are printed on the last-but-one
lines, with the device's name; the last line is the same numbers as JSON.
"""
import argparse
import dataclasses
import json
import sys
import time

sys.path.insert(0, "src")

import numpy as np                                              # noqa: E402
import torch                                                    # noqa: E402

from repro_torch.configs import (ARCH_IDS, get_config,          # noqa: E402
                                 get_smoke_config)
from repro_torch.models import decode_step, init_params, prefill  # noqa: E402
from repro_torch.relational.table import resolve_device         # noqa: E402
from repro_torch.training.checkpoint import CheckpointManager   # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    ap.add_argument("--full", action="store_true",
                    help="the full configuration, not the smoke one")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the configuration to this many layers")
    ap.add_argument("--ckpt", default=None,
                    help="serve the parameters of the latest checkpoint in "
                         "this directory (train_lm_torch.py's)")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = (get_config if args.full else get_smoke_config)(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if args.ckpt:
        mgr = CheckpointManager(args.ckpt)
        step = mgr.latest_step()
        if step is None:
            raise SystemExit(f"no checkpoint in {args.ckpt}")
        like = {"p": init_params(cfg, device="meta")}
        params = mgr.restore(step, like, device=dev)["p"]
        print(f"restored the parameters of step {step} from {args.ckpt}")
    else:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = init_params(cfg, gen, device=dev)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    ).to(dev)
    batch = {"tokens": prompts}
    if cfg.frontend == "frames":          # the encoder's (stub) input
        batch["frames"] = torch.from_numpy(rng.normal(size=(
            args.batch, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        ).to(dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    max_len = args.prompt_len + args.tokens + 1
    sync()
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, batch, max_len)
    out_tokens = [torch.argmax(logits, dim=-1).to(torch.int32)]
    sync()
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(args.tokens - 1):
        logits, cache = decode_step(params, cfg, cache, out_tokens[-1])
        out_tokens.append(torch.argmax(logits, dim=-1).to(torch.int32))
    sync()
    t_decode = time.perf_counter() - t0

    gen_ids = torch.stack(out_tokens, dim=1).cpu().numpy()
    steps = max(args.tokens - 1, 1)
    result = {"arch": cfg.name, "device": name, "batch": args.batch,
              "prompt_len": args.prompt_len, "tokens": args.tokens,
              "prefill_s": t_prefill, "decode_ms_per_step":
              t_decode / steps * 1e3,
              "decode_tokens_per_s": (args.tokens - 1) * args.batch
              / max(t_decode, 1e-9)}
    print(f"arch={cfg.name}  batch={args.batch}  layers={cfg.num_layers}  "
          f"d_model={cfg.d_model}  vocab={cfg.vocab_size}")
    print("sample generations (token ids):")
    for row in gen_ids[:2]:
        print("  ", row[:16].tolist())
    print(f"prefill: {args.prompt_len} tokens x {args.batch} in "
          f"{t_prefill * 1e3:.1f} ms on {name}")
    print(f"decode : {args.tokens - 1} steps in {t_decode * 1e3:.1f} ms "
          f"({result['decode_ms_per_step']:.2f} ms/step, "
          f"{result['decode_tokens_per_s']:.1f} tok/s) on {name}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
