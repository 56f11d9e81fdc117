"""End-to-end driver on the PyTorch/CUDA port: extract a graph from the
relational store, then train an LM on random walks over it, with
checkpointing and failure recovery — the data plane feeding the compute
plane.  The port's counterpart of ``train_lm.py``.

    PYTHONPATH=src python examples/train_lm_torch.py --device cpu \\
        --steps 20                              # ~100M params on the host
    PYTHONPATH=src python examples/train_lm_torch.py --arch qwen2.5-3b
                                                # its SMOKE variant, on the card

The default arch is a ~100M-parameter llama-style config; ``--arch`` takes
any of the 10 assigned ids (their SMOKE variants).  ``--device`` defaults
to the CUDA card (and fails without one).  The checkpoints' directory is
printed at the end: ``serve_lm_torch.py --ckpt DIR`` serves from it.
"""
import argparse
import sys
import tempfile

sys.path.insert(0, "src")

from repro_torch.api import ExtractionEngine                    # noqa: E402
from repro_torch.configs import get_smoke_config                # noqa: E402
from repro_torch.data import dblp_model, make_dblp              # noqa: E402
from repro_torch.models.config import ArchConfig                # noqa: E402
from repro_torch.relational.table import resolve_device         # noqa: E402
from repro_torch.training.data import GraphWalkPipeline         # noqa: E402
from repro_torch.training.trainer import (                      # noqa: E402
    TrainerConfig,
    run_with_recovery,
)


def lm_100m(vocab: int) -> ArchConfig:
    """~100M params: 12L, d=768, 12 heads (GPT-2-small-ish, llama blocks)."""
    return ArchConfig(
        name="walks-100m", family="dense",
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
        head_dim=64, d_ff=2048, vocab_size=vocab, mlp="swiglu",
        tie_embeddings=True,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default=None,
                    help="assigned arch id (uses its SMOKE variant)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args()
    device = resolve_device(args.device)

    print("== 1. extract the co-authorship graph (ExtGraph hybrid plan) ==")
    db = make_dblp(scale=1, device=device)
    model = dblp_model()
    result = ExtractionEngine(db).extract(model)
    sizes = {k: int(v.num_rows()) for k, v in result.edges.items()}
    print(f"   extracted in {result.timings.total_s:.2f}s; edges={sizes}")
    csr = result.graph_view()
    print(f"   {csr.num_vertices} vertices")

    print("== 2. random-walk corpus over Co-auth edges ==")
    if args.arch:
        cfg = get_smoke_config(args.arch)
        vocab = cfg.vocab_size
    else:
        vocab = max(csr.num_vertices, 512)
        cfg = lm_100m(vocab)
    pipe = GraphWalkPipeline(csr=csr, label="Co-auth", batch=args.batch,
                             seq_len=args.seq, vocab_size=vocab)
    print(f"   model {cfg.name}: {cfg.n_params()/1e6:.1f}M params, "
          f"vocab {vocab}")

    print(f"== 3. train {args.steps} steps with checkpoint/restart ==")
    ckpt_dir = tempfile.mkdtemp(prefix="repro_train_lm_torch_")
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=max(args.steps // 5, 1),
                         ckpt_dir=ckpt_dir, lr=5e-4)
    out = run_with_recovery(cfg, tcfg, pipe, device=device)
    losses = out["losses"]
    k = max(len(losses) // 10, 1)
    first, last = sum(losses[:k]) / k, sum(losses[-k:]) / k
    print(f"   loss {first:.3f} -> {last:.3f} "
          f"({len(losses)} steps, {out['restarts']} restarts, "
          f"ckpts in {ckpt_dir})")
    if last >= first:
        print("WARNING: loss did not fall yet — run more steps "
              "(CPU throughput limits the default)")
    else:
        print("OK")


if __name__ == "__main__":
    main()
