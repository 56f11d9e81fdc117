"""qwen3-moe-235b-a22b [moe]: 94L d=4096 64H GQA(kv=4) vocab=151936,
128 experts top-8, d_expert=1536.  [hf:Qwen/Qwen3 family; hf]"""
from repro_torch.models.config import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936, mlp="swiglu",
    moe=MoESpec(num_experts=128, top_k=8, d_expert=1536),
    rope_theta=1_000_000.0, tie_embeddings=False,
)

SMOKE = ArchConfig(
    name="qwen3-moe-235b-a22b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=32, vocab_size=512, mlp="swiglu",
    # capacity_factor 4.0: at smoke shapes (B=2, S=16) the default 1.25
    # lets a hot expert overflow, and dropped tokens make the batched
    # forward disagree with per-token decode (which never drops) — the
    # prefill/decode consistency contract only holds drop-free
    moe=MoESpec(num_experts=8, top_k=2, d_expert=32, capacity_factor=4.0),
    tie_embeddings=False,
)
