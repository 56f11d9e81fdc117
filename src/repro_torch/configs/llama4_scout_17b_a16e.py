"""llama4-scout-17b-a16e [moe]: 48L d=5120 40H GQA(kv=8) vocab=202048,
MoE 16 experts top-1 + shared expert, d_expert=8192, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.models.config import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048, mlp="swiglu",
    moe=MoESpec(num_experts=16, top_k=1, d_expert=8192,
                shared_expert_dim=8192),
    rope_theta=500_000.0, tie_embeddings=False,
)

SMOKE = ArchConfig(
    name="llama4-scout-17b-a16e-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=64, vocab_size=512, mlp="swiglu",
    moe=MoESpec(num_experts=4, top_k=1, d_expert=64, shared_expert_dim=64),
    tie_embeddings=False,
)
