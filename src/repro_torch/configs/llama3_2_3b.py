"""llama3.2-3b [dense]: 28L d=3072 24H GQA(kv=8) d_ff=8192 vocab=128256.
[hf:meta-llama/Llama-3.2-1B family; unverified]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b", family="dense",
    num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=128256, mlp="swiglu", rope_theta=500_000.0,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="llama3.2-3b-smoke", family="dense",
    num_layers=2, d_model=48, num_heads=3, num_kv_heads=1, head_dim=16,
    d_ff=96, vocab_size=512, mlp="swiglu",
)
