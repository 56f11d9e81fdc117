"""qwen2.5-3b [dense]: 36L d=2048 16H GQA(kv=2) d_ff=11008 vocab=151936,
QKV bias.  [hf:Qwen/Qwen2.5-0.5B scaled; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b", family="dense",
    num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2, head_dim=128,
    d_ff=11008, vocab_size=151936, mlp="swiglu", qkv_bias=True,
    rope_theta=1_000_000.0, tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="qwen2.5-3b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=512, mlp="swiglu", qkv_bias=True,
)
