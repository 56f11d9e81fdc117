"""gemma-2b [dense]: 18L d=2048 8H MQA(kv=1) head_dim=256 d_ff=16384
vocab=256000, GeGLU.  [arXiv:2403.08295; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b", family="dense",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256000, mlp="geglu", tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="gemma-2b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
    d_ff=128, vocab_size=512, mlp="geglu", tie_embeddings=True,
)
