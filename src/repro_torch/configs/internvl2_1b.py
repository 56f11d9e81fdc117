"""internvl2-1b [vlm]: 24L d=896 14H GQA(kv=2) d_ff=4864 vocab=151655,
InternViT frontend + Qwen2-0.5B backbone.  [arXiv:2404.16821; hf]

Per the task spec the vision frontend is a STUB: input_specs() provides
precomputed patch embeddings (B, 256, d_model) that are projected and
prepended to the token sequence."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151655, mlp="swiglu", qkv_bias=True,
    frontend="patch", frontend_len=256, tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="internvl2-1b-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
    d_ff=128, vocab_size=512, mlp="swiglu", qkv_bias=True,
    frontend="patch", frontend_len=4,
)
