"""recurrentgemma-9b [hybrid]: 38L d=4096 16H MQA(kv=1) d_ff=12288
vocab=256000, RG-LRU : local-attention 2:1 pattern.  [arXiv:2402.19427]

Pattern (rglru, rglru, swa) x 12 cycles + 2 tail rglru layers = 38.
O(1) recurrent state + O(window) local cache -> runs long_500k."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000, mlp="geglu",
    block_pattern=("rglru", "rglru", "swa"), window=2048,
    subquadratic=True, tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="recurrentgemma-9b-smoke", family="hybrid",
    num_layers=6, d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
    d_ff=128, vocab_size=512, mlp="geglu",
    block_pattern=("rglru", "rglru", "swa"), window=8, subquadratic=True,
)
