"""h2o-danube-3-4b [dense]: 24L d=3840 32H GQA(kv=8) d_ff=10240 vocab=32000,
sliding-window attention (llama+mistral mix).  [arXiv:2401.16818; unverified]

SWA's bounded window cache is what makes long_500k decode runnable."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8, head_dim=120,
    d_ff=10240, vocab_size=32000, mlp="swiglu",
    block_pattern=("swa",), window=4096, subquadratic=True,
    tie_embeddings=False,
)

SMOKE = ArchConfig(
    name="h2o-danube-3-4b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, mlp="swiglu",
    block_pattern=("swa",), window=8, subquadratic=True,
    tie_embeddings=False,
)
