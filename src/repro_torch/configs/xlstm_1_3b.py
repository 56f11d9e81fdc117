"""xlstm-1.3b [ssm]: 48L d=2048 4H d_ff=0 vocab=50304, 7:1 mLSTM:sLSTM.
[arXiv:2405.04517; unverified]

mLSTM/sLSTM blocks carry their own projections (d_ff=0 -> no separate FFN);
O(1) matrix-memory state -> runs long_500k."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4, head_dim=512,
    d_ff=0, vocab_size=50304, mlp="none",
    block_pattern=("mlstm",) * 7 + ("slstm",), subquadratic=True,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="xlstm-1.3b-smoke", family="ssm",
    num_layers=4, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
    d_ff=0, vocab_size=512, mlp="none",
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"), subquadratic=True,
)
