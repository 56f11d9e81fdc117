"""seamless-m4t-medium [audio]: enc-dec, 12L each, d=1024 16H MHA(kv=16)
d_ff=4096 vocab=256206.  [arXiv:2308.11596; hf]

Speech frontend is a STUB per the task spec: input_specs() provides
precomputed frame embeddings (B, 1536, d_model) consumed by the encoder."""
from repro_torch.models.config import ArchConfig, EncoderSpec

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio",
    num_layers=12, d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=256206, mlp="swiglu",
    encoder=EncoderSpec(num_layers=12), frontend="frames",
    frontend_len=1536, tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="seamless-m4t-medium-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, mlp="swiglu",
    encoder=EncoderSpec(num_layers=2), frontend="frames", frontend_len=8,
)
