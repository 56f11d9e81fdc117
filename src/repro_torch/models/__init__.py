from repro_torch.models.config import (ArchConfig, EncoderSpec, MoESpec,
                                       SHAPES, ShapeConfig)
from repro_torch.models.model import (
    ActSharding,
    abstract_params,
    forward,
    init_params,
    params_from_jax,
)
from repro_torch.models.decode import decode_step, init_cache, prefill

__all__ = [
    "ArchConfig", "MoESpec", "EncoderSpec", "ShapeConfig", "SHAPES",
    "ActSharding", "abstract_params", "forward", "init_params",
    "params_from_jax", "decode_step", "init_cache", "prefill",
]
