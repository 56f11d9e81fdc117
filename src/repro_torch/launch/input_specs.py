"""``meta`` tensor stand-ins for every (architecture x shape) cell (the
port of ``repro.launch.input_specs``): the JAX package's
``ShapeDtypeStruct``s as tensors on the ``meta`` device, which have a
shape and a dtype and no memory.

  * train_*   -> train_step(params, opt_state, batch)
  * prefill_* -> prefill(params, batch)  (builds a seq_len KV cache)
  * decode_*  -> decode_step(params, cache, token) with a seq_len cache
  * [vlm]: ``frontend_len`` of the seq positions are precomputed patch
    embeddings
  * [audio]: the encoder consumes ``frontend_len`` precomputed frame
    embeddings (source side, beside the decoder's seq_len)
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.models.decode import init_cache

F32 = torch.float32
I32 = torch.int32


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape: ShapeConfig,
                with_labels: bool) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    n_tok = s - cfg.frontend_len if cfg.frontend == "patch" else s
    out = {"tokens": _meta((b, n_tok), I32)}
    if with_labels:
        out["labels"] = _meta((b, n_tok), I32)
    if cfg.frontend == "patch":
        out["embeds"] = _meta((b, cfg.frontend_len, cfg.d_model), F32)
    if cfg.frontend == "frames":
        out["frames"] = _meta((b, cfg.frontend_len, cfg.d_model), F32)
    return out


def cache_specs(cfg: ArchConfig, shape: ShapeConfig):
    src_len = cfg.frontend_len if cfg.encoder is not None else 0
    return init_cache(cfg, shape.global_batch, shape.seq_len,
                      src_len=src_len, device="meta")


def token_spec(shape: ShapeConfig) -> torch.Tensor:
    return _meta((shape.global_batch,), I32)


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """All abstract inputs for this cell, keyed by role."""
    if shape.kind == "train":
        return {"batch": batch_specs(cfg, shape, with_labels=True)}
    if shape.kind == "prefill":
        return {"batch": batch_specs(cfg, shape, with_labels=False)}
    if shape.kind == "decode":
        return {"cache": cache_specs(cfg, shape),
                "token": token_spec(shape)}
    raise ValueError(shape.kind)


def cell_is_applicable(cfg: ArchConfig,
                       shape: ShapeConfig) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic decode state (window/recurrent)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention cache at 524288 positions is "
                       "quadratic-cost/unbounded; skipped per spec "
                       "(see DESIGN.md §Arch-applicability)")
    return True, ""


__all__ = ["batch_specs", "cache_specs", "token_spec", "input_specs",
           "cell_is_applicable"]
