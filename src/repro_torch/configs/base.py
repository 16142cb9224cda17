"""Assigned input shapes and their specs, as :mod:`repro.configs.base`.

The reference's specs are ``ShapeDtypeStruct`` stand-ins; here they are
tensors on the ``meta`` device (shapes and dtypes alone, nothing
allocated), which the dry run (:mod:`repro_torch.launch.dryrun`) counts
one rank's program on.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def supports_shape(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: 524k KV decode is "
                       "skipped per assignment (sub-quadratic only)")
    return True, ""


def _tok(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: ShapeSpec):
    """The train / prefill batch as meta tensors: token ids, or the
    modality frontend stub's precomputed embeddings (frames for the
    enc-dec and audio, patches for vision with M-RoPE's (3, B, S) ids)."""
    B, S = shape.global_batch, shape.seq_len
    cdt = cfg.torch_compute_dtype()
    if cfg.enc_dec:
        return {"inputs": _tok((B, S, cfg.d_model), cdt),
                "aux_labels": _tok((B, S)),
                "dec_tokens": _tok((B, S)),
                "labels": _tok((B, S))}
    if cfg.frontend == "vision":
        return {"inputs": _tok((B, S, cfg.d_model), cdt),
                "positions": _tok((3, B, S)),
                "labels": _tok((B, S))}
    if cfg.frontend == "audio":
        return {"inputs": _tok((B, S, cfg.d_model), cdt),
                "labels": _tok((B, S))}
    return {"inputs": _tok((B, S)), "labels": _tok((B, S))}


def decode_token_specs(cfg: ModelConfig, shape: ShapeSpec):
    """One token a row: decoding emits text tokens for every family (a
    vision arch's M-RoPE degenerates to temporal ids)."""
    return _tok((shape.global_batch, 1))


def serve_cache_specs(cfg: ModelConfig, shape: ShapeSpec):
    from repro_torch.core.protocols import init_serve_caches
    return init_serve_caches(cfg, shape.global_batch, shape.seq_len,
                             device="meta")


def param_specs(cfg: ModelConfig):
    from repro_torch.models.transformer import init_lm
    return init_lm(cfg, device="meta")


def param_logical_axes(cfg: ModelConfig):
    from repro_torch.models.transformer import param_axes
    return param_axes(cfg)
