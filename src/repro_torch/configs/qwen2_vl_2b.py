"""qwen2-vl-2b [vlm]: 28L d=1536 12H (GQA kv=2) d_ff=8960 vocab=151936
— M-RoPE, dynamic resolution [arXiv:2409.12191; hf].  Same values as
:mod:`repro.configs.qwen2_vl_2b`.  The vision frontend is a stub: the
inputs are precomputed patch embeddings (B, S, d_model) with (3, B, S)
temporal / height / width M-RoPE position ids."""
from repro_torch.models.config import ModelConfig

ID = "qwen2-vl-2b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ID, n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab=151936, head_dim=128, qkv_bias=True,
        rope_kind="mrope", mrope_sections=(16, 24, 24), rope_theta=1e6,
        tie_embeddings=True, frontend="vision", cut_layers=2,
        family="vlm", optimizer="adamw")


def smoke_config() -> ModelConfig:
    return full_config().replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        mrope_sections=(2, 3, 3), d_ff=128, vocab=257,
        param_dtype="float32", compute_dtype="float32",
        q_chunk=16, kv_chunk=16)
