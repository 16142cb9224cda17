"""qwen2.5-32b [dense]: 64L d=5120 40H (GQA kv=8) d_ff=27648
vocab=152064, QKV bias [hf; qwen2.5 family].  Same values as
:mod:`repro.configs.qwen2_5_32b`, less ``optimizer``."""
from repro_torch.models.config import ModelConfig

ID = "qwen2.5-32b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ID, n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=27648, vocab=152064, head_dim=128, qkv_bias=True,
        tie_embeddings=False, rope_theta=1e6, cut_layers=2,
        family="dense")


def smoke_config() -> ModelConfig:
    return full_config().replace(
        n_layers=4, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=128, vocab=257, param_dtype="float32",
        compute_dtype="float32", q_chunk=16, kv_chunk=16)
