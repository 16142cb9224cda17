"""qwen2-1.5b [dense]: 28L d=1536 12H (GQA kv=2) d_ff=8960 vocab=151936,
QKV bias [arXiv:2407.10671; hf].  Same values as
:mod:`repro.configs.qwen2_1_5b`, less ``optimizer`` (read only by the
reference's launch drivers, which the port does not have yet)."""
from repro_torch.models.config import ModelConfig

ID = "qwen2-1.5b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ID, n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab=151936, head_dim=128, qkv_bias=True,
        tie_embeddings=True, rope_theta=1e6, cut_layers=2,
        family="dense")


def smoke_config() -> ModelConfig:
    return full_config().replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=257, cut_layers=2, param_dtype="float32",
        compute_dtype="float32", q_chunk=16, kv_chunk=16)
