"""seamless-m4t-medium [audio]: 12L enc + 12L dec, d=1024 16H (kv=16)
d_ff=4096 vocab=256206 — enc-dec, multimodal [arXiv:2308.11596; hf].
Same values as :mod:`repro.configs.seamless_m4t_medium`.  The speech
frontend is a stub: the encoder's inputs are precomputed frame
embeddings (B, S, d_model); the decoder reads tokens."""
from repro_torch.models.config import ModelConfig

ID = "seamless-m4t-medium"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ID, n_layers=24, n_enc_layers=12, enc_dec=True,
        d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
        vocab=256206, norm="layernorm", gated_mlp=False,
        activation="gelu", tie_embeddings=True, frontend="audio",
        cut_layers=3, family="audio", optimizer="adamw")


def smoke_config() -> ModelConfig:
    return full_config().replace(
        n_layers=4, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=257, cut_layers=1, param_dtype="float32",
        compute_dtype="float32", q_chunk=16, kv_chunk=16)
