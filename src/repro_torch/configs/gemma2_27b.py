"""gemma2-27b [dense]: 46L d=4608 32H (GQA kv=16) d_ff=36864
vocab=256000 — local+global alternating, logit softcaps
[arXiv:2408.00118; hf].  Same values as :mod:`repro.configs.gemma2_27b`,
less ``optimizer``."""
from repro_torch.models.config import LayerSpec, ModelConfig

ID = "gemma2-27b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ID, n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16,
        d_ff=36864, vocab=256000, head_dim=128,
        pattern=(LayerSpec("local_attn"), LayerSpec("global_attn")),
        window=4096, attn_softcap=50.0, final_softcap=30.0,
        attn_scale=144.0 ** -0.5,  # query_pre_attn_scalar = d/H = 144
        post_norm=True, activation="gelu", tie_embeddings=True,
        cut_layers=2, family="dense")


def smoke_config() -> ModelConfig:
    return full_config().replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=257, window=8, attn_scale=16.0 ** -0.5,
        param_dtype="float32", compute_dtype="float32",
        q_chunk=16, kv_chunk=16)
