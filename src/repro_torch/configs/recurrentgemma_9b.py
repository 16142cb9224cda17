"""recurrentgemma-9b [hybrid]: 38L d=4096 16H (kv=1, MQA on attention
layers) d_ff=12288 vocab=256000 — RG-LRU + local attn 1:2
[arXiv:2402.19427; unverified].  Same values as
:mod:`repro.configs.recurrentgemma_9b`.  Sub-quadratic (bounded window +
LRU state) => runs long_500k (``configs.base.supports_shape``)."""
from repro_torch.models.config import LayerSpec, ModelConfig

ID = "recurrentgemma-9b"

_PATTERN = (LayerSpec("rg_lru"), LayerSpec("rg_lru"),
            LayerSpec("local_attn"))


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ID, n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
        d_ff=12288, vocab=256000, head_dim=256, pattern=_PATTERN,
        window=2048, lru_width=4096, activation="gelu",
        tie_embeddings=True, cut_layers=2, family="hybrid",
        subquadratic=True, optimizer="adamw")


def smoke_config() -> ModelConfig:
    return full_config().replace(
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=257, window=8, lru_width=64,
        param_dtype="float32", compute_dtype="float32",
        q_chunk=16, kv_chunk=16)
