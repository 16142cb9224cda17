"""qwen3-moe-30b-a3b [moe]: 48L d=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128e top-8 [hf:Qwen/Qwen3-30B-A3B; hf].  Same values
as :mod:`repro.configs.qwen3_moe_30b_a3b`."""
from repro_torch.models.config import LayerSpec, ModelConfig, MoECfg

ID = "qwen3-moe-30b-a3b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ID, n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
        d_ff=768, vocab=151936, head_dim=128, qkv_bias=False,
        pattern=(LayerSpec("global_attn", "moe"),),
        moe=MoECfg(n_experts=128, top_k=8, d_ff_expert=768,
                   capacity_factor=1.25),
        tie_embeddings=False, rope_theta=1e6, cut_layers=2,
        family="moe", optimizer="adamw")


def smoke_config() -> ModelConfig:
    return full_config().replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab=257,
        moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=32,
                   capacity_factor=2.0),
        param_dtype="float32", compute_dtype="float32",
        q_chunk=16, kv_chunk=16)
