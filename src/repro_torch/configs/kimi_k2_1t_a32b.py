"""kimi-k2-1t-a32b [moe]: 61L d=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384e top-8 — trillion-param MoE (paper-table)
[arXiv:2501.kimi2; unverified].  Same values as
:mod:`repro.configs.kimi_k2_1t_a32b`.

Optimizer is Adafactor: Adam's 2d f32 states for ~1T params cannot fit
512 x 16 GB HBM; factored second moments do (DESIGN.md §4).  One of its
layers holds 384 x 3 x 7168 x 2048 ~ 16.9 B expert parameters (33.8 GB
in bf16), so the full config does not train on one card.
"""
from repro_torch.models.config import LayerSpec, ModelConfig, MoECfg

ID = "kimi-k2-1t-a32b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ID, n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
        d_ff=2048, vocab=163840, head_dim=112, qkv_bias=False,
        pattern=(LayerSpec("global_attn", "moe"),),
        moe=MoECfg(n_experts=384, top_k=8, d_ff_expert=2048,
                   capacity_factor=1.25),
        tie_embeddings=True, rope_theta=5e7, cut_layers=1,
        family="moe", optimizer="adafactor")


def smoke_config() -> ModelConfig:
    return full_config().replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab=257,
        moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=32,
                   capacity_factor=2.0),
        param_dtype="float32", compute_dtype="float32",
        q_chunk=16, kv_chunk=16)
