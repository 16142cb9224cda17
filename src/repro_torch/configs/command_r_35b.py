"""command-r-35b [dense]: 40L d=8192 64H (GQA kv=8) d_ff=22528
vocab=256000, no-bias [hf:CohereForAI/c4ai-command-r-v01; unverified].
Same values as :mod:`repro.configs.command_r_35b`, less ``optimizer``."""
from repro_torch.models.config import ModelConfig

ID = "command-r-35b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ID, n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=22528, vocab=256000, head_dim=128, qkv_bias=False,
        tie_embeddings=True, rope_theta=8e6, norm="layernorm",
        gated_mlp=True, cut_layers=2, family="dense")


def smoke_config() -> ModelConfig:
    return full_config().replace(
        n_layers=4, d_model=64, n_heads=8, n_kv_heads=1, head_dim=8,
        d_ff=128, vocab=257, param_dtype="float32",
        compute_dtype="float32", q_chunk=16, kv_chunk=16)
