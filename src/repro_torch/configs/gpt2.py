"""The paper's LM splits: GPT2-Small and GPT2-Medium, and a CPU-sized
GPT2-shaped config (same values as :mod:`repro.configs.gpt2`)."""
from repro_torch.models.config import ModelConfig


def gpt2_small() -> ModelConfig:
    return ModelConfig(
        name="gpt2-small", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=12, d_ff=3072, vocab=50257, norm="layernorm",
        gated_mlp=False, activation="gelu", tie_embeddings=True,
        cut_layers=3, aux_layers=1,  # split after block 3,
        family="dense")              # aux = 1 block + unembed


def gpt2_medium() -> ModelConfig:
    return ModelConfig(
        name="gpt2-medium", n_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=16, d_ff=4096, vocab=50257, norm="layernorm",
        gated_mlp=False, activation="gelu", tie_embeddings=True,
        cut_layers=6, aux_layers=3,  # split after block 6,
        family="dense")              # aux = 3 blocks + unembed


def gpt2_tiny() -> ModelConfig:
    """CPU-runnable GPT2-shaped config."""
    return ModelConfig(
        name="gpt2-tiny", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=256, vocab=211, norm="layernorm",
        gated_mlp=False, activation="gelu", tie_embeddings=True,
        cut_layers=1, aux_layers=1, param_dtype="float32",
        compute_dtype="float32", q_chunk=16, kv_chunk=16,
        family="dense")
