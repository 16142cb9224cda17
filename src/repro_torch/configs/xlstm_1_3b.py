"""xlstm-1.3b [ssm]: 48L d=2048 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks (xLSTM[7:1]) [arXiv:2405.04517; unverified].  Sub-quadratic:
constant-size recurrent state => runs long_500k.  Same values as
:mod:`repro.configs.xlstm_1_3b`."""
from repro_torch.models.config import LayerSpec, ModelConfig

ID = "xlstm-1.3b"

_PATTERN = (LayerSpec("mlstm", "none"),) * 7 + (LayerSpec("slstm", "none"),)


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ID, n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304, pattern=_PATTERN, rope_kind="none",
        tie_embeddings=True, cut_layers=2, family="ssm",
        subquadratic=True, optimizer="adamw")


def smoke_config() -> ModelConfig:
    return full_config().replace(
        n_layers=8, d_model=32, n_heads=4, n_kv_heads=4, vocab=257,
        param_dtype="float32", compute_dtype="float32")
