"""Model configuration: the fields of :class:`repro.models.config.
ModelConfig` that the dense transformer family, the RG-LRU hybrid
(RecurrentGemma), xLSTM (mLSTM / sLSTM), the MoE family (qwen3-moe,
kimi-k2), M-RoPE with its vision stub (qwen2-vl) and the enc-dec with its
audio stub (seamless-m4t) read, with the same names and defaults.  Of
the reference's performance knobs it has ``causal_skip``,
``attn_p_dtype`` and ``remat`` (activation checkpointing:
``torch.utils.checkpoint`` where the reference has ``jax.checkpoint``);
the two that shape only XLA's program (``seq_sharding``,
``scan_layers``) have no eager meaning, and ``remat_policy`` has none
yet: its ``"save_gathers"`` keeps FSDP-gathered MoE weights across the
backward's recompute, and the port gathers none (ROADMAP 7.7)."""
from __future__ import annotations

import dataclasses

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    n_shared_experts: int = 0      # kimi-style shared expert
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer = mixer + ffn."""
    mixer: str = "global_attn"     # global_attn|local_attn|rg_lru|mlstm|slstm
    ffn: str = "dense"             # dense | moe | none


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    head_dim: int = 0              # 0 => d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = True
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    post_norm: bool = False        # gemma2-style post-block norms
    activation: str = "silu"
    gated_mlp: bool = True
    rope_kind: str = "rope"        # rope | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, ...] = ()
    attn_softcap: float | None = None
    final_softcap: float | None = None
    attn_scale: float | None = None
    window: int = 4096             # local-attention window
    moe: MoECfg | None = None
    # --- enc-dec (seamless-m4t) ---
    enc_dec: bool = False
    n_enc_layers: int = 0
    # --- recurrent (xlstm / recurrentgemma) ---
    lru_width: int = 0             # 0 => d_model
    conv_width: int = 4
    # --- modality frontend stub ---
    frontend: str | None = None    # None | "audio" | "vision"
    # --- SFL split ---
    cut_layers: int = 2            # client-side depth (the cut layer)
    aux_layers: int = 0            # extra transformer blocks in the aux head
    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # --- server attention (plain PyTorch online softmax) and its knobs ---
    attn_impl: str = "blocked"     # naive | blocked
    q_chunk: int = 1024
    kv_chunk: int = 1024
    causal_skip: bool = False      # each q block visits only the kv blocks
                                   # the causal / window mask leaves open
    mlstm_chunk: int = 0           # 0 = sequential scan; >0 = chunkwise
    attn_p_dtype: str = "float32"  # dtype of the softmax p fed to p @ v
    remat: bool = True             # activation checkpointing on each rep
                                   # of a stack segment (training only)
    forward_impl: str = "xla"      # xla | kernel: the client's ZO probe on
                                   # JAX's threefry stream (plain
                                   # forwards, the reference's default) or
                                   # on the hash stream inside the fused
                                   # dual-probe kernels
    attn_probe: str = "weights"    # weights | scores: where the dual probe
                                   # perturbs attention (q/k/v/o weights,
                                   # or the pre-softmax scores with k/v
                                   # shared between the streams)
    optimizer: str = "adamw"       # adamw | adafactor | sgdm (server)
    family: str = "dense"          # dense | moe | audio | ssm | hybrid | vlm
    subquadratic: bool = False     # eligible for long_500k

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return ((self.vocab + 255) // 256) * 256

    def torch_param_dtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    def torch_compute_dtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]

    def layer_specs(self) -> tuple[LayerSpec, ...]:
        reps = (self.n_layers + len(self.pattern) - 1) // len(self.pattern)
        return (self.pattern * reps)[: self.n_layers]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
