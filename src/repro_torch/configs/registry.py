"""Architecture registry of the port: ``get_config(arch, smoke)``, as
:mod:`repro.configs.registry`: every architecture of the reference's
registry, and gpt2 (the paper's LM split)."""
from __future__ import annotations

from repro_torch.configs import (command_r_35b, gemma2_27b, gpt2,
                                 kimi_k2_1t_a32b, qwen2_1_5b, qwen2_5_32b,
                                 qwen2_vl_2b, qwen3_moe_30b_a3b,
                                 recurrentgemma_9b, seamless_m4t_medium,
                                 xlstm_1_3b)


class _GPT2:
    """gpt2 (the paper's LM split): full = gpt2-small, smoke = gpt2-tiny.
    The reference keeps it outside its registry."""
    full_config = staticmethod(gpt2.gpt2_small)
    smoke_config = staticmethod(gpt2.gpt2_tiny)


_MODULES = {
    "qwen2-1.5b": qwen2_1_5b,
    "command-r-35b": command_r_35b,
    "qwen2.5-32b": qwen2_5_32b,
    "gemma2-27b": gemma2_27b,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "seamless-m4t-medium": seamless_m4t_medium,
    "xlstm-1.3b": xlstm_1_3b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "qwen2-vl-2b": qwen2_vl_2b,
    "gpt2": _GPT2,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port has {ARCH_IDS}")
    mod = _MODULES[arch]
    return mod.smoke_config() if smoke else mod.full_config()
