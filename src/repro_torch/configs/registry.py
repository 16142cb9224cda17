"""Architecture registry of the port: ``get_config(arch, smoke)``, as
:mod:`repro.configs.registry`.  It holds the architectures whose model
the port runs; the reference's others raise and name the ROADMAP item
that ports them."""
from __future__ import annotations

from repro_torch.configs import (command_r_35b, gemma2_27b, gpt2,
                                 kimi_k2_1t_a32b, qwen2_1_5b, qwen2_5_32b,
                                 qwen3_moe_30b_a3b, recurrentgemma_9b,
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
    "xlstm-1.3b": xlstm_1_3b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "gpt2": _GPT2,
}

# the reference's architectures the port lacks, by the ROADMAP queue 1
# item that ports their model
_NOT_PORTED = {
    "seamless-m4t-medium": "item 6 (enc-dec, audio frontend)",
    "qwen2-vl-2b": "item 6 (M-RoPE, vision frontend)",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False):
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch!r} is not ported yet: ROADMAP queue 1 "
            f"{_NOT_PORTED[arch]}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port has {ARCH_IDS}")
    mod = _MODULES[arch]
    return mod.smoke_config() if smoke else mod.full_config()
