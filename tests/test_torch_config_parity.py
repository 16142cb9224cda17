"""Every architecture's config in the port equals the reference's on
every field both have, at full and at smoke size (the nested ``MoECfg``
and the ``LayerSpec`` pattern field by field), ``remat`` included
(activation checkpointing, ROADMAP 7.8).  The only reference fields the
port's ``ModelConfig`` lacks are the two that shape only XLA's program
and have no eager meaning (``seq_sharding``, ``scan_layers``) and
``remat_policy``, which has no counterpart yet: its ``"save_gathers"``
keeps FSDP-gathered MoE weights, and the port gathers none until ROADMAP
7.7 ports FSDP storage."""
import dataclasses

import pytest

from repro.configs import gpt2 as JGPT2
from repro.configs import registry as JREG
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.configs import registry as REG
from repro_torch.models.config import ModelConfig

NO_COUNTERPART = {"seq_sharding", "scan_layers", "remat_policy"}


def _jax_config(arch, smoke):
    if arch == "gpt2":
        return JGPT2.gpt2_tiny() if smoke else JGPT2.gpt2_small()
    return JREG.get_config(arch, smoke)


def _value(v):
    if dataclasses.is_dataclass(v):
        return dataclasses.asdict(v)
    if isinstance(v, tuple):
        return tuple(_value(x) for x in v)
    return v


def test_port_lacks_only_the_xla_knobs():
    ours = {f.name for f in dataclasses.fields(ModelConfig)}
    theirs = {f.name for f in dataclasses.fields(JModelConfig)}
    assert theirs - ours == NO_COUNTERPART
    assert ours <= theirs


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", REG.ARCH_IDS)
def test_config_equals_reference(arch, smoke):
    cfg, jcfg = REG.get_config(arch, smoke), _jax_config(arch, smoke)
    diff = {f.name: (_value(getattr(cfg, f.name)),
                     _value(getattr(jcfg, f.name)))
            for f in dataclasses.fields(cfg)
            if _value(getattr(cfg, f.name)) != _value(getattr(jcfg, f.name))}
    assert not diff, diff
