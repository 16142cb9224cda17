"""Shared helpers of the serving parity tests (``tests/test_torch_
decode_cache.py``, ``tests/test_torch_serve.py``): the reference's config
of a port arch and a tree comparison of the port's caches with the JAX
package's.  Not a test module."""
import numpy as np

from repro.configs import gpt2 as JGPT2
from repro.configs import registry as JREG
from repro.distributed.sharding import AxisRules
from repro_torch.configs import registry as REG

RULES = AxisRules(mesh=None)
# the port's archs that serve through the engine (tests/test_serve.py's
# DECODER_ONLY): the enc-dec keeps its token loop
# (tests/test_torch_enc_dec_serve.py)
DECODER_ONLY = [a for a in REG.ARCH_IDS
                if not REG.get_config(a, smoke=True).enc_dec]
TOL = dict(rtol=1e-5, atol=1e-5)
# xlstm-1.3b's smoke stack: torch's exp / log_sigmoid differ from
# XLA:CPU's by 1-2 ulps, and the mLSTM divides by |n.q| (which nearly
# cancels in some rows) before a per-head RMS norm, so each of the six
# mLSTM layers adds ~1.5e-6 x max|x| to the residual stream; the serve
# caches (|x| <= 4) differ by up to 1.7e-5 after six layers (measured),
# so an absolute floor of 5e-5 (3x that) on top of TOL's rtol
XLSTM_TOL = dict(rtol=1e-5, atol=5e-5)


def jax_config(arch, smoke=True):
    """The reference's config of a port arch (gpt2 sits outside the
    reference's registry)."""
    if arch == "gpt2":
        return JGPT2.gpt2_tiny() if smoke else JGPT2.gpt2_small()
    return JREG.get_config(arch, smoke)


def assert_trees_close(got, ref, path="", tol=TOL):
    """``got`` (the port's tree of tensors) against ``ref`` (the JAX
    package's, as numpy): the same containers, keys, shapes, dtypes and
    values within ``tol``."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), path
        for k in ref:
            assert_trees_close(got[k], ref[k], f"{path}/{k}", tol)
    elif isinstance(ref, (list, tuple)):
        assert type(got) is type(ref) and len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_trees_close(g, r, f"{path}/{i}", tol)
    else:
        ref = np.asarray(ref)
        assert tuple(got.shape) == ref.shape, path
        assert str(got.dtype).split(".")[-1] == ref.dtype.name, path
        if tol is not None:
            np.testing.assert_allclose(got.float().numpy(),
                                       ref.astype(np.float32), err_msg=path,
                                       **tol)
