"""The JAX package's serving streams for the port's mesh serving tests
(not a test module; run as a script by ``torch_moe_ep_cases.start_jax``
with the stem ``jax_serve``):

    PYTHONPATH=src python tests/jax_serve_reference.py OUT.npz

On one device (``AxisRules(mesh=None)``, the reference's serving
driver's rules), from the port's params ``init_lm(key=PRNGKey(0))``
carried over as numpy (``bridge.to_numpy``), so both sides run the same
weights bit for bit:

* each engine of ``torch_serve_mesh_cases.reference_engines()``: the
  greedy streams of ``repro.core.decode.DecodeEngine`` over the cases'
  queue (``engine|<arch>|<cf>``, padded);
* seamless-m4t-medium's token loop (``repro.launch.serve._serve_enc_dec``'s
  greedy loop: the prompt consumed token by token, then one token a
  step) on the port's encoder output ``normal(PRNGKey(3))`` and prompt
  ``randint(PRNGKey(1))`` (``s2s``).
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_serve_mesh_cases as SC  # noqa: E402
from repro.configs import registry as JREG  # noqa: E402
from repro.core import decode as JD  # noqa: E402
from repro.core import protocols as JP  # noqa: E402
from repro.distributed.sharding import AxisRules  # noqa: E402
from repro_torch.bridge import to_numpy  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.core import prng as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

RULES = AxisRules(mesh=None)


def configs(arch, cf=None):
    """The port's and the reference's smoke config of ``arch`` (its MoE
    at capacity factor ``cf`` when given)."""
    cfg, jcfg = REG.get_config(arch, smoke=True), JREG.get_config(arch, True)
    if cf is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=cf))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=cf))
    return cfg, jcfg


def params_of(cfg):
    return jax.tree.map(jnp.asarray, to_numpy(T.init_lm(
        cfg, device="cpu", key=R.PRNGKey(0))))


def engine_streams(arch, cf):
    cfg, jcfg = configs(arch, cf)
    eng = JD.DecodeEngine(params_of(cfg), jcfg, RULES, slots=SC.SLOTS,
                          capacity=SC.CAPACITY, segment_len=SC.SEGMENT)
    rids = [eng.submit(p, m) for p, (_, m) in
            zip(SC.prompts(cfg.vocab), SC.QUEUE)]
    res = eng.run()
    return SC.pad_streams([res[r] for r in rids])


def s2s_tokens():
    arch, batch, prompt_len, max_new = SC.S2S
    cfg, jcfg = configs(arch)
    params = params_of(cfg)
    caches = JP.init_serve_caches(jcfg, batch, prompt_len + max_new)
    caches["enc_out"] = jnp.asarray(R.normal(
        R.PRNGKey(3), tuple(caches["enc_out"].shape), device="cpu").numpy())
    prompt = jnp.asarray(R.randint(R.PRNGKey(1), (batch, prompt_len), 0,
                                   cfg.vocab, device="cpu").numpy())
    consume = jax.jit(JD.make_prompt_consume(jcfg, RULES))
    serve = jax.jit(JP.make_serve_step(jcfg, RULES))

    def pick(logits):
        return jnp.argmax(logits[:, -1, :cfg.vocab].astype(jnp.float32),
                          axis=-1).astype(jnp.int32)[:, None]

    logits, caches = consume(params, caches, prompt)
    toks = [pick(logits)]
    for _ in range(1, max_new):
        logits, caches = serve(params, caches, toks[-1])
        toks.append(pick(logits))
    return np.asarray(jnp.concatenate(toks, axis=1))


def main(path):
    """Writes ``path`` when every result is in (atomically: the waiting
    tests poll for it), or ``<path stem>.failed`` with the error."""
    try:
        out = {SC.engine_key(arch, cf): engine_streams(arch, cf)
               for arch, cf in SC.reference_engines()}
        out["s2s"] = s2s_tokens()
        tmp = path[:-len(".npz")] + ".tmp.npz"
        np.savez(tmp, **out)
        os.replace(tmp, path)
    except BaseException as e:
        with open(path[:-len(".npz")] + ".failed", "w") as f:
            f.write(repr(e))
        raise


if __name__ == "__main__":
    jax.config.update("jax_platform_name", "cpu")
    main(sys.argv[1])
