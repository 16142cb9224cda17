"""The JAX package's expert-parallel MoE and its sharded HERON step, for
the port's mesh tests (not a test module; run as a script by
``torch_moe_ep_cases.start_jax``):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        PYTHONPATH=src python tests/jax_moe_ep_reference.py OUT.npz

On meshes of 4 forced host devices built as ``jax.sharding.Mesh`` (Auto
axes: ``jax.make_mesh`` gives Explicit ones on jax 0.9, on which the
reference's sharding constraints raise), under ``jax.jit``:

* every case of ``torch_moe_ep_cases.CASES``: ``moe_ep``'s output and
  the gradients of ``sum(out * w)`` with respect to x and each param
  (``<case>|out``, ``<case>|grad|x``, ``<case>|grad|<path>``);
* one HERON step (kernel stream, gaussian) on qwen3-moe-30b-a3b's smoke
  config over the (2, 2) mesh from ``init_lm(PRNGKey(0))``: the params
  after it (``step|<path>``, the port's paths) and its two losses.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_moe_ep_cases as MC  # noqa: E402
from repro.configs.qwen3_moe_30b_a3b import smoke_config  # noqa: E402
from repro.core import protocols as P, zo as Z  # noqa: E402
from repro.distributed.sharding import AxisRules  # noqa: E402
from repro.models import moe as M, transformer as T  # noqa: E402
from repro.models.config import ModelConfig, MoECfg  # noqa: E402
from repro.optim.optimizers import adamw, zo_sgd  # noqa: E402


def mesh_of(n_data, n_model):
    devs = np.array(jax.devices()[:n_data * n_model])
    return Mesh(devs.reshape(n_data, n_model), ("data", "model"))


def paths(tree, prefix=""):
    """``{path: array}`` with the port's ``/``-joined keys and indices."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def moe_cases(out):
    for case, ((nd, nm), cf, shared, _) in MC.CASES.items():
        cfg = ModelConfig(
            name="t", n_layers=1, d_model=MC.D_MODEL, n_heads=4,
            n_kv_heads=4, d_ff=0, vocab=64,
            moe=MoECfg(n_experts=MC.N_EXPERTS, top_k=MC.TOP_K,
                       d_ff_expert=MC.D_FF, capacity_factor=cf,
                       n_shared_experts=shared),
            param_dtype="float32", compute_dtype="float32")
        params, x, w = MC.inputs(case)
        mesh = mesh_of(nd, nm)
        rules = AxisRules(mesh=mesh, enable_fsdp=False)

        def fn(p, x):
            y, vjp = jax.vjp(lambda p, x: M.moe_ep(p, x, cfg, rules), p, x)
            return y, vjp(jnp.asarray(w))

        with mesh:
            y, (gp, gx) = jax.jit(fn)(params, x)
        out[f"{case}|out"] = np.asarray(y)
        out[f"{case}|grad|x"] = np.asarray(gx)
        for k, v in paths(gp).items():
            out[f"{case}|grad|{k}"] = v


def heron_step(out):
    mu, lr, slr, eps = MC.STEP_RATES
    cfg = dataclasses.replace(smoke_config(), forward_impl="kernel")
    mesh = mesh_of(2, 2)
    api = P.lm_api(cfg, AxisRules(mesh=mesh, enable_fsdp=False))
    copt, sopt = zo_sgd(lr), adamw(slr, eps=eps)
    state = P.init_train_state(jax.random.PRNGKey(1),
                               T.init_lm(jax.random.PRNGKey(0), cfg), copt,
                               sopt)
    step = P.make_train_step(api, "heron", Z.ZOConfig(mu=mu,
                                                      scale="gaussian"),
                             copt, sopt)
    with mesh:
        new, m = jax.jit(step)(state, MC.step_batch(cfg.vocab))
    for k, v in paths(new["params"]).items():
        out[f"step|{k}"] = v
    out["step|loss"] = np.asarray(m["loss"])
    out["step|client_loss"] = np.asarray(m["client_loss"])


def main(path):
    """Writes ``path`` when every result is in (atomically: the waiting
    tests poll for it), or ``<path stem>.failed`` with the error."""
    try:
        assert len(jax.devices()) >= 4, jax.devices()
        out = {}
        moe_cases(out)
        heron_step(out)
        tmp = path[:-len(".npz")] + ".tmp.npz"
        np.savez(tmp, **out)
        os.replace(tmp, path)
    except BaseException as e:
        with open(path[:-len(".npz")] + ".failed", "w") as f:
            f.write(repr(e))
        raise


if __name__ == "__main__":
    main(sys.argv[1])
