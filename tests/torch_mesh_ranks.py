"""The ranks of ``tests/test_torch_replay_mesh.py``'s multi-rank cases
(not a test module; imported by name in each spawned process, so it
imports ``repro_torch`` and nothing of JAX or :mod:`repro`).

Each rank joins a gloo group on a ``FileStore``, reads the inputs the
test wrote (``inputs.npz``), runs every case in one process and writes
its results to ``rank<r>.npz``; the test compares them with the JAX
package's results and with rank 0's."""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves_with_path


def flatten(tree, prefix):
    """``{prefix|path: array}`` of a tree of tensors or arrays."""
    return {f"{prefix}|{p}": (t.detach().cpu().numpy()
                              if isinstance(t, torch.Tensor) else
                              np.asarray(t))
            for p, t in tree_leaves_with_path(tree)}


def unflatten(flat, prefix, to=torch.tensor):
    """The tree :func:`flatten` wrote under ``prefix`` (a dict whose keys
    are all digits is a list)."""
    root = {}
    for k, v in flat.items():
        name, _, path = k.partition("|")
        if name != prefix:
            continue
        node, parts = root, path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = to(v)

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(root)


def aggregate_cases(inp, out):
    """The reference's ``_SHARDED_PROG`` on the port: n = 7 clients, h =
    2, n_pairs = 2, masked and unmasked, threefry and kernel streams:
    the flat walk, ``shard="clients"`` and ``shard + chunk=3``, and the
    sharded walk with the masked client's coefficients poisoned."""
    from repro_torch.core import aggregate as AG
    from repro_torch.core import zo as Z
    from repro_torch.distributed.mesh import make_replay_mesh

    mesh = make_replay_mesh()
    params = unflatten(inp, "agg_params")
    keys, seeds = inp["keys"], [int(s) for s in inp["seeds"]]
    coeffs = torch.as_tensor(inp["coeffs"])
    poisoned = torch.as_tensor(inp["poisoned"])
    lr, zo = float(inp["lr"]), Z.ZOConfig(mu=1e-3, n_pairs=2)
    for stream in ("threefry", "kernel"):
        if stream == "threefry":
            def agg(c, m, **kw):
                return AG.seed_replay_aggregate(params, keys, c, lr, zo, m,
                                                **kw)
        else:
            def agg(c, m, **kw):
                return AG.seed_replay_aggregate_kernel(params, seeds, c, lr,
                                                       m, **kw)
        for mname, m in (("none", None), ("mask", torch.as_tensor(
                inp["mask"]))):
            tag = f"{stream}_{mname}"
            out.update(flatten(agg(coeffs, m), f"{tag}_flat"))
            out.update(flatten(agg(coeffs, m, shard="clients", mesh=mesh),
                               f"{tag}_shard"))
            out.update(flatten(agg(coeffs, m, shard="clients", mesh=mesh,
                                   chunk=3), f"{tag}_shard_c3"))
        # the mesh from the default group (mesh=None), poisoned coeffs
        out.update(flatten(agg(poisoned, torch.as_tensor(inp["mask"]),
                               shard="clients"), f"{stream}_mask_poison"))


def round_cases(inp, out):
    """The seed-replay round on the small CNN (threefry sphere) unsharded
    and sharded, and the async round at ``buffer_k=0`` unsharded, sharded
    and chunked, from the same state, batches and key."""
    from repro_torch.core import protocols as P
    from repro_torch.core import zo as Z
    from repro_torch.models import cnn as CNN
    from repro_torch.optim import optimizers as OPT

    cfg = CNN.CNNConfig(widths=(8, 16), blocks_per_stage=1, classes=4,
                        client_blocks=1)
    api = P.cnn_api(cfg)
    params = unflatten(inp, "cnn_params")
    rb = {k: torch.as_tensor(inp[f"rb_{k}"]) for k in ("inputs", "labels")}
    key = inp["round_key"]
    mu, lr, slr = (float(x) for x in inp["round_rates"])
    n, h = (int(x) for x in inp["round_nh"])
    zo = Z.ZOConfig(mu=mu, scale="sphere")
    fed = P.FedConfig(n_clients=n, h=h)
    copt, sopt = OPT.zo_sgd(lr), OPT.adamw(slr)

    def state():
        return {"client": params["client"], "server": params["server"],
                "opt_server": sopt.init(params["server"])}

    for tag, kw in (("round_ref", {}), ("round", dict(
            replay_shard="clients"))):
        new, _ = P.make_fed_round(api, "heron", zo, fed, copt, sopt,
                                  uplink="seed_replay", client_lr=lr,
                                  **kw)(state(), rb, key)
        out.update(flatten(new, tag))
    for tag, kw in (("async_ref", {}),
                    ("async_shard", dict(replay_shard="clients")),
                    ("async_chunk", dict(replay_chunk=2))):
        new, m = P.make_async_round(api, "heron", zo, fed, copt, sopt,
                                    client_lr=lr, **kw)(state(), rb, key)
        assert m["flushes"] == 1.0
        out.update(flatten(new, tag))


def run_rank(rank, world, workdir):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
        out = {}
        aggregate_cases(inp, out)
        if world == 2:
            round_cases(inp, out)
        blocked = sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "repro"))
        assert not blocked, blocked
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
