"""The expert-parallel MoE cases of the mesh tests (not a test module;
imported by name).  numpy only: the spawned ranks (which import the port
and nothing of JAX), the JAX reference subprocess
(``jax_moe_ep_reference.py``) and the tests build the same inputs from
it.

A case is ``(mesh, capacity factor, shared experts, (B, S))`` on a
one-layer MoE of width ``D_MODEL`` with ``N_EXPERTS`` experts, top
``TOP_K``; its inputs are the layer's params, x and the cotangent ``w``
of the scalar ``sum(out * w)`` whose gradients the tests hold, all from
a numpy seed.  ``moe_ep`` takes the expert exchange where the model axis
is wider than 1 and divides S and the data axis divides B; the others
are the global view (``moe_xla`` on the whole batch).
"""
import fcntl
import os
import subprocess
import sys
import time
import zlib

import numpy as np

D_MODEL, N_EXPERTS, TOP_K, D_FF = 32, 8, 2, 16
# name -> ((n_data, n_model), capacity factor, shared experts, (B, S))
CASES = {
    "2x2_cf1": ((2, 2), 1.0, 0, (4, 16)),
    "2x2_cf8": ((2, 2), 8.0, 0, (4, 16)),
    "2x2_shared": ((2, 2), 1.0, 1, (4, 16)),
    "2x2_seq15": ((2, 2), 1.0, 0, (4, 15)),      # global view: S % 2
    "2x2_batch3": ((2, 2), 1.0, 0, (3, 16)),     # global view: B % 2
    "1x2_cf1": ((1, 2), 1.0, 0, (2, 16)),
    "1x2_shared": ((1, 2), 1.0, 1, (2, 16)),
    "2x1_cf1": ((2, 1), 1.0, 0, (4, 16)),        # global view, data split
    "2x1_batch3": ((2, 1), 1.0, 0, (3, 16)),     # global view, replicated
}
# the cases that drop entries (capacity factor 1.0 on an exchange or a
# split data axis) and the one that drops none
DROPS = ("2x2_cf1", "1x2_cf1", "2x1_cf1")
NO_DROPS = ("2x2_cf8",)


def world_cases(world):
    """The cases of a spawn of ``world`` ranks."""
    return [c for c, (m, *_) in CASES.items() if m[0] * m[1] == world]


def inputs(case):
    """``(params, x, w)`` of ``case`` as float32 numpy arrays: params in
    the layer's tree (``router``, ``up``, ``gate``, ``down`` and, with a
    shared expert, ``shared`` as a gated MLP of ``{"w"}`` dicts)."""
    _, _, shared, (B, S) = CASES[case]
    g = np.random.default_rng(zlib.crc32(case.encode()))
    d, E, f = D_MODEL, N_EXPERTS, D_FF

    def normal(shape, scale):
        return (scale * g.standard_normal(shape)).astype(np.float32)

    params = {"router": normal((d, E), 0.3),
              "up": normal((E, d, f), d ** -0.5),
              "gate": normal((E, d, f), d ** -0.5),
              "down": normal((E, f, d), f ** -0.5)}
    if shared:
        fs = shared * f
        params["shared"] = {"up": {"w": normal((d, fs), d ** -0.5)},
                            "gate": {"w": normal((d, fs), d ** -0.5)},
                            "down": {"w": normal((fs, d), fs ** -0.5)}}
    return params, normal((B, S, d), 1.0), normal((B, S, d), 1.0)


def flat(tree, prefix=""):
    """``{path: array}`` of a nested dict of arrays."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, p) if isinstance(v, dict) else {p: v})
    return out


# the HERON step on qwen3-moe-30b-a3b's smoke config held against the
# reference's jitted step on the (2, 2) mesh: a 4 x 16 batch (the data
# axis splits it in two rows a rank, the model axis the sequence in 8
# tokens) from a numpy seed; mu, client lr, server lr, AdamW eps
STEP_RATES = (1e-2, 1e-3, 1e-4, 1e-6)


def step_batch(vocab):
    g = np.random.default_rng(27)
    return {k: g.integers(0, vocab, (4, 16)).astype(np.int32)
            for k in ("inputs", "labels")}


# the port's moe_ep against the reference's, f32: the router's softmax and
# the expert products sum in other orders (XLA's fused einsums, torch's
# bmm), a few ulps of the largest entries (|out| and the gradients reach
# ~10; measured up to 9.6e-6)
TOL = dict(rtol=1e-5, atol=2e-5)
JAX_TIMEOUT_S = 240
HERE = os.path.dirname(os.path.abspath(__file__))
_STARTED = []          # the reference subprocess this worker started


def _paths(tmp_path_factory, stem="jax_moe_ep"):
    """A reference script's results, log and lock in the session's shared
    temporary directory (pytest-xdist's workers share the parent of their
    base temporary directories)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    return (root / f"{stem}.npz", root / f"{stem}.log",
            root / f"{stem}.lock")


def start_jax(tmp_path_factory, stem="jax_moe_ep",
              script="jax_moe_ep_reference.py"):
    """Start a JAX reference script (by default ``jax_moe_ep_reference.py``,
    one subprocess on 4 forced host devices) in the background, once a
    session: the first caller under the file lock starts it, later
    callers find its log.  A spawning fixture calls it first, so the two
    overlap."""
    path, log, lock = _paths(tmp_path_factory, stem)
    with open(lock, "a") as held:
        fcntl.flock(held, fcntl.LOCK_EX)
        if log.exists():
            return
        env = {**os.environ, "JAX_PLATFORMS": "cpu",
               "PYTHONPATH": os.path.join(HERE, "..", "src"),
               "XLA_FLAGS": (os.environ.get("XLA_FLAGS", "") +
                             " --xla_force_host_platform_device_count"
                             "=4").strip()}
        with open(log, "w") as out:
            _STARTED.append(subprocess.Popen(
                [sys.executable, os.path.join(HERE, script), str(path)],
                env=env, stdout=out, stderr=subprocess.STDOUT))


def jax_results(tmp_path_factory, stem="jax_moe_ep",
                script="jax_moe_ep_reference.py"):
    """A reference script's results (``start_jax``'s subprocess, started
    here if no worker has): waits for its file, or fails with its log
    when it failed or outlives ``JAX_TIMEOUT_S``."""
    start_jax(tmp_path_factory, stem, script)
    path, log, _ = _paths(tmp_path_factory, stem)
    failed = path.with_suffix(".failed")
    deadline = time.monotonic() + JAX_TIMEOUT_S
    while not path.exists():
        assert not failed.exists() and time.monotonic() < deadline, \
            log.read_text()[-3000:]
        time.sleep(0.5)
    return dict(np.load(path))


def assert_ranks_match(outs, case, ref):
    """Each rank's ``moe|<case>|`` results (``torch_train_mesh_ranks.
    moe_case``) against the reference's ``moe_ep`` at ``TOL``: its rows of
    the output and of x's gradient, each param slab's gradient; the
    dropped entries of the distinct slabs equal ``moe_ep_plain``'s, > 0
    in ``DROPS`` and 0 in ``NO_DROPS``."""
    key = f"moe|{case}"
    for r, out in enumerate(outs):
        r0, r1 = out[f"{key}|rows"]
        for name in ("out", "grad|x"):
            np.testing.assert_allclose(out[f"{key}|{name}"],
                                       ref[f"{case}|{name}"][r0:r1],
                                       err_msg=f"rank {r} {name}", **TOL)
        grads = [k for k in out if k.startswith(f"{key}|grad|")
                 and k != f"{key}|grad|x"]
        assert len(grads) == len([k for k in ref if k.startswith(
            f"{case}|grad|")]) - 1
        for k in grads:
            path = k[len(f"{key}|grad|"):]
            cut = tuple(slice(a, b) for a, b in out[f"{key}|bounds|{path}"])
            np.testing.assert_allclose(
                out[k], ref[f"{case}|grad|{path}"][cut],
                err_msg=f"rank {r} {path}", **TOL)
        got, plain = out[f"{key}|drops"]
        assert got == plain, (r, got, plain)
        if case in DROPS:
            assert got > 0, (r, case)
        if case in NO_DROPS:
            assert got == 0, (r, case, got)


def assert_step_matches(out, case, ref, start):
    """The params a rank gathered from the MoE HERON step (``<case>|full|``
    keys) against the reference's sharded step (``step|`` keys) at
    ``PARAM_TOL``; the client moved from ``start`` ({path: array})."""
    prefix = f"{case}|full|"
    got = {k[len(prefix):]: v for k, v in out.items()
           if k.startswith(prefix)}
    want = {k[len("step|"):]: v for k, v in ref.items()
            if k.startswith("step|") and k not in ("step|loss",
                                                   "step|client_loss")}
    assert sorted(got) == sorted(want)
    for path, v in want.items():
        np.testing.assert_allclose(got[path], v, err_msg=path,
                                   rtol=2e-5, atol=1e-6)
    assert any(not np.array_equal(v, start[p]) for p, v in want.items()
               if p.startswith("client/"))
