"""The serving cases of the mesh tests (not a test module; imported by
name).  numpy only: the spawned ranks (``torch_serve_mesh_ranks.py``,
which import the port and nothing of JAX), the JAX reference subprocess
(``jax_serve_reference.py``) and the tests build the same queues from it.

An engine case is ``(tag, arch, model_parallel, capacity factor or
None)``: the arch's smoke config (f32, greedy) served by ``DecodeEngine``
on ``SLOTS`` slots of ``CAPACITY`` tokens in segments of ``SEGMENT`` over
``QUEUE``, the port's params ``init_lm(key=PRNGKey(0))`` (the JAX side
runs the same params, through ``bridge.to_numpy``).  Several slots and
mixed prompt lengths, so admissions, live masks and the slot copy all
run; prompts of 9 tokens pass recurrentgemma's smoke window of 8,
so its local attention's ring cache wraps.  The MoE runs at a capacity
factor of ``n_experts / top_k``: an admission's prefill on the model axis
dispatches each rank's sequence slab at its own capacity (the
reference's sharded program), which then drops nothing, so the mesh
engine's streams are the unsharded engine's.
"""
import numpy as np

SLOTS, CAPACITY, SEGMENT = 4, 24, 4
# (prompt length, max_new) per request: three prompt lengths (the JAX
# engine compiles its admission once a length)
QUEUE = [(5, 9), (9, 3), (3, 12), (9, 5), (5, 2), (3, 6), (9, 4)]
PROMPT_SEED = 3
# world -> [(tag, arch, model_parallel, capacity factor)]
ENGINES = {2: [("qwen_1x2", "qwen2-1.5b", 2, None),
               ("rg_1x2", "recurrentgemma-9b", 2, None),
               ("xlstm_1x2", "xlstm-1.3b", 2, None),
               ("moe_1x2", "qwen3-moe-30b-a3b", 2, 4.0)],
           4: [("qwen_1x4", "qwen2-1.5b", 4, None)]}
# seamless-m4t-medium's token loop (launch/serve.enc_dec_stream): batch,
# prompt length, new tokens
S2S = ("seamless-m4t-medium", 2, 5, 6)
PAD = -2               # pads a ragged stream in its row of an array


def reference_engines():
    """The distinct (arch, capacity factor) of every engine case: one JAX
    engine each."""
    return sorted({(arch, cf) for cases in ENGINES.values()
                   for _, arch, _, cf in cases}, key=str)


def engine_key(arch, cf):
    return f"engine|{arch}|{cf}"


def prompts(vocab):
    rng = np.random.default_rng(PROMPT_SEED)
    return [rng.integers(0, vocab, size=n) for n, _ in QUEUE]


def pad_streams(streams):
    """Ragged token streams -> (n, max_new) int64, ``PAD`` after each."""
    out = np.full((len(streams), max(m for _, m in QUEUE)), PAD, np.int64)
    for i, s in enumerate(streams):
        out[i, :len(s)] = s
    return out


def unpad(a):
    return [[int(t) for t in row if t != PAD] for row in a]


JAX = ("jax_serve", "jax_serve_reference.py")    # start_jax's stem, script


def assert_engine_matches(outs, tag, arch, cf, ref):
    """Every rank's ``serve|engine|<tag>|`` results
    (``torch_serve_mesh_ranks.engine_case``): no failure (the logits
    along the streams held), the mesh engine's greedy streams equal to
    the unsharded engine's, to every other rank's and to the JAX
    package's engine's."""
    want = unpad(ref[engine_key(arch, cf)])
    assert [len(s) for s in want] == [m for _, m in QUEUE]
    for r, out in enumerate(outs):
        fails = str(out[f"serve|engine|{tag}|fail"])
        assert not fails, f"rank {r}:\n{fails}"
        mesh = unpad(out[f"serve|engine|{tag}|mesh"])
        assert mesh == unpad(out[f"serve|engine|{tag}|full"]), r
        assert mesh == want, (r, mesh, want)
