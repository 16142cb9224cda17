"""Continuous-batching decode engine, mirroring :mod:`repro.core.decode`.

* :func:`sample_logits`: the threefry-keyed sampler (greedy /
  temperature / top-k / top-p).  Keys are per request, folded with the
  number of tokens that request has generated, so a request's stream is
  a function of its (prompt, key) alone, whatever slot it occupies and
  whoever shares its batch.  A sampled step draws the Gumbel noise of
  all rows in one pass (:func:`repro_torch.core.prng.categorical_rows`);
  greedy decoding draws nothing.
* :func:`make_segment_decoder`: ``segment_len`` decode steps for the
  whole slot batch.  The JAX package runs them in a ``lax.while_loop``
  that exits once no slot is live; here every segment runs all its steps
  and the host reads the slots' state once at its end, not once a token.
  A step with no live slot writes no cache and emits only ``PAD_ID``, so
  ``out``, ``gen`` and the caches are the ones the early exit gives.
* :class:`DecodeEngine`: a request queue feeding a fixed pool of cache
  slots (``init_serve_caches(..., per_slot=True)``: per-slot ``pos``
  vectors).  Between segments finished slots are drained and refilled
  by a block prefill of the prompt (K5 and K6 on the card) whose caches
  (KV rows, RG-LRU / mLSTM / sLSTM states) are copied into the slot.
* :func:`make_prompt_consume`: the prompt fed one token at a time
  through the serve step: the enc-dec's path (its decoder step
  cross-attends the encoder output), which the engine refuses as the
  reference's does.

Finished slots are frozen: the serve step keeps no cache row of a slot
whose ``live`` is False (the reference rebuilds the whole cache with a
select instead), so the per-step math is the eager ``make_serve_step``
loop's and greedy decoding gives its tokens.  A finished slot still runs
the step as the reference's does (its attention sees the token it feeds,
whose k/v are then discarded): in an MoE block every slot's token is
routed and competes for the experts' capacity, so a finished slot's
hidden state can decide which live tokens an expert drops.

Every piece takes the reference's ``rules``.  On a ("data", "model")
mesh the serve step and the prefill run on the rank's slabs of the
params and the caches and return its vocab slab of the logits; the
sampler reads them gathered over "model"
(:func:`repro_torch.core.protocols.vocab_logits`), so every rank draws
the same token from the same key and feeds it to the next step.  The
engine takes a model axis; its slot batch over "data" is not ported
(ROADMAP 7.6b), so a mesh whose data axis is above 1 raises there.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch.core import prng as R
from repro_torch.core import protocols as P
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves

PAD_ID = -1          # marks "no token emitted" entries in segment output


# ===========================================================================
# sampler
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Decode-time sampling policy.  ``greedy=True`` (or a non-positive
    temperature) is argmax; otherwise logits are divided by
    ``temperature`` and optionally cut to the top-k tokens and / or the
    top-p (nucleus) mass before a threefry-keyed categorical draw."""
    greedy: bool = True
    temperature: float = 1.0
    top_k: int = 0        # 0 disables
    top_p: float = 1.0    # 1.0 disables

    @property
    def draws(self) -> bool:
        return not (self.greedy or self.temperature <= 0.0)


def sample_logits(logits, keys, sampler: SamplerConfig):
    """One token per row of ``logits`` (B, V) f32, already cropped to the
    real vocab; ``keys`` (B, 2): one threefry key per row (the caller
    folds in the request's generated-token count).  Greedy sampling
    reads no key (``keys`` may be None)."""
    if not sampler.draws:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    # a divisor on the device: CUDA multiplies by the reciprocal of a
    # host scalar, which is not the f32 division JAX does
    l = logits / logits.new_full((), max(sampler.temperature, 1e-6))
    neg_inf = float("-inf")
    if sampler.top_k > 0:
        k = min(int(sampler.top_k), l.shape[-1])
        kth = torch.topk(l, k, dim=-1).values[..., -1:]
        l = torch.where(l < kth, neg_inf, l)
    if sampler.top_p < 1.0:
        srt = torch.sort(l, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix whose mass reaches top_p: a token
        # survives iff the mass strictly before it is < top_p (so the
        # most likely token always survives)
        keep = (cum - probs) < sampler.top_p
        thresh = torch.amin(torch.where(keep, srt, float("inf")), dim=-1,
                            keepdim=True)
        l = torch.where(l < thresh, neg_inf, l)
    return R.categorical_rows(keys, l).to(torch.int32)


# ===========================================================================
# one segment of decode steps
# ===========================================================================

def make_segment_decoder(cfg: ModelConfig, sampler: SamplerConfig,
                         segment_len: int,
                         rules: SH.AxisRules | None = None):
    """Returns ``segment(params, caches, tok, live, gen, keys, max_new,
    eos_id) -> (caches, tok, out, live, gen)``.

    ``segment_len`` decode steps for the whole slot batch, the caches
    written in place.  ``out`` is (B, segment_len) int32 with the tokens
    each slot emitted (``PAD_ID`` where the slot was finished).  ``gen``
    counts the tokens generated per request (the prefill's first token
    included); a slot finishes when it emits ``eos_id`` or reaches its
    ``max_new``.  ``rules``: the serve step's on the rank's slabs, its
    logits gathered over "model" before the sampler."""
    serve = P.make_serve_step(cfg, rules)

    def segment(params, caches, tok, live, gen, keys, max_new, eos_id):
        B = tok.shape[0]
        out = torch.full((B, segment_len), PAD_ID, dtype=torch.int32,
                         device=tok.device)
        for s in range(segment_len):
            logits, caches = serve(params, caches, tok, live)
            logits = P.vocab_logits(logits, cfg, rules)
            step_keys = R.fold_in_many(keys, gen) if sampler.draws else None
            nxt = sample_logits(logits[:, -1, :cfg.vocab].to(torch.float32),
                                step_keys, sampler)
            out[:, s] = torch.where(live, nxt, PAD_ID)
            gen = gen + live.to(gen.dtype)
            live = live & ~((nxt == eos_id) | (gen >= max_new))
            # finished slots keep their last token (their caches are
            # frozen, so the value is inert)
            tok = torch.where(live[:, None], nxt[:, None], tok)
        return caches, tok, out, live, gen

    return segment


def make_prompt_consume(cfg: ModelConfig,
                        rules: SH.AxisRules | None = None):
    """``consume(params, caches, prompt) -> (last_logits, caches)``: the
    prompt (B, S) fed one column at a time through the serve step;
    ``last_logits`` (B, 1, vocab_padded) f32 are the logits after its
    last token, the whole vocab (gathered over "model" under
    ``rules``)."""
    serve = P.make_serve_step(cfg, rules)

    def consume(params, caches, prompt):
        last = torch.zeros((prompt.shape[0], cfg.vocab_padded),
                           dtype=torch.float32, device=prompt.device)
        for t in range(prompt.shape[1]):
            logits, caches = serve(params, caches, prompt[:, t:t + 1])
            last = P.vocab_logits(logits, cfg, rules)[:, -1].to(
                torch.float32)
        return last[:, None, :], caches

    return consume


# ===========================================================================
# continuous-batching engine
# ===========================================================================

@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    key: torch.Tensor            # (2,) int64: the request's sample key
    tokens: list = dataclasses.field(default_factory=list)
    submit_seg: int = 0
    finish_seg: int = 0


class DecodeEngine:
    """Continuous-batching serving engine: a fixed pool of ``slots``
    cache slots of ``capacity`` tokens each, fed from a request queue.
    Per :meth:`step`: free slots are refilled (block prefill, caches
    copied into the slot), one ``segment_len``-step decode segment runs
    for the whole pool, then finished slots are drained.  The slots'
    state (last token, liveness, generated count, key, budget) lives on
    the device; the host reads it after each admission and each
    segment.

    ``rules`` with a model axis (the reference's ``DecodeEngine(params,
    cfg, rules)``): ``params`` are this rank's slabs
    (``T.param_shardings(cfg, rules)``), every rank of the model group
    runs the engine on the same queue, and its caches, prefill and steps
    hold and read the rank's slabs; every rank emits the same tokens.
    A data axis above 1 raises: the slot batch over "data" is not
    ported (ROADMAP 7.6b)."""

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 8,
                 capacity: int = 64, segment_len: int = 32,
                 sampler: SamplerConfig = SamplerConfig(),
                 eos_id: int = -1, seed: int = 0, device="cuda",
                 rules: SH.AxisRules | None = None):
        P._decoder_only(cfg, "DecodeEngine")
        rules = P._mesh_rules(rules)
        if rules is not None and rules.mesh.shape.get("data", 1) > 1:
            raise NotImplementedError(
                "DecodeEngine on a data axis above 1: the slot batch over "
                "\"data\" is not ported (ROADMAP 7.6b); the serve step and "
                "the prefill take data x model")
        self.device = dev = resolve_device(device)
        self.params, self.cfg, self.rules = params, cfg, rules
        self.slots, self.capacity = int(slots), int(capacity)
        self.segment_len = int(segment_len)
        self.sampler = sampler
        self.eos_id = int(eos_id)
        self._base_key = R.PRNGKey(seed)
        self._segment = make_segment_decoder(cfg, sampler, self.segment_len,
                                             rules)

        self.caches = P.init_serve_caches(cfg, self.slots, self.capacity,
                                          per_slot=True, device=dev,
                                          rules=rules)
        self.tok = torch.zeros((self.slots, 1), dtype=torch.int32,
                               device=dev)
        self.live = torch.zeros((self.slots,), dtype=torch.bool, device=dev)
        self.gen = torch.zeros((self.slots,), dtype=torch.int32, device=dev)
        self.keys = torch.zeros((self.slots, 2), dtype=torch.int64,
                                device=dev)
        self.max_new = torch.zeros((self.slots,), dtype=torch.int32,
                                   device=dev)

        self._queue: collections.deque[Request] = collections.deque()
        self._slot_req: list[Request | None] = [None] * self.slots
        self._next_rid = 0
        self.finished: dict[int, Request] = {}
        self.segments = 0
        self.prefill_tokens = 0
        self.decoded_tokens = 0

    # -- request lifecycle -------------------------------------------------

    def submit(self, prompt, max_new: int, key=None) -> int:
        """Enqueue a request; returns its id.  ``key`` (a PRNG key, see
        :func:`repro_torch.core.prng.as_key`) seeds this request's
        sampler stream; it defaults to ``fold_in(PRNGKey(seed), rid)``."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.size + int(max_new) > self.capacity:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new ({max_new}) exceeds "
                f"slot capacity {self.capacity}")
        rid = self._next_rid
        self._next_rid += 1
        key = R.fold_in(self._base_key, rid) if key is None else R.as_key(key)
        self._queue.append(Request(rid, prompt, int(max_new), key,
                                   submit_seg=self.segments))
        return rid

    @property
    def pending(self) -> bool:
        return bool(self._queue) or any(
            r is not None for r in self._slot_req)

    def _finish(self, req: Request):
        req.finish_seg = self.segments
        self.finished[req.rid] = req

    def _admit_one(self, slot: int, req: Request) -> int:
        """Block-prefill the prompt into fresh batch-1 caches, sample the
        first token with the request's ``fold_in(key, 0)``, copy the
        caches into the slot (KV rows, recurrent state and ``pos``) and
        set the slot's state.  The slot goes live only if the first token
        is not EOS and the budget allows more.  Returns the first token.
        The batch-1 caches are built under the engine's rules, so their
        leaves are the slot caches' in the same order."""
        cfg, dev, rules = self.cfg, self.device, self.rules
        tmp = P.init_serve_caches(cfg, 1, self.capacity, per_slot=True,
                                  device=dev, rules=rules)
        prompt = torch.as_tensor(req.prompt, device=dev)[None, :]
        x = P.decoder_hidden(self.params, cfg, tmp, prompt, rules=rules)
        # the head on the last position only: the reference's logits
        # [:, -1] of the whole prompt's, without the (S, vocab) f32 block
        logits = P.vocab_logits(T.lm_head(self.params, cfg, x[:, -1:],
                                          rules), cfg, rules)
        key0 = (R.fold_in(req.key, 0)[None].to(dev) if self.sampler.draws
                else None)
        first = sample_logits(logits[:, -1, :cfg.vocab].to(torch.float32),
                              key0, self.sampler)
        for m, t in zip(tree_leaves(self.caches), tree_leaves(tmp)):
            m[:, slot] = t[:, 0]
        self.tok[slot] = first
        self.live[slot] = (first[0] != self.eos_id) & (req.max_new > 1)
        self.gen[slot] = 1
        self.keys[slot] = req.key.to(dev)
        self.max_new[slot] = req.max_new
        return int(first[0])

    def _admit(self):
        for slot in range(self.slots):
            if not self._queue:
                break
            if self._slot_req[slot] is not None:
                continue
            req = self._queue.popleft()
            first = self._admit_one(slot, req)
            req.tokens.append(first)
            self.prefill_tokens += int(req.prompt.size)
            self.decoded_tokens += 1
            # the host's copy of the slot's liveness: a request that hit
            # EOS or its budget on the prefill token never occupies the
            # slot, so the next admission reuses it
            if first == self.eos_id or req.max_new <= 1:
                self._finish(req)
                continue
            self._slot_req[slot] = req

    def step(self) -> list[Request]:
        """One admission + segment + drain cycle.  Returns the requests
        that finished during it."""
        before = len(self.finished)
        with torch.inference_mode():
            self._admit()
            if any(r is not None for r in self._slot_req):
                self._decode_segment()
        return list(self.finished.values())[before:]

    def _decode_segment(self):
        self.caches, self.tok, out, self.live, self.gen = self._segment(
            self.params, self.caches, self.tok, self.live, self.gen,
            self.keys, self.max_new, self.eos_id)
        self.segments += 1
        out_h = out.cpu().numpy()
        live_h = self.live.cpu().numpy()
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            emitted = [int(t) for t in out_h[slot] if t != PAD_ID]
            req.tokens.extend(emitted)
            self.decoded_tokens += len(emitted)
            if not live_h[slot]:
                self._finish(req)
                self._slot_req[slot] = None

    def run(self) -> dict[int, list]:
        """Drain the queue; returns ``{rid: generated tokens}`` (prompt
        excluded, EOS included when emitted)."""
        while self.pending:
            self.step()
        return {rid: req.tokens for rid, req in self.finished.items()}
