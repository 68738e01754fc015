"""Batched serving engine: prefill + greedy decode over the unified LM API,
plus the ranking read-outs a model oracle needs (score / compare /
rank-window / yes-no), all funneled through ONE probe pathway
(:meth:`ServeEngine.submit_probes`) so a round of independent logical calls
costs a single padded prefill submission (``stats.calls`` counts
submissions).

Counterpart of ``src/repro/serving/engine.py``.  The engine takes an ``LM``
that owns its parameters (the reference passes ``params`` beside it) and runs
eagerly under ``torch.inference_mode()``; there are no compiled programs, and
the arena is updated in place where the reference donates it through a jitted
step.

``mesh=`` (a ``("data", "model")`` DeviceMesh, one process per device, every
process running the same engine calls) serves the same work SPMD: this
process holds its slice of the parameters (``LM.sharded``, with ``plan``'s
``fsdp``) and of the arena (kv-heads over ``model``), probe and decode
submissions are cut into contiguous per-data-shard row slices (``_put_rows``;
``dp_probe_slices=False`` keeps every row on every process), the model runs
tensor-parallel over ``model`` under ``distributed.context.shard_context``,
and logits and every row's new K/V are gathered back over the data axes, so
the host-side scheduling, allocator and prefix LRU make the same decisions on
every process and the arena stays replicated over the data axes.  With a
model axis of 1 results are bitwise the single-device engine's; above 1 the
row-parallel sums reorder additions (``TP_PSUM_RTOL`` / ``TP_PSUM_ATOL``).
Archs
whose input is not plain tokens get their batches as the reference's stub
frontends make them: ``embeds`` archs the prompt bytes through the text
embedding table, encoder-decoder archs that as the encoder's input beside the
tokens.  They, MoE, windowed and recurrent stacks and ``attn_impl="qchunk"``
take monolithic prefill and the lockstep decode loop.

Prompts are byte-tokenized and left-padded.  Submission shapes are bucketed
to powers of two: the model has no PAD attention mask, so a row's padded
length class is part of its result, and grouping rows by class makes a row's
logits a function of its own prompt only.  Read-outs follow standard
logit-probe practice:

 * score(text)      -> logit('9') - logit('0') after a "Rating:" prompt,
 * compare(a, b)    -> logit('A') vs logit('B') after a comparison prompt,
 * rank_window(ks)  -> scores computed in one shared-prefix batch.

Prefix-KV cache: probe prompts arrive as ``(shared_prefix, per_key_suffix)``
pairs (plain strings still work, uncached).  The engine prefills each
distinct ``(prefix token ids, absolute start position)`` region ONCE, holds
its per-layer KV in an LRU, and runs suffix-only prefill on top of the
broadcast cached KV.  Keying the cache on the absolute start position
(equivalently the PAD count of the row's padded-length class) keeps cached
execution equal to monolithic prefill.

Paged continuous-batching decode: all serve-side KV lives in ONE block-paged
pool (serving/kv_pool.py).  Prefix-cache entries are pinned block runs, and
``generate`` runs a continuous step loop (``paged_admit`` / ``paged_step``)
instead of a padded lockstep batch: every active row decodes each step at
its OWN position, finished rows retire and free their blocks immediately,
and queued requests are admitted into the vacated slots between steps.  Each
row prefills at its own padded-length class.

Probe submissions are pool citizens too: their transient prompt KV holds a
block *lease* for the duration of the forward pass, and
``prefetch_prefixes`` exposes region warming as a schedulable primitive.
The decode step's attention has a deployment-time switch (``paged_kernel``):
``False`` runs the dense gather+attend path, ``True`` the CUDA paged
attention kernel (allclose at PAGED_KERNEL_RTOL/ATOL), ``"check"`` runs both
and asserts.
"""
from __future__ import annotations

import contextlib
import itertools
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import trace
from ..data.tokenizer import EOS, PAD, ByteTokenizer
from ..device import resolve_device
from ..distributed.context import gather_over, shard_context
from ..distributed.sharding import (ShardingPlan, axes_coord, axes_size,
                                    data_axes, rows_spec)
from ..models.layers import KVCache, paged_write_index
from ..models.model import LM
from .kv_pool import KVBlockPool, PoolExhausted
from .locality import plan_window_jobs

TOK_A, TOK_B = ord("A"), ord("B")
TOK_HI, TOK_LO = ord("9"), ord("0")
TOK_YES, TOK_NO = ord("Y"), ord("N")

# Paged attention kernel vs the dense gather+attend path: the kernel's
# online-softmax reduction order differs from the dense softmax (and the
# kernel keeps its softmax weights and accumulator in fp32 where the dense
# path casts weights back to the cache dtype), so per-step logits agree to
# these tolerances, not bitwise.  On bf16 stacks the drift is about one bf16
# ulp through the residual stream, large in RELATIVE terms only on near-zero
# logits, so the bound is absolute-dominated; pure-fp32 stacks land near
# 1e-6.  The values are the reference's.
PAGED_KERNEL_RTOL = 5e-2
PAGED_KERNEL_ATOL = 1.2e-1

# Tensor-parallel serving (mesh with model axis > 1): the row-parallel
# contractions (wo, w_down) become sums over the model group whose order
# differs from the single-device product, so probe logits drift by about one
# bf16 ulp through the residual stream.  Greedy argmax agreement holds;
# data-parallel-only meshes (model == 1) never reduce across processes and
# keep bitwise identity.  The values are the reference's.
TP_PSUM_RTOL = 5e-2
TP_PSUM_ATOL = 1.2e-1

# a probe prompt: plain string, or a (shared_prefix, per_key_suffix) pair
# (the full prompt is the concatenation; the pair form additionally enables
# prefix-KV reuse)
Prompt = Union[str, tuple]


# ---- logit read-outs ------------------------------------------------------
def read_score(logits) -> float:
    return float(logits[TOK_HI] - logits[TOK_LO])


def read_compare(logits) -> int:
    return 1 if logits[TOK_A] > logits[TOK_B] else -1


def read_yes_no(logits) -> bool:
    return bool(logits[TOK_YES] > logits[TOK_NO])


@dataclass
class ServeStats:
    prefill_tokens: int = 0
    decode_tokens: int = 0
    # physical row-slots occupied across decode steps (padded batch rows per
    # step, whether or not the row produced a useful token)
    decode_row_steps: int = 0
    calls: int = 0
    # prefix-KV cache counters: hits/misses are per entry lookup;
    # fill_submissions counts the region-length groups (and chunks of
    # max_probe_batch) that the reference prefills one forward each (kept
    # out of ``calls``, which counts PROBE submissions); the forwards the
    # port runs, several lengths in one, are the trace counter
    # ``engine.fill_forwards``.  tokens_saved is the padded prefill token
    # count avoided vs monolithic whole-prompt submissions, net of fill
    # costs, both as the reference counts them.
    prefix_hits: int = 0
    prefix_misses: int = 0
    prefix_fill_submissions: int = 0
    prefix_tokens_saved: int = 0
    # probe-submission row occupancy: ``probe_rows`` counts live prompts,
    # ``probe_row_slots`` the padded rows actually prefilled
    probe_rows: int = 0
    probe_row_slots: int = 0
    # probe-row pool citizenship (see _lease_probe_blocks)
    probe_blocks_leased: int = 0
    probe_lease_shortfalls: int = 0
    # multi-tenant serving: preemption traffic and starvation accounting.
    # The starvation counters are bumped by the scheduler.
    preempt_suspends: int = 0
    preempt_resumes: int = 0
    preempt_blocks_stashed: int = 0
    probe_rounds_deferred: int = 0
    starved_rounds: int = 0
    starved_admissions: int = 0
    # data-parallel probe slicing (mesh serving): submissions whose rows
    # were cut into per-data-shard slices, vs submissions that stayed
    # replicated (fewer rows than shards, or dp_probe_slices=False)
    dp_sharded_submissions: int = 0
    dp_replicated_submissions: int = 0

    @property
    def prefix_hit_rate(self) -> float:
        total = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / total if total else 0.0


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def _map_caches(fn, caches: list) -> list:
    """Apply ``fn(leaf)`` to every leaf of a per-stack list of KVCache."""
    return [KVCache(*(fn(leaf) for leaf in c)) for c in caches]


@dataclass
class PrefixEntry:
    """One prefix-cache region: ``PAD*pad + prefix`` at positions
    [0, length).  Pool-backed entries hold their KV as a pinned block run
    (``blocks``, one LRU-owned reference); when the pool is absent or full,
    ``caches`` holds the dense per-stack KV directly.  ``prefetched`` marks
    a region that ``prefetch_prefixes`` filled while a profiler recorded,
    until a probe submission first looks it up."""
    length: int
    blocks: Optional[list] = None
    caches: Optional[list] = None
    prefetched: bool = False


@dataclass
class _PagedRow:
    """One in-flight continuous-batching decode row."""
    rid: int
    cls: int                 # padded prompt class == prefill length
    limit: int               # greedy decode budget (tokens to emit)
    blocks: list             # ordered block run: shared prefix + private
    n_shared: int            # leading blocks borrowed from a PrefixEntry
    cur: int                 # next token to record (already generated)
    t: int = 0               # decode steps taken
    emitted: list = field(default_factory=list)


@dataclass
class SuspendedRow:
    """A preempted decode row evicted to host memory: everything needed to
    re-admit it with identical continuation.  The stash holds the row's FULL
    block run (shared prefix included: the resumed row owns private copies);
    no pool references are held while suspended."""
    rid: int
    cls: int
    limit: int
    cur: int
    t: int
    emitted: list
    n_blocks: int
    stash: list              # KVBlockPool.stash_blocks payload


class ServeEngine:
    def __init__(self, lm: LM, max_new_tokens: int = 32,
                 bucket_shapes: bool = True, max_probe_batch: int = 256,
                 prefix_cache_size: int = 64, pool_blocks: int = 768,
                 block_size: int = 16, max_decode_rows: int = 32,
                 paged_kernel: object = False, locality: bool = True,
                 device=None, mesh=None, plan: Optional[ShardingPlan] = None,
                 dp_probe_slices: bool = True):
        self.device = resolve_device(device)
        if lm.device != self.device:
            raise ValueError(f"the model lies on {lm.device} but the engine "
                             f"was asked to run on {self.device}")
        # Sharded serving: this process's slice of the parameters, and the
        # data-parallel row split of every submission (see _put_rows)
        self.mesh = mesh
        self.plan = plan
        self._daxes: tuple = ()
        self.data_shards = 1
        self.dp_probe_slices = dp_probe_slices
        self.lm = lm
        if mesh is not None:
            self.plan = plan = plan if plan is not None else ShardingPlan()
            self._daxes = data_axes(mesh)
            self.data_shards = axes_size(mesh, self._daxes)
            self.lm = lm.sharded(mesh, plan)
        self.tok = ByteTokenizer()
        assert lm.cfg.vocab_size >= self.tok.vocab_size, (
            f"model vocab {lm.cfg.vocab_size} < tokenizer vocab "
            f"{self.tok.vocab_size}: special ids would index out of range")
        self.max_new = max_new_tokens
        # Shape bucketing: round (rows, seq_len) of every submission up to the
        # next power of two.  Dummy rows are all-PAD and their logits are
        # discarded.  The padded-length class is part of a row's result (the
        # model has no PAD mask), so this is kept although nothing is
        # compiled per shape here.
        self.bucket_shapes = bucket_shapes
        # Memory ceiling for one probe submission: a round of N logical
        # calls becomes ceil(N / max_probe_batch) submissions.
        self.max_probe_batch = max_probe_batch
        # Prefix-KV cache: LRU of per-layer KV for distinct
        # (prefix token ids, absolute start position) regions; 0 disables.
        self.prefix_cache_size = prefix_cache_size
        self.prefix_cache_enabled = (
            prefix_cache_size > 0 and self._supports_prefix_cache())
        self._prefix_lru: OrderedDict[tuple, PrefixEntry] = OrderedDict()
        # Locality-creating probe scheduling (serving/locality.py); False
        # restores the reactive scheme (one class-global window job).
        self.locality = locality
        # Block-paged KV pool + continuous-batching decode; pool_blocks=0
        # disables and generate() falls back to the lockstep loop.
        self.max_decode_rows = max_decode_rows
        self.block_size = block_size
        self.paged_enabled = pool_blocks > 0 and self._supports_prefix_cache()
        self.pool: Optional[KVBlockPool] = (
            KVBlockPool(lm, pool_blocks, block_size, device=self.device,
                        mesh=mesh)
            if self.paged_enabled else None)
        self._paged_rows: dict[int, _PagedRow] = {}
        self._paged_finished: dict[int, str] = {}
        self._paged_ids = itertools.count()
        self.stats = ServeStats()
        # Deployment-time switch for the decode step's attention:
        #   False   - dense gather+attend (the default),
        #   True    - kernels/paged_attention.py (online-softmax reduction
        #             order: allclose at PAGED_KERNEL_RTOL/ATOL),
        #   "check" - run BOTH each step, assert allclose, keep the dense
        #             result (deployment validation mode).
        self.paged_kernel = paged_kernel
        if paged_kernel and mesh is not None:
            # the kernel attends one process's rows through block tables
            # whose K/V every data shard must also write; a sharded engine
            # decodes through the dense paged path, as the reference's does
            raise ValueError(
                "paged_kernel is not supported on a sharded engine "
                "(mesh=...): use the dense paged path")
        if paged_kernel and not self.paged_enabled:
            # an inert validation/deployment switch is worse than an error:
            # the operator would believe the kernel was validated when it
            # never ran a single step
            raise ValueError(
                f"paged_kernel={paged_kernel!r} requires a paged-capable "
                f"engine (pool_blocks > 0 and a pure full-attention "
                f"token-input stack); this arch/config falls back to "
                f"lockstep decode, so the kernel would never execute")

    # ------------------------------------------------------ model programs
    def _prefill(self, batch):
        return self.lm.prefill(batch, reserve=self.max_new)

    def _prefill_exact(self, batch):
        # prefix regions need exact-length caches (reserve=0) so the suffix
        # lands at the right absolute positions
        return self.lm.prefill(batch, reserve=0)

    def _decode_paged(self, toks, pos, tables, impl: str):
        """One decode step over every active row (padded).  On a mesh each
        process decodes its row slice, writes every row's K/V (the step's
        whole write index) and gets every row's logits back."""
        split = self._split_rows(toks.shape[0])
        windex = None
        if split:
            windex = paged_write_index(tables, pos, self.block_size)
            toks, pos, tables = (self._cut(t, split) for t in (toks, pos, tables))
        with self._sharded(split):
            logits, arenas = self.lm.decode_step_paged(
                self.pool.arenas, toks, pos, tables, block_size=self.block_size,
                impl=impl, write_index=windex)
        return self._gather(logits, split), arenas

    def _supports_prefix_cache(self) -> bool:
        # every layer's output for a row must be a pure function of that row
        # and its own sequence: einsum/bf16 attention maps 1:1 onto the
        # continued prefill; anything else falls back to monolithic prefill
        cfg = self.lm.cfg
        return (cfg.input_mode == "tokens" and not cfg.enc_pattern
                and not cfg.mrope_sections
                and cfg.attn_impl in ("einsum", "bf16")
                and all(kind == "attn" for kind, _ in cfg.pattern))

    # ------------------------------------------------------------- tokenize
    def _pad_class(self, length: int) -> int:
        return _next_pow2(max(length, 16)) if self.bucket_shapes else length

    def _pad_ids(self, ids: Sequence[Sequence[int]],
                 maxlen: Optional[int] = None) -> np.ndarray:
        """Left-pad token-id rows into a (rows, maxlen) array, bucketing both
        dims to powers of two when ``bucket_shapes``."""
        if maxlen is None:
            maxlen = max(len(i) for i in ids)
            if self.bucket_shapes:
                maxlen = _next_pow2(max(maxlen, 16))
        rows = len(ids)
        if self.bucket_shapes:
            rows = _next_pow2(rows)
        arr = np.full((rows, maxlen), PAD, np.int32)
        for r, i in enumerate(ids):
            arr[r, maxlen - len(i):] = i          # left-pad: last pos = live
        return arr

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    # ------------------------------------------------ data-parallel rows
    def _split_rows(self, n_rows: int, count: bool = False) -> bool:
        """Is a submission of ``n_rows`` padded rows cut into contiguous
        per-data-shard slices?  Row counts are bucketed to powers of two, so
        any submission at or above the shard count divides; smaller ones,
        and every one under ``dp_probe_slices=False``, stay replicated.
        Identity argument: a row's logits depend only on its own padded
        sequence, so slicing the row dim never changes bits."""
        if self.mesh is None:
            return False
        split = (self.dp_probe_slices
                 and rows_spec(n_rows, 1, self.mesh)[0] is not None)
        if count:
            if split:
                self.stats.dp_sharded_submissions += 1
            else:
                self.stats.dp_replicated_submissions += 1
        return split

    def _cut(self, t: torch.Tensor, split: bool, axis: int = 0):
        """This process's contiguous slice of ``t``'s row dim."""
        if not split:
            return t
        size = t.shape[axis] // self.data_shards
        return t.narrow(axis, axes_coord(self.mesh, self._daxes) * size, size)

    def _gather(self, t: torch.Tensor, split: bool, axis: int = 0):
        """Every row of a split submission, from each process's slice."""
        return gather_over(t, self.mesh, self._daxes, axis) if split else t

    def _run(self, fn, tokens: np.ndarray, caches=None,
             whole_caches: bool = False):
        """One submission: ``fn(batch)``, or ``fn(caches, batch)`` with
        ``caches`` cut to the batch's rows (a batch-1 cache broadcasts), under
        the model's shard context.  Returns (every row's logits, the caches
        ``fn`` made: every row's with ``whole_caches``, else this process's,
        whether the rows were cut).  Stacked KVCache leaves carry rows
        second; pos leaves have none."""
        toks, split = self._put_rows(tokens, count=True)
        with self._sharded(split):
            batch = self._make_batch(toks)
            if caches is None:
                logits, out = fn(batch)
            else:
                logits, out = fn(_map_caches(
                    lambda l: (l if l.dim() == 2 or l.shape[1] == 1
                               else self._cut(l, split, 1)), caches), batch)
        if whole_caches:
            out = _map_caches(
                lambda l: l if l.dim() == 2 else self._gather(l, split, 1), out)
        return self._gather(logits, split), out, split

    def _sharded(self, split: bool):
        """The model's shard context for one submission: its data axes only
        when the rows are split."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return shard_context(self.mesh, self._daxes if split else ())

    def _put_rows(self, arr: np.ndarray, axis: int = 0, count: bool = False):
        """Data-parallel row split: (this process's rows of ``arr`` on the
        device, whether they were cut)."""
        split = self._split_rows(arr.shape[axis], count)
        return self._cut(self._put(arr), split, axis), split

    def _make_batch(self, tokens) -> dict:
        """The model's batch dict for ``tokens`` (a host array, or rows
        already on the device), under the submission's shard context: the
        stub frontends look the bytes up through the embedding table's split
        (``LM.embed_rows``, no ``embed_scale``, as the reference's
        ``jnp.take``)."""
        cfg = self.lm.cfg
        toks = tokens if isinstance(tokens, torch.Tensor) else self._put(tokens)
        if cfg.input_mode == "embeds":
            # VLM stub frontend: embed text bytes through the text table
            return {"embeds": self.lm.embed_rows(toks)}
        if cfg.input_mode == "encdec":
            return {"enc_embeds": self.lm.embed_rows(toks), "tokens": toks}
        return {"tokens": toks}

    @staticmethod
    def _host(logits: torch.Tensor) -> np.ndarray:
        """Every row of ``logits`` in fp32 on the host (the host waits for
        the device here)."""
        with trace.span("engine.readback"):
            out = logits.float().cpu().numpy()
        trace.count("engine.readback_bytes", out.nbytes)
        return out

    # --------------------------------------------------------------- probes
    @staticmethod
    def _region_key(pids: tuple, sids: Sequence[int], cls: int) -> tuple:
        """THE prefix-cache key of a structured row in padded class
        ``cls``: (prefix token ids, absolute start position); the region
        ``PAD*start + prefix`` is a pure function of it.  Every prefix-cache
        client (probe routing, paged admission, prefetch) MUST key through
        here so fills and lookups can never drift apart."""
        return (pids, cls - len(pids) - len(sids))

    @staticmethod
    def _parts(prompt: Prompt) -> tuple[Optional[str], str]:
        """Normalize a probe prompt to (shared_prefix_or_None, suffix)."""
        if isinstance(prompt, str):
            return None, prompt
        prefix, suffix = prompt
        if not prefix or not suffix:
            return None, prefix + suffix
        return prefix, suffix

    @torch.inference_mode()
    def submit_probes(self, prompts: Sequence[Prompt],
                      max_batch: Optional[int] = None) -> np.ndarray:
        """THE probe pathway: run a round of independent single-token probes
        as one (or, when ``max_batch`` bounds padded batch size, a few
        length-bucketed) padded prefill submissions; returns last-position
        logits aligned with ``prompts``.  ``max_batch`` defaults to the
        engine's ``max_probe_batch`` memory ceiling.

        Prompts are grouped by PADDED-LENGTH CLASS (the power-of-two bucket
        with ``bucket_shapes``, exact token length without), never mixing
        classes in one submission, so each prompt's padding is a function of
        its own length only.

        Structured ``(prefix, suffix)`` prompts additionally ride the
        prefix-KV cache (when enabled): rows sharing (class, prefix ids,
        total length), and therefore the same absolute prefix start, are
        executed as suffix-only prefill over one cached prefix region."""
        n = len(prompts)
        if n == 0:
            return np.zeros((0, self.lm.cfg.vocab_size), np.float32)
        if max_batch is None:
            max_batch = self.max_probe_batch
        plain: dict[int, list[int]] = {}           # class -> indices
        structured: dict[int, list[tuple]] = {}    # class -> (idx, pids, sids)
        enc: list = [None] * n                     # per-index full token ids
        with trace.span("engine.encode"):
            for i, p in enumerate(prompts):
                prefix, suffix = self._parts(p)
                if prefix is not None and self.prefix_cache_enabled:
                    pids = tuple(self.tok.encode(prefix))
                    sids = self.tok.encode(suffix, bos=False)
                    enc[i] = list(pids) + sids
                    structured.setdefault(self._pad_class(len(enc[i])),
                                          []).append((i, pids, sids))
                else:
                    enc[i] = self.tok.encode(suffix if prefix is None
                                             else prefix + suffix)
                    plain.setdefault(self._pad_class(len(enc[i])),
                                     []).append(i)
            out = np.zeros((n, self.lm.cfg.vocab_size), np.float32)
        with trace.span("engine.route"):
            window_jobs = self._route(structured, plain)

        for cls in sorted(plain):
            for g in _chunks(sorted(plain[cls]), max_batch):
                lease = self._lease_probe_blocks(len(g), cls)
                try:
                    with trace.span("engine.prefill"):
                        tokens = self._pad_ids([enc[i] for i in g], maxlen=cls)
                        logits, _, _ = self._run(self._prefill, tokens)
                    self.stats.prefill_tokens += int(tokens.size)
                    self.stats.calls += 1
                    self.stats.probe_rows += len(g)
                    self.stats.probe_row_slots += int(tokens.shape[0])
                    trace.count("engine.probe_rows", len(g))
                    rows = self._host(logits)[:len(g)]
                    with trace.span("engine.scatter"):
                        out[np.asarray(g)] = rows
                finally:
                    self._release_lease(lease)
        for cls, lw, selected in window_jobs:
            entries, pins = self._fill_prefix_entries(
                cls, {key for _, key in selected})
            try:
                for entry in entries.values():
                    if entry.prefetched:
                        entry.prefetched = False
                        trace.count("engine.prefetch_used")
                # materialize each entry's dense view ONCE per window job:
                # pool-backed entries gather device KV, which must not
                # repeat per max_probe_batch chunk
                with trace.span("engine.assemble"):
                    dense = {key: self._entry_caches(e)
                             for key, e in entries.items()}
                for g in _chunks(selected, max_batch):
                    idx = [i for i, _ in g]
                    lease = self._lease_probe_blocks(len(g), cls)
                    try:
                        logits = self._run_window(cls, lw,
                                                  [enc[i] for i in idx],
                                                  [key for _, key in g],
                                                  dense)
                    finally:
                        self._release_lease(lease)
                    with trace.span("engine.scatter"):
                        out[np.asarray(idx)] = logits
            finally:
                self._release_pins(pins)
        return out

    def _route(self, structured: dict, plain: dict) -> list[tuple]:
        """Prefix-cache routing policy (per padded-length class): a row
        rides the prefix path only when its (prefix, start) entry is
        already cached or at least one class-mate shares it; otherwise the
        fill would cost as much as the monolithic row.  Demoted rows join
        the class's plain submission (``plain`` is extended in place).
        Returns the window jobs, ``[(cls, lw, [(idx, key)])]``."""
        window_jobs: list[tuple] = []
        for cls in sorted(structured):
            rows = structured[cls]
            counts: dict[tuple, int] = {}
            for _i, pids, sids in rows:
                key = self._region_key(pids, sids, cls)
                counts[key] = counts.get(key, 0) + 1
            selected = []
            for i, pids, sids in rows:
                key = self._region_key(pids, sids, cls)
                if key in self._prefix_lru or counts[key] >= 2:
                    selected.append((i, key, len(sids)))
                else:
                    plain.setdefault(cls, []).append(i)
            if not selected:
                continue
            if self.locality:
                # region-clustered jobs with per-group suffix windows,
                # <= prefix_cache_size regions per job, cold jobs before
                # warm jobs (serving/locality.py)
                jobs = plan_window_jobs(selected,
                                        lru_keys=self._prefix_lru.keys(),
                                        cache_size=self.prefix_cache_size,
                                        bucket=self.bucket_shapes)
            else:
                # reactive baseline: one class-global window sized by the
                # round's worst row; rows shorter than lw recompute a few
                # of their own prefix-tail tokens
                lw = max(s for _, _, s in selected)
                lw = _next_pow2(max(lw, 8)) if self.bucket_shapes else lw
                jobs = [(lw, [(i, key) for i, key, _ in selected])]
            for lw, sel in jobs:
                if lw >= cls:                      # no cached span left
                    plain.setdefault(cls, []).extend(i for i, _ in sel)
                    continue
                window_jobs.append((cls, lw, sel))
        return window_jobs

    def _lease_probe_blocks(self, rows: int, cls: int) -> Optional[list]:
        """Lease pool blocks covering ``rows`` probe rows of padded class
        ``cls`` for the duration of one probe submission.  Probe KV is
        transient, so its pool citizenship is a capacity *lease*: the blocks
        arbitrate one memory budget with decode rows and prefix runs and are
        returned the moment the forward pass ends.  When decode rows hold
        the blocks the lease degrades to unpooled transient memory (counted
        in ``stats.probe_lease_shortfalls``) instead of stalling the
        round."""
        if self.pool is None:
            return None
        # ownership transfers to the caller, which releases via
        # _release_lease in its own try/finally
        ids = self.pool.lease(rows * self.pool.blocks_for(cls))  # lint: disable=kv-pairing
        if ids is None:
            self.stats.probe_lease_shortfalls += 1
        else:
            self.stats.probe_blocks_leased += len(ids)
        return ids

    def _release_lease(self, ids: Optional[list]) -> None:
        if ids is not None:
            self.pool.decref(ids)

    @torch.inference_mode()
    def prefetch_prefixes(self, prompts: Sequence[Prompt]) -> int:
        """Warm the prefix-KV LRU for structured ``(prefix, suffix)``
        prompts ahead of the round or generate wave that needs them.
        Regions land pinned by the LRU only (no round pins), so a later
        submission hits the cache and evictions stay safe.  Returns the
        number of regions ensured resident."""
        if not self.prefix_cache_enabled:
            return 0
        by_cls: dict[int, set] = {}
        for p in prompts:
            prefix, suffix = self._parts(p)
            if prefix is None:
                continue
            pids = tuple(self.tok.encode(prefix))
            sids = self.tok.encode(suffix, bos=False)
            cls = self._pad_class(len(pids) + len(sids))
            by_cls.setdefault(cls, set()).add(
                self._region_key(pids, sids, cls))
        ensured = 0
        for cls in sorted(by_cls):
            entries, pins = self._fill_prefix_entries(cls, by_cls[cls],
                                                      prefetch=True)
            try:
                ensured += len(entries)
            finally:
                self._release_pins(pins)
        return ensured

    @trace.spanned("engine.fill")
    def _fill_prefix_entries(self, cls: int, keys: set,
                             prefetch: bool = False) -> tuple[dict, list]:
        """Prefill every missing (prefix ids, start) region of a class once;
        cache the per-entry KV in the LRU.  A region is ``PAD * pad +
        prefix``: the exact content of positions [0, start) of every padded
        row using it.

        The bookkeeping walks the reference's plan, one fill submission a
        region length and ``max_probe_batch`` chunk: ``ServeStats``, pool
        allocations and evictions, the dense fallback and LRU order are the
        reference's.  The device work is not: the missing regions run
        ``max_probe_batch`` at a time in one forward whatever their lengths
        (:meth:`_fill_forward`), run when the walk reaches the chunk's first
        region; its rows reach the pool in one write once the walk has
        placed its last, and its caches are dropped then, so one chunk's
        caches are live at a time, as in the reference (the call pins every
        block it allocates, and nothing reads one before the call
        returns).

        Entries are stored as pinned block runs in the paged pool (dense
        fallback when the pool is absent or cannot be freed up).  Returns
        ({key: PrefixEntry} DIRECT references for every requested key, so a
        round needing more entries than ``prefix_cache_size`` survives its
        own LRU evictions, plus the round's pin list for
        :meth:`_release_pins`: pool-backed entries hold one extra block
        reference for the round so an eviction cannot free KV mid-use).
        ``prefetch``: the fill is ``prefetch_prefixes``' (its new entries
        are marked while a profiler records)."""
        mark = prefetch and trace.recording()
        refs: dict[tuple, PrefixEntry] = {}
        pins: list[list] = []

        def pin(entry: PrefixEntry) -> None:
            if entry.blocks is not None:
                # ownership transfers to the caller via the returned pin
                # list (released with _release_pins in a try/finally there)
                self.pool.incref(entry.blocks)  # lint: disable=kv-pairing
                pins.append(entry.blocks)

        by_len: dict[int, list[tuple]] = {}
        for key in sorted(keys):
            if key in self._prefix_lru:
                self._prefix_lru.move_to_end(key)
                refs[key] = self._prefix_lru[key]
                pin(refs[key])
                self.stats.prefix_hits += 1
                continue
            pids, pad = key
            by_len.setdefault(pad + len(pids), []).append(key)
        step = self.max_probe_batch or max(
            (len(b) for b in by_len.values()), default=1)
        # the reference's plan: its submissions honor the engine's memory
        # ceiling and bucket their row count like every other submission
        plan = [(region_len, by_len[region_len][i:i + step])
                for region_len in sorted(by_len)
                for i in range(0, len(by_len[region_len]), step)]
        order = [key for _, batch in plan for key in batch]
        chunks = [order[i:i + step] for i in range(0, len(order), step)]
        caches, runs = None, []     # the live chunk's caches, a block run a row
        i = 0                                       # a region's place in order
        for region_len, batch in plan:
            self.stats.prefix_misses += len(batch)
            self.stats.prefix_fill_submissions += 1
            tokens = region_len * (_next_pow2(len(batch)) if self.bucket_shapes
                                   else len(batch))
            self.stats.prefill_tokens += tokens
            self.stats.prefix_tokens_saved -= tokens
            row_blocks = self._pool_rows(len(batch), region_len)
            for r, key in enumerate(batch):
                j, row = divmod(i, step)
                i += 1
                if row == 0:                # the walk reaches chunk j
                    caches, runs = self._fill_forward(chunks[j]), []
                if row_blocks is not None:
                    runs.append(row_blocks[r])
                    entry = PrefixEntry(region_len, blocks=row_blocks[r])
                else:
                    runs.append([])
                    # the region's own positions of every leaf, pos included
                    entry = PrefixEntry(region_len, caches=_map_caches(
                        lambda l, row=row, n=region_len: (
                            l[:, :n] if l.dim() == 2
                            else l[:, row:row + 1, :n].clone()),
                        caches))
                entry.prefetched = mark
                self._prefix_lru[key] = entry
                refs[key] = entry
                pin(entry)
                if row == len(chunks[j]) - 1:   # chunk j placed: write, drop
                    if any(runs):
                        self.pool.write(caches, runs, lengths=[
                            pad + len(pids) for pids, pad in chunks[j]])
                    caches = None
            if mark:
                trace.count("engine.prefetch_filled", len(batch))
            while len(self._prefix_lru) > self.prefix_cache_size:
                self._evict_one_prefix()
        return refs, pins

    def _fill_forward(self, keys: list) -> list:
        """One forward over the regions ``keys`` (prefix ids, start),
        whatever their lengths: row ``r`` is ``PAD * start + prefix``,
        right-filled with PAD to the longest, in rows bucketed like every
        submission's.  Prefill is causal and the model has no PAD mask, so
        the K/V of a row's first ``L`` positions do not depend on the filler
        after them: a region is the first ``L`` positions of its row.  Where
        every region has one length, the array is the reference's fill
        submission.  Returns every row's caches (every process stores every
        row's region KV)."""
        lmax = max(pad + len(pids) for pids, pad in keys)
        rows_p = _next_pow2(len(keys)) if self.bucket_shapes else len(keys)
        arr = np.full((rows_p, lmax), PAD, np.int32)
        for r, (pids, pad) in enumerate(keys):
            arr[r, pad:pad + len(pids)] = pids
        _, caches, _ = self._run(self._prefill_exact, arr, whole_caches=True)
        trace.count("engine.fill_forwards")
        trace.count("engine.fill_regions", len(keys))
        trace.count("engine.fill_tokens", int(arr.size))
        return caches

    def _pool_rows(self, rows: int, length: int) -> Optional[list]:
        """Allocate a block run per row (evicting cold prefix entries if
        needed); None when the pool is absent or cannot host the rows, and
        the caller falls back to dense storage."""
        if self.pool is None:
            return None
        nb = self.pool.blocks_for(length)
        need = rows * nb
        while self.pool.free_blocks < need and self._prefix_lru:
            self._evict_one_prefix()
        if self.pool.free_blocks < need:
            return None
        # ownership transfers to the probe-submission caller, which releases
        # every run in its round-scoped finally (_release_lease path)
        return [self.pool.alloc(nb) for _ in range(rows)]  # lint: disable=kv-pairing

    def _evict_one_prefix(self) -> None:
        _, entry = self._prefix_lru.popitem(last=False)
        if entry.blocks is not None:
            self.pool.decref(entry.blocks)

    def _release_pins(self, pins: list) -> None:
        for blocks in pins:
            self.pool.decref(blocks)

    def clear_prefix_cache(self) -> None:
        """Drop every cached prefix region (freeing its pool blocks)."""
        while self._prefix_lru:
            self._evict_one_prefix()

    def _entry_caches(self, entry: PrefixEntry):
        """Materialize an entry as the dense per-stack cache list the
        suffix-only prefill consumes (a gather is a copy of the stored
        bits, so both storage schemes execute identically)."""
        if entry.caches is not None:
            return entry.caches
        return self.pool.gather_stacked(entry.blocks, entry.length)

    def _run_window(self, cls: int, lw: int, full_ids: list,
                    keys: list, dense: dict) -> np.ndarray:
        """One suffix-window submission: every row attends over its own
        cached-KV slice [0, cls - lw) (selected per row from the window
        job's ``dense`` materialized entries) plus the recomputed window
        tokens [cls - lw, cls)."""
        r_star = cls - lw
        with trace.span("engine.assemble"):
            uniq: list = []
            uniq_of: dict[tuple, int] = {}
            for key in keys:
                if key not in uniq_of:
                    uniq_of[key] = len(uniq)
                    uniq.append(dense[key])
            rows = len(full_ids)
            rows_p = _next_pow2(rows) if self.bucket_shapes else rows
            arr = np.full((rows_p, lw), PAD, np.int32)
            for r, ids in enumerate(full_ids):
                row = [PAD] * (cls - len(ids)) + list(ids)  # left-padded
                arr[r] = row[r_star:]
            eidx = np.zeros((rows_p,), np.int64)     # dummy rows: entry 0
            eidx[:rows] = [uniq_of[k] for k in keys]
            idx = self._put(eidx)

            def cat(*leaves):
                if leaves[0].dim() == 2:               # stacked pos: arange(R)
                    return leaves[0][:, :r_star]
                rows_kv = torch.cat([l[:, :, :r_star] for l in leaves], dim=1)
                return rows_kv.index_select(1, idx)

            assembled = [KVCache(*(cat(*leaves) for leaves in zip(*per_stack)))
                         for per_stack in zip(*uniq)]
        # the per-row cache gather rides the token batch's row split
        with trace.span("engine.prefill_cont"):
            logits, _, _ = self._run(self.lm.prefill_cont, arr, assembled)
        self.stats.prefill_tokens += int(arr.size)
        self.stats.calls += 1
        self.stats.probe_rows += rows
        self.stats.probe_row_slots += rows_p
        trace.count("engine.probe_rows", rows)
        # monolithic baseline: cls tokens per padded row of this submission
        self.stats.prefix_tokens_saved += rows_p * cls - int(arr.size)
        return self._host(logits)[:rows]

    def last_logits(self, prompts: Sequence[Prompt]) -> np.ndarray:
        return self.submit_probes(prompts)

    def score_parts(self, text: str, criteria: str) -> tuple[str, str]:
        """Structured score probe prompt: the criteria block is shared by
        every row of a scoring round (one prefix-KV entry per round)."""
        return (f"Criteria: {criteria}\nItem:", f" {text}\nRating:")

    def score(self, texts: Sequence[str], criteria: str) -> list[float]:
        logits = self.submit_probes(
            [self.score_parts(t, criteria) for t in texts])
        return [read_score(l) for l in logits]

    def _compare_parts(self, a: str, b: str, criteria: str) -> tuple[str, str]:
        # the shared block (criteria + Passage B, quicksort's pivot) leads,
        # so every row of a partition round reuses one prefix-KV entry
        return (f"Criteria: {criteria}\nPassage B: {b}\n",
                f"Passage A: {a}\nWhich ranks higher? Answer:")

    def _compare_prompt(self, a: str, b: str, criteria: str) -> str:
        prefix, suffix = self._compare_parts(a, b, criteria)
        return prefix + suffix

    def compare(self, a: str, b: str, criteria: str) -> int:
        return self.compare_many([(a, b)], criteria)[0]

    def compare_many(self, pairs: Sequence[tuple[str, str]],
                     criteria: str) -> list[int]:
        """A round of independent comparisons in one probe submission."""
        logits = self.submit_probes(
            [self._compare_parts(a, b, criteria) for a, b in pairs])
        return [read_compare(l) for l in logits]

    def yes_no(self, prompt: Prompt) -> bool:
        return self.yes_no_many([prompt])[0]

    def yes_no_many(self, prompts: Sequence[Prompt]) -> list[bool]:
        """A round of independent Y/N probes in one probe submission."""
        logits = self.submit_probes(prompts)
        return [read_yes_no(l) for l in logits]

    def rank_window(self, texts: Sequence[str], criteria: str) -> list[int]:
        """Permutation (ascending by score) from one shared-prefix batch."""
        scores = self.score(texts, criteria)
        return list(np.argsort(np.asarray(scores), kind="stable"))

    # ------------------------------------------------------------- generate
    def _encode_prompt(self, prompt: Prompt) -> list[int]:
        prefix, suffix = self._parts(prompt)
        return self.tok.encode(suffix if prefix is None else prefix + suffix)

    def generate(self, prompts: Sequence[Prompt],
                 max_new: Optional[int] = None,
                 max_new_per: Optional[Sequence[int]] = None) -> list[str]:
        """Batched greedy decode.  On paged-pool-capable archs this drives
        the continuous-batching step loop (admission waves into free
        pool/row capacity, per-row retirement).  Other archs fall back to
        the padded lockstep loop."""
        if not self.paged_enabled:
            return self.generate_lockstep(prompts, max_new, max_new_per)
        n = len(prompts)
        # scalar max_new: 0/None means "engine default"; a PER-ROW entry of
        # 0 is a genuine zero budget, as in the lockstep loop
        base = min(max_new or self.max_new, self.max_new)
        if max_new_per is None:
            limits = [base] * n
        else:
            assert len(max_new_per) == n
            limits = [min(int(l), self.max_new) for l in max_new_per]
        needs: dict[int, int] = {}

        def get_req(i):
            if i not in needs:            # tokenize once per request
                needs[i] = self.paged_block_need(prompts[i], limits[i])
            return prompts[i], limits[i], needs[i]

        backlog = list(range(n))          # FIFO over prompt indices
        rid_of: dict[int, int] = {}
        pending: set[int] = set()
        outs: dict[int, str] = {}
        while backlog or pending:
            for i, rid in self._paged_admit_wave(backlog, get_req):
                rid_of[i] = rid
                pending.add(rid)
            for rid, text in self.paged_step().items():
                if rid in pending:        # ours
                    outs[rid] = text
                    pending.discard(rid)
                else:                     # a concurrent caller's row
                    self._paged_finished[rid] = text
        return [outs[rid_of[i]] for i in range(n)]

    @torch.inference_mode()
    def generate_lockstep(self, prompts: Sequence[Prompt],
                          max_new: Optional[int] = None,
                          max_new_per: Optional[Sequence[int]] = None
                          ) -> list[str]:
        """The padded lockstep baseline: one prefill batch, then all rows
        decode in lockstep until the LAST row finishes.  ``max_new_per``
        gives each row its own decode budget; rows that hit their budget
        are masked done and emit EOS while the rest keep decoding (and keep
        occupying a decode-row slot)."""
        max_new = min(max_new or self.max_new, self.max_new)
        n = len(prompts)
        tokens = self._pad_ids([self._encode_prompt(p) for p in prompts])
        b, s = tokens.shape                       # b >= n with bucket_shapes
        if max_new_per is None:
            limits = np.full((n,), max_new, np.int64)
        else:
            assert len(max_new_per) == n
            limits = np.minimum(np.asarray(max_new_per, np.int64), self.max_new)
        limits = np.concatenate([limits, np.zeros((b - n,), np.int64)])
        horizon = int(limits.max(initial=0))
        # caches: this process's rows, decoded here step by step
        logits, caches, split = self._run(self._prefill, tokens)
        self.stats.prefill_tokens += int(tokens.size)
        self.stats.calls += 1
        out = np.full((b, horizon), EOS, np.int64)  # unwritten tail decodes empty
        cur = logits.argmax(dim=-1)[:, None]
        done = limits <= 0
        for t in range(horizon):
            cur_host = cur[:, 0].cpu().numpy()
            out[:, t] = np.where(done, EOS, cur_host)
            done |= cur_host == EOS
            done |= (t + 1) >= limits
            if done.all():
                break
            with self._sharded(split):
                logits, caches = self.lm.decode_step(
                    caches, self._cut(cur, split), s + t)
            logits = self._gather(logits, split)
            self.stats.decode_tokens += int((~done).sum())
            self.stats.decode_row_steps += b
            cur = logits.argmax(dim=-1)[:, None]
        return [self.tok.decode(row) for row in out[:n]]

    # ------------------------------------- paged continuous-batching decode
    @property
    def paged_active(self) -> int:
        return len(self._paged_rows)

    def _row_limit(self, max_new: Optional[int]) -> int:
        return min(max_new if max_new is not None else self.max_new,
                   self.max_new)

    def paged_block_need(self, prompt: Prompt,
                         max_new: Optional[int] = None) -> int:
        """Worst-case (no prefix sharing) block count to admit ``prompt``."""
        cls = self._pad_class(len(self._encode_prompt(prompt)))
        return self.pool.blocks_for(cls + self._row_limit(max_new))

    def paged_room(self, need_blocks: int, rows_pending: int = 0,
                   blocks_pending: int = 0) -> bool:
        """Can a request needing ``need_blocks`` be admitted now, on top of
        ``rows_pending``/``blocks_pending`` already earmarked this wave?"""
        return (self.paged_active + rows_pending < self.max_decode_rows
                and blocks_pending + need_blocks <= self.pool.free_blocks)

    def _paged_admit_wave(self, queue: list, get_req,
                          max_wave: Optional[int] = None) -> list[tuple]:
        """Pop and admit the FIFO prefix of ``queue`` that fits free
        capacity right now (the shared admission loop behind
        :meth:`generate` and a scheduler's continuous drain).
        ``get_req(item) -> (prompt, max_new, need_blocks)``; the caller
        memoizes ``need_blocks`` so the head-of-queue prompt is not
        re-tokenized every step it waits.  Returns [(item, rid)].  When the
        head request cannot fit an EMPTY loop, cold prefix runs are evicted
        to make room; a request bigger than the whole pool raises
        ``PoolExhausted``."""
        while True:
            wave, pend = [], 0
            while queue and (max_wave is None or len(wave) < max_wave):
                _, _, need = get_req(queue[0])
                if not self.paged_room(need, rows_pending=len(wave),
                                       blocks_pending=pend):
                    break
                wave.append(queue.pop(0))
                pend += need
            if wave:
                rids = self.paged_admit(
                    [get_req(it)[:2] for it in wave])
                return list(zip(wave, rids))
            # stuck iff nothing IN FLIGHT can still free blocks: finished
            # rows already freed theirs at retirement, so pending outputs
            # must NOT defer the eviction/raise
            if queue and not self._paged_rows:
                if self._prefix_lru:      # cold prefix runs yield to decode
                    self.clear_prefix_cache()
                    continue
                raise PoolExhausted(
                    f"request needs {get_req(queue[0])[2]} blocks but an "
                    f"empty pool frees only {self.pool.free_blocks}")
            return []

    @torch.inference_mode()
    def paged_admit(self, requests: Sequence[tuple]) -> list[int]:
        """Admit a wave of ``(prompt, max_new_or_None)`` requests into the
        continuous decode loop: allocate each row's block run, prefill at
        the row's OWN padded-length class (grouped per class, like probes),
        and scatter the prompt KV into the run.  Structured prompts whose
        (prefix, start) region is cached, or shared by a wave-mate, ride
        the prefix path: the row increfs the entry's full blocks and
        suffix-prefills only the remainder into private blocks appended
        after them.  Returns row ids; outputs arrive via :meth:`paged_step`.
        The caller checks :meth:`paged_room` first; admission beyond
        capacity raises ``PoolExhausted``."""
        reqs = []
        rids_out = []                     # one rid per request, IN ORDER
        for prompt, max_new in requests:
            prefix, suffix = self._parts(prompt)
            rid = next(self._paged_ids)
            rids_out.append(rid)
            limit = self._row_limit(max_new)
            if prefix is not None and self.prefix_cache_enabled:
                pids = tuple(self.tok.encode(prefix))
                sids = self.tok.encode(suffix, bos=False)
                enc = list(pids) + sids
            else:
                pids = sids = None
                enc = self._encode_prompt(prompt)
            cls = self._pad_class(len(enc))
            if limit <= 0:                         # degenerate: no decode
                self._paged_finished[rid] = ""
                continue
            reqs.append((rid, enc, cls, limit, pids, sids))
        # routing: a row rides the prefix path only when its entry is cached
        # or a wave-mate shares it (same policy as submit_probes)
        counts: dict[tuple, int] = {}
        for rid, enc, cls, limit, pids, sids in reqs:
            if pids is not None:
                key = self._region_key(pids, sids, cls)
                counts[(cls, key)] = counts.get((cls, key), 0) + 1
        plain: dict[int, list] = {}
        shared: dict[tuple, list] = {}
        for req in reqs:
            rid, enc, cls, limit, pids, sids = req
            if pids is not None:
                key = self._region_key(pids, sids, cls)
                if key in self._prefix_lru or counts[(cls, key)] >= 2:
                    shared.setdefault((cls, key), []).append(req)
                    continue
            plain.setdefault(cls, []).append(req)
        for cls in sorted(plain):
            for group in _chunks(plain[cls], self.max_probe_batch):
                self._admit_plain(cls, group)
        for (cls, key), group in sorted(shared.items(),
                                        key=lambda kv: kv[0][0]):
            entries, pins = self._fill_prefix_entries(cls, {key})
            try:
                entry = entries[key]
                n_shared = (0 if entry.blocks is None
                            else entry.length // self.pool.block_size)
                if n_shared == 0:
                    # region shorter than a block (or dense fallback):
                    # nothing to append onto, so admit monolithically.  Unpin
                    # FIRST: the fill's blocks were not in paged_room's
                    # worst-case budget, so _alloc_rows must be free to
                    # evict the entry
                    self._release_pins(pins)
                    pins = []
                    for group_c in _chunks(group, self.max_probe_batch):
                        self._admit_plain(cls, group_c)
                else:
                    for group_c in _chunks(group, self.max_probe_batch):
                        self._admit_shared(cls, entry, n_shared, group_c)
            finally:                      # a PoolExhausted must not leak
                self._release_pins(pins)  # the round's entry references
        return rids_out

    def _admit_plain(self, cls: int, group: list) -> None:
        """Monolithic prefill of same-class rows into their block runs."""
        tokens = self._pad_ids([enc for _, enc, *_ in group], maxlen=cls)
        logits, caches, _ = self._run(self._prefill_exact, tokens,
                                      whole_caches=True)
        self.stats.prefill_tokens += int(tokens.size)
        self.stats.calls += 1
        row_blocks = self._alloc_rows(
            [self.pool.blocks_for(cls + limit)
             for _, _, _, limit, _, _ in group])
        # rows have differing decode headroom (per-request limits); only the
        # prompt span is written now, decode fills the tail block by block
        nb_w = self.pool.blocks_for(cls)
        self.pool.write(caches, [rb[:nb_w] for rb in row_blocks])
        self._start_rows(group, row_blocks, 0, logits)

    def _alloc_rows(self, counts: Sequence[int],
                    incref_run: Optional[list] = None) -> list[list]:
        """Allocate one block run per row, evicting cold prefix entries when
        the free list runs short (region fills are not part of
        ``paged_room``'s worst-case budget, so admission must be able to
        reclaim them); on a genuine shortfall, roll back the group's
        allocations (and ``incref_run`` references) before re-raising so a
        failed admission leaks nothing."""
        runs: list[list] = []
        try:
            for nb in counts:
                if incref_run is not None:
                    # released by the except-PoolExhausted rollback below;
                    # on success ownership lives in the returned row runs
                    self.pool.incref(incref_run)  # lint: disable=kv-pairing
                while (self.pool.free_blocks < nb and self._prefix_lru):
                    self._evict_one_prefix()
                # released by the except-PoolExhausted rollback below; on
                # success ownership lives in the returned row runs
                runs.append(self.pool.alloc(nb))  # lint: disable=kv-pairing
        except PoolExhausted:
            for rb in runs:
                self.pool.decref(rb)
            if incref_run is not None:    # one incref per loop entry
                for _ in range(len(runs) + 1):
                    self.pool.decref(incref_run)
            raise
        return runs

    def _admit_shared(self, cls: int, entry: PrefixEntry, n_shared: int,
                      group: list) -> None:
        """Suffix-only prefill of rows sharing one prefix entry: rows attend
        over the entry's gathered block run (positions [0, start)), compute
        the window [start, cls) themselves, and scatter it into private
        blocks appended after the increfed shared run."""
        bs = self.pool.block_size
        start = n_shared * bs
        w = cls - start
        assert 0 < w, "shared region must leave a non-empty suffix window"
        rows = len(group)
        rows_p = _next_pow2(rows) if self.bucket_shapes else rows
        arr = np.full((rows_p, w), PAD, np.int32)
        for r, (_, enc, *_rest) in enumerate(group):
            row = [PAD] * (cls - len(enc)) + list(enc)
            arr[r] = row[start:]
        assembled = _map_caches(
            lambda l: l[:, :start] if l.dim() == 2 else l[:, :, :start],
            self._entry_caches(entry))
        logits, caches, _ = self._run(self.lm.prefill_cont, arr, assembled,
                                      whole_caches=True)
        self.stats.prefill_tokens += int(arr.size)
        self.stats.calls += 1
        self.stats.prefix_tokens_saved += rows_p * cls - int(arr.size)
        shared_run = list(entry.blocks[:n_shared])
        row_blocks = self._alloc_rows(
            [self.pool.blocks_for(cls + limit) - n_shared
             for _, _, _, limit, _, _ in group], incref_run=shared_run)
        nb_w = self.pool.blocks_for(w)           # prompt span only (see plain)
        self.pool.write(caches, [rb[:nb_w] for rb in row_blocks], start=start)
        full = [shared_run + rb for rb in row_blocks]
        self._start_rows(group, full, n_shared, logits)

    def _start_rows(self, group: list, row_blocks: list, n_shared: int,
                    logits) -> None:
        first = logits.argmax(dim=-1).cpu().numpy()
        for r, (rid, _enc, cls, limit, _p, _s) in enumerate(group):
            self._paged_rows[rid] = _PagedRow(
                rid=rid, cls=cls, limit=limit, blocks=row_blocks[r],
                n_shared=n_shared, cur=int(first[r]))

    @torch.inference_mode()
    def paged_step(self) -> dict[int, str]:
        """One continuous-batching decode step: record each active row's
        pending token, retire rows that just finished (freeing their blocks
        IMMEDIATELY, before the decode runs, so the freed capacity is
        admittable this very step), then decode all remaining rows, each at
        its own position, through its block table.  Returns {rid: output}
        for rows finished since the last call.

        In ``"check"`` mode the kernel step runs first and the dense step
        second.  Both write the new token's K/V into the same arena slots
        (in place), the dense step last, so the arena ends up exactly as a
        dense-only step leaves it; the dense logits are kept."""
        finished, self._paged_finished = self._paged_finished, {}
        active: list[_PagedRow] = []
        for rid, row in list(self._paged_rows.items()):
            row.emitted.append(row.cur)
            if row.cur == EOS or len(row.emitted) >= row.limit:
                finished[rid] = self.tok.decode(row.emitted)
                self.pool.decref(row.blocks)
                del self._paged_rows[rid]
            else:
                active.append(row)
        if not active:
            return finished
        b = len(active)
        b_p = _next_pow2(b) if self.bucket_shapes else b
        maxb = max(len(r.blocks) for r in active)
        maxb_p = _next_pow2(maxb) if self.bucket_shapes else maxb
        tables = np.zeros((b_p, maxb_p), np.int32)   # 0 = dummy block
        toks = np.full((b_p, 1), PAD, np.int32)
        pos = np.zeros((b_p,), np.int32)
        for i, row in enumerate(active):
            tables[i, :len(row.blocks)] = row.blocks
            toks[i, 0] = row.cur
            pos[i] = row.cls + row.t
        args = (self._put(toks), self._put(pos), self._put(tables))
        if self.paged_kernel == "check":
            logits_k, _ = self._decode_paged(*args, impl="kernel")
            logits, _ = self._decode_paged(*args, impl="dense")
            np.testing.assert_allclose(
                self._host(logits_k)[:b], self._host(logits)[:b],
                rtol=PAGED_KERNEL_RTOL, atol=PAGED_KERNEL_ATOL)
        elif self.paged_kernel:
            logits, _ = self._decode_paged(*args, impl="kernel")
        else:
            logits, _ = self._decode_paged(*args, impl="dense")
        self.stats.decode_tokens += b
        self.stats.decode_row_steps += b_p
        nxt = logits.argmax(dim=-1).cpu().numpy()
        for i, row in enumerate(active):
            row.cur = int(nxt[i])
            row.t += 1
        return finished

    # -------------------------------------- preemption: suspend and resume
    @torch.inference_mode()
    def paged_suspend(self, rid: int) -> SuspendedRow:
        """Evict an active decode row to a host-side stash, freeing its pool
        references (shared prefix blocks merely lose this row's ref).  The
        stash copy happens FIRST, so an exception mid-suspend leaves the row
        active and the pool untouched."""
        row = self._paged_rows[rid]
        stash = self.pool.stash_blocks(row.blocks)
        s = SuspendedRow(rid=row.rid, cls=row.cls, limit=row.limit,
                         cur=row.cur, t=row.t, emitted=list(row.emitted),
                         n_blocks=len(row.blocks), stash=stash)
        del self._paged_rows[rid]
        self.pool.decref(row.blocks)
        self.stats.preempt_suspends += 1
        self.stats.preempt_blocks_stashed += len(row.blocks)
        return s

    @torch.inference_mode()
    def paged_resume(self, s: SuspendedRow) -> int:
        """Re-admit a suspended row under its original rid: allocate a fresh
        private run, scatter the stash back, and rebuild the row mid-decode
        (``n_shared`` 0: the resumed run is wholly private).  May raise
        ``PoolExhausted``; the finally rolls the allocation back, the stash
        stays intact, and the caller retries a later step."""
        blocks = self.pool.alloc(s.n_blocks)
        try:
            self.pool.unstash_blocks(s.stash, blocks)
            self._paged_rows[s.rid] = _PagedRow(
                rid=s.rid, cls=s.cls, limit=s.limit, blocks=blocks,
                n_shared=0, cur=s.cur, t=s.t, emitted=list(s.emitted))
            self.stats.preempt_resumes += 1
            blocks = None             # ownership transferred to the row
        finally:
            if blocks is not None:
                self.pool.decref(blocks)
        return s.rid


def _chunks(seq: list, step: Optional[int]):
    step = step or len(seq) or 1          # None = one unbounded chunk
    return (seq[i:i + step] for i in range(0, len(seq), step))
