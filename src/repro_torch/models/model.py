"""Unified LM API over the block-stack patterns, as an ``nn.Module``.

Counterpart of ``src/repro/models/model.py``.  The module owns its parameters
(the reference passes a ``params`` pytree into every call), with the
reference's names, its ``(d_in, d_out)`` layouts applied as ``x @ w`` and the
leading layer dim of each stack, so loading converted weights is a copy
(``repro_torch/convert.py``)::

    lm = LM(cfg, device="cuda", generator=gen)  # random init from ``gen``
    logits, caches = lm.prefill(batch)          # serve: context ingestion
    logits, caches = lm.decode_step(caches, token, position)

Ported: ``forward``, ``loss``, ``init_caches``, ``prefill``,
``prefill_cont``, ``decode_step``, ``decode_step_paged`` (``impl="dense" |
"kernel"``) and ``score_hidden`` for every pattern of the reference: the
grouped patterns of Hymba and xLSTM, an encoder (``enc_pattern``, run before
the decoder in every mode but decode), ``embeds`` input and M-RoPE
(``prefill_cont`` and ``decode_step_paged`` for token-input pure ``attn``
stacks, as in the reference).  :meth:`LM.param_tree` gives the parameters in
the reference's nested pytree, which the trainer and checkpoints walk.

On a mesh, :meth:`LM.sharded` gives the LM of this process: its slice of
every parameter under ``distributed.sharding.param_specs`` (tensor-parallel
over ``model``, with ``fsdp`` also over the data axes, gathered back per
stack at use, as the reference's GSPMD gathers per stack).  Run it under the
engine's ``distributed.context.shard_context``: the vocab-parallel embedding
is a masked local lookup summed over ``model``, the vocab-split logits are
gathered over it, and the blocks make whole what a computation needs whole
and sum their row-parallel products (``blocks.py``, ``ssm.py``,
``xlstm.py``).  Every config takes a model axis of any size, as every
config takes the reference's spec rules: a dim the axis does not divide
stays whole.  The encoder's stacks are cut as the decoder's.

Batch dict keys: ``tokens`` (B, S) integer ids; ``embeds`` (B, S, D)
precomputed frontend embeddings, used instead of tokens; ``enc_embeds``
(B, S_enc, D) the encoder's input (encoder-decoder); ``positions`` (B, S),
or (3, B, S) for M-RoPE, optional, default arange.  The decode position of
:meth:`decode_step` is a Python int.  Decode steps update the caches they
are given in place.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..distributed.context import (constrain, gather_over, get_shard_context,
                                   model_gather, model_rank, model_sum,
                                   pin_rows)
from ..distributed.sharding import (MODEL, ShardingPlan, axes_size,
                                    axis_size, local_shard, map_with_path,
                                    param_specs)
from .blocks import apply_stack, init_block_cache, init_stack, map_cache
from .config import ModelConfig
from .layers import dtype_of, rms_norm, rope_angles

NESTED = ("ffn", "moe", "ssm")
LOSS_CHUNK = 128          # the reference's sequence chunk of the loss


def _flatten(stack: dict) -> dict:
    """``{"ffn": {"w_up": w}}`` -> ``{"ffn_w_up": w}``, for an
    ``nn.ParameterDict`` (no other key of a stack starts with these
    prefixes)."""
    flat = {k: v for k, v in stack.items() if k not in NESTED}
    for group in NESTED:
        flat.update({f"{group}_{k}": v for k, v in stack.get(group, {}).items()})
    return flat


def _nest(flat) -> dict:
    out: dict[str, Any] = {}
    for k, v in flat.items():
        group, _, leaf = k.partition("_")
        if group in NESTED:
            out.setdefault(group, {})[leaf] = v
        else:
            out[k] = v
    return out


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        """Random parameters drawn from ``generator`` (which must live on
        ``device``; default: a new one seeded with 0).  ``device=None`` means
        CUDA and raises without it.  On ``"meta"`` nothing is drawn: the
        parameters have their shapes and dtypes and no storage (the
        dry-run's abstract model)."""
        super().__init__()
        self.cfg = cfg
        self._fsdp: dict = {}               # path -> [(dim, data axes)]
        self._mesh = None
        dev = resolve_device(device)
        if dev.type == "meta":
            generator = None
        elif generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        dtype = dtype_of(cfg.dtype)

        def normal(*shape):
            w = torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32)
            return nn.Parameter((w / math.sqrt(cfg.d_model)).to(dtype))

        self.embed = normal(cfg.vocab_size, cfg.d_model)
        self.final_norm = nn.Parameter(
            torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev))
        self.stacks = nn.ModuleList(
            nn.ParameterDict(_flatten(init_stack(generator, kind, n, cfg, dev)))
            for kind, n in cfg.pattern)
        if not cfg.tie_embeddings:
            self.lm_head = normal(cfg.d_model, cfg.vocab_size)
        else:
            self.lm_head = None
        self.enc_stacks = self.enc_norm = None
        if cfg.enc_pattern:
            self.enc_stacks = nn.ModuleList(
                nn.ParameterDict(_flatten(init_stack(generator, kind, n, cfg, dev)))
                for kind, n in cfg.enc_pattern)
            self.enc_norm = nn.Parameter(
                torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev))

    @classmethod
    def from_tree(cls, cfg: ModelConfig, tree: dict) -> "LM":
        """An LM holding the tensors of ``tree`` (a :meth:`param_tree` of
        ``cfg``'s layout) without copying them."""
        lm = cls.__new__(cls)
        nn.Module.__init__(lm)
        lm.cfg, lm._fsdp, lm._mesh = cfg, {}, None

        def par(t):
            return nn.Parameter(t.detach(), requires_grad=t.requires_grad)

        def stacks(trees):
            return nn.ModuleList(
                nn.ParameterDict({k: par(v) for k, v in _flatten(st).items()})
                for st in trees)

        lm.embed, lm.final_norm = par(tree["embed"]), par(tree["final_norm"])
        lm.stacks = stacks(tree["stacks"])
        lm.lm_head = par(tree["lm_head"]) if "lm_head" in tree else None
        lm.enc_stacks = lm.enc_norm = None
        if "enc_stacks" in tree:
            lm.enc_stacks = stacks(tree["enc_stacks"])
            lm.enc_norm = par(tree["enc_norm"])
        return lm

    def sharded(self, mesh, plan: Optional[ShardingPlan] = None) -> "LM":
        """This process's LM on ``mesh``: every parameter cut by
        ``param_specs`` (a leaf replicated everywhere is shared, not
        copied).  Leaves the plan's ``fsdp`` splits over the data axes are
        gathered back per stack when a forward reads them."""
        tree = self.param_tree()
        specs = param_specs(tree, mesh, plan or ShardingPlan())
        lm = LM.from_tree(self.cfg, local_shard(tree, specs, mesh))
        lm._mesh = mesh

        def note(path, spec):
            dims = [(i, e) for i, e in enumerate(spec)
                    if e is not None and e != MODEL and axes_size(mesh, e) > 1]
            if dims:
                lm._fsdp[path] = dims

        map_with_path(note, specs)
        return lm

    def _check_context(self) -> None:
        if self._mesh is not None and get_shard_context() is None:
            raise RuntimeError("a sharded LM runs under "
                               "distributed.context.shard_context")

    def _gathered(self, path: tuple, t):
        for dim, axes in self._fsdp.get(path, ()):
            t = gather_over(t, self._mesh, axes, dim)
        return t

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def stack_params(self, i: int) -> dict:
        """Stack ``i``'s parameters in the reference's nested layout (fsdp
        leaves gathered over the data axes)."""
        p = _nest(self.stacks[i])
        if self._fsdp:
            p = map_with_path(
                lambda path, t: self._gathered(("stacks", i) + path, t), p)
        return p

    def enc_stack_params(self, i: int) -> dict:
        p = _nest(self.enc_stacks[i])
        if self._fsdp:
            p = map_with_path(
                lambda path, t: self._gathered(("enc_stacks", i) + path, t), p)
        return p

    def param_tree(self) -> dict:
        """Every parameter (the live tensors; on a sharded LM this process's
        slices, fsdp leaves not gathered) in the reference's pytree:
        ``embed``, ``final_norm``, ``stacks`` (a list of nested dicts),
        untied ``lm_head`` and, with an encoder, ``enc_stacks`` and
        ``enc_norm``."""
        tree = {"embed": self.embed, "final_norm": self.final_norm,
                "stacks": [_nest(st) for st in self.stacks]}
        if self.lm_head is not None:
            tree["lm_head"] = self.lm_head
        if self.enc_stacks is not None:
            tree["enc_stacks"] = [_nest(st) for st in self.enc_stacks]
            tree["enc_norm"] = self.enc_norm
        return tree

    # ------------------------------------------------------------- embedding
    def _embed_in(self, batch) -> torch.Tensor:
        if batch.get("embeds") is not None:
            return batch["embeds"].to(dtype_of(self.cfg.dtype))
        return self._embed_tokens(batch["tokens"])

    def _embed_tokens(self, tokens) -> torch.Tensor:
        """Token embeddings times ``embed_scale``."""
        return self.embed_rows(tokens) * self.cfg.embed_scale

    def embed_rows(self, tokens) -> torch.Tensor:
        """The embedding table's rows of ``tokens``, whole (the stub
        frontends' lookup, as the reference's ``jnp.take`` of the table).
        A vocab-split table (this process holds rows ``[r*V/m, (r+1)*V/m)``)
        looks up the ids it holds, zeros the rest and sums over ``model``, an
        exact sum since one process contributes each row; a d_model-split
        table gathers its columns."""
        cfg = self.cfg
        table = self.embed
        v_loc, d_loc = table.shape
        ids = tokens.long()
        if v_loc != cfg.vocab_size:
            ids = ids - model_rank() * v_loc
            mine = (ids >= 0) & (ids < v_loc)
            x = table[ids.clamp(0, v_loc - 1)]
            x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))
            return model_sum(x)
        x = table[ids]
        return model_gather(x, -1) if d_loc != cfg.d_model else x

    def _head_product(self, h) -> torch.Tensor:
        """``h @ head`` (B, S, V) with the (tied) head, whole over the
        vocabulary: a vocab-split head's logits gathered over ``model``, a
        d_model-split head's partial products summed over it."""
        cfg = self.cfg
        head = (self.embed.T if cfg.tie_embeddings
                else self._gathered(("lm_head",), self.lm_head))
        d_loc, v_loc = head.shape
        if d_loc != cfg.d_model:
            y = model_sum(h.narrow(-1, model_rank() * d_loc, d_loc) @ head)
        else:
            y = h @ head
        return model_gather(y, -1) if v_loc != cfg.vocab_size else y

    def _angles(self, positions, seq: int, batch_dim: int):
        cfg = self.cfg
        if all(kind in ("mlstm", "slstm")
               for kind, _ in tuple(cfg.pattern) + tuple(cfg.enc_pattern)):
            return None                     # purely recurrent: no RoPE
        if positions is None:
            positions = torch.arange(seq, dtype=torch.int32,
                                     device=self.device).expand(batch_dim, seq)
            if cfg.mrope_sections:
                positions = positions.expand(3, batch_dim, seq)
        return rope_angles(positions, cfg.hd, cfg.rope_theta,
                           cfg.mrope_sections)

    def _encode(self, batch, ctx_base) -> Optional[torch.Tensor]:
        """The encoder over ``batch["enc_embeds"]``, in mode ``train`` under
        its own angles, then ``enc_norm``; None without an encoder."""
        cfg = self.cfg
        if not cfg.enc_pattern:
            return None
        xe = batch["enc_embeds"].to(dtype_of(cfg.dtype))
        be, se, _ = xe.shape
        enc_ctx = dict(ctx_base, angles=self._angles(None, se, be))
        for i, (kind, _n) in enumerate(cfg.enc_pattern):
            xe, _ = apply_stack(kind, cfg, self.enc_stack_params(i), xe,
                                enc_ctx, None, "train")
        return rms_norm(xe, self.enc_norm, cfg.norm_eps)

    def _head(self, x) -> torch.Tensor:
        cfg = self.cfg
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return self._head_product(x) * cfg.logit_scale

    # --------------------------------------------------------------- forward
    def forward(self, batch, mode: str = "train", caches=None,
                position: Optional[int] = None, reserve: int = 0):
        """Returns (hidden (B, S, D), new_caches_or_None)."""
        cfg = self.cfg
        self._check_context()
        x = constrain(pin_rows(self._embed_in(batch)))
        b, s, _ = x.shape
        ctx: dict[str, Any] = {"reserve": reserve}
        if mode == "decode":
            pos_arr = torch.full((b, 1), int(position), dtype=torch.int32,
                                 device=x.device)
            if cfg.mrope_sections:
                pos_arr = pos_arr.expand(3, b, 1)
            ctx["angles"] = self._angles(pos_arr, 1, b)
            ctx["position"] = int(position)
        elif mode == "prefill_cont":
            # the new tokens sit at absolute positions [cached_len,
            # cached_len + s); stacked KVCache leaves are (n, B, S_cached, ..)
            pos = batch.get("positions")
            if pos is None:
                start = caches[0].k.shape[2]
                pos = (start + torch.arange(s, dtype=torch.int32,
                                            device=x.device)).expand(b, s)
            ctx["angles"] = self._angles(pos, s, b)
        else:
            ctx["angles"] = self._angles(batch.get("positions"), s, b)
        if mode != "decode" and cfg.enc_pattern:
            ctx["enc_out"] = self._encode(batch, ctx)

        new_caches = []
        for i, (kind, _n) in enumerate(cfg.pattern):
            c = caches[i] if caches is not None else None
            x, c2 = apply_stack(kind, cfg, self.stack_params(i), x, ctx, c, mode)
            new_caches.append(c2)
        return x, (new_caches if mode != "train" else None)

    def loss(self, batch):
        """Next-token cross entropy over ``batch["tokens"]`` (B, S) (the
        decoder's tokens of an encoder-decoder), as the
        reference computes it: the hidden states of positions [0, S-1)
        against the tokens of [1, S), in chunks of ``LOSS_CHUNK`` positions
        and a remainder chunk, fp32 logits through the (tied) head times
        ``logit_scale``.  Like the reference it skips ``final_norm``.
        Returns ``(loss, {"loss", "tokens"})``, a scalar fp32 loss."""
        cfg = self.cfg
        x, _ = self.forward(batch, mode="train")
        tokens = batch["tokens"].long()
        b, s = tokens.shape
        inputs_h, targets = x[:, :-1], tokens[:, 1:]
        sl = s - 1
        chunk = min(LOSS_CHUNK, sl)
        n_chunks = sl // chunk

        def ce(h, t):
            logits = self._head_product(h).float() * cfg.logit_scale
            logz = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, t[..., None])[..., 0]
            return (logz - gold).sum()

        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(n_chunks):
            sl_i = slice(i * chunk, (i + 1) * chunk)
            total = total + ce(inputs_h[:, sl_i], targets[:, sl_i])
        if sl - n_chunks * chunk:
            total = total + ce(inputs_h[:, n_chunks * chunk:],
                               targets[:, n_chunks * chunk:])
        ntok = b * sl
        loss = total / ntok
        return loss, {"loss": loss,
                      "tokens": torch.tensor(float(ntok), device=x.device)}

    # ------------------------------------------------------------- serving
    def init_caches(self, batch_size: int, cache_len: int, enc_len: int = 0):
        """Empty decode caches; on a sharded LM this process's part, as its
        layers compute them (its kv heads, recurrent heads and SSM
        channels; ``batch_size`` its rows)."""
        cfg = self.cfg
        model, rank = 1, 0
        if self._mesh is not None:
            model = axis_size(self._mesh, MODEL)
            rank = int(self._mesh.get_local_rank(MODEL))
        caches = []
        for kind, n in cfg.pattern:
            one = init_block_cache(kind, cfg, batch_size, cache_len, enc_len,
                                   self.device, model, rank)
            caches.append(map_cache(
                lambda leaf: leaf[None].repeat(n, *([1] * leaf.dim())), one))
        return caches

    def prefill(self, batch, reserve: int = 0):
        """Ingest the full context; returns (last_logits (B, V), caches).
        ``reserve`` extra cache slots for subsequent decode."""
        x, caches = self.forward(batch, mode="prefill", reserve=reserve)
        return self._head(x[:, -1:, :])[:, 0], caches

    def prefill_cont(self, caches, batch, reserve: int = 0):
        """Continue a prefill on top of cached KV (prefix-KV reuse): ingest
        ``batch`` (S new tokens per row) at absolute positions starting at
        the cached length; returns (last_logits (B, V), caches over the full
        prefix+suffix sequence).  ``caches`` must be exact-length
        (``reserve=0``); batch-1 caches broadcast over the batch dim."""
        x, caches = self.forward(batch, mode="prefill_cont", caches=caches,
                                 reserve=reserve)
        return self._head(x[:, -1:, :])[:, 0], caches

    def decode_step(self, caches, token_or_embed, position: int):
        """One token: ids (B, 1) or embeds (B, 1, D).  Returns (logits
        (B, V), caches); the caches are updated in place."""
        key = "embeds" if token_or_embed.is_floating_point() else "tokens"
        x, caches = self.forward({key: token_or_embed}, mode="decode",
                                 caches=caches, position=position)
        return self._head(x)[:, 0], caches

    def decode_step_paged(self, caches, tokens, positions, tables, *,
                          block_size: int, impl: str = "dense",
                          write_index=None):
        """One decode token per row against the block-paged KV pool.

        caches: list (one per stack) of :class:`~.layers.PagedKV` with leaves
        (n_layers, num_blocks, block_size, KV, hd): the SHARED arena, written
        in place; tokens (B, 1); positions (B,) int32 per-row absolute
        positions; tables (B, MAXB) int32 per-row block tables, 0-padded
        (block 0 is the dummy block).

        Returns (logits (B, V), caches).  ``impl="dense"`` is the
        gather+attend path, equal per row to :meth:`decode_step` over a ring
        cache holding the same tokens; ``impl="kernel"`` runs the paged
        attention kernel (kernels/paged_attention.py), allclose to it.

        ``write_index``: on a mesh whose rows are split over the data axes,
        the (block ids, slots) of every row of the step (``tokens`` ..
        ``tables`` being this process's rows), where each process writes
        every row's K/V so that the arena stays replicated."""
        cfg = self.cfg
        if cfg.input_mode != "tokens" or cfg.mrope_sections:
            raise ValueError("paged decode supports token-input, non-M-RoPE "
                             "archs only")
        if impl not in ("dense", "kernel"):
            raise ValueError(f"impl must be 'dense' or 'kernel', got {impl!r}")
        self._check_context()
        if impl == "kernel" and write_index is not None:
            raise ValueError("the paged attention kernel takes no row-split "
                             "step (write_index)")
        x = pin_rows(self._embed_tokens(tokens))
        b = tokens.shape[0]
        ctx: dict[str, Any] = {
            "angles": self._angles(positions[:, None], 1, b),
            "paged_tables": tables, "paged_positions": positions,
            "paged_block_size": block_size, "paged_impl": impl,
        }
        if write_index is not None:
            ctx["paged_write_index"] = write_index
        for i, (kind, _n) in enumerate(cfg.pattern):
            x, _ = apply_stack(kind, cfg, self.stack_params(i), x, ctx,
                               caches[i], "decode_paged")
        return self._head(x)[:, 0], caches

    def score_hidden(self, batch):
        """Mean-pooled final hidden state."""
        x, _ = self.forward(batch, mode="train")
        return x.float().mean(dim=1)
