"""Load the reference's parameters into the port's ``LM``, and carry an
optimizer state across.

No counterpart in ``src/repro/``.  The caller turns the reference's pytree
into numpy arrays; nothing here imports JAX.  Names, ``(d_in, d_out)`` layouts
and the leading layer dim are the same on both sides, so conversion is a copy.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.config import ModelConfig
from .models.model import LM, _flatten
from .training.tree import map_tree


def to_tensor(arr, device=None, dtype=None) -> torch.Tensor:
    """numpy -> torch, bit-exact.  A bfloat16 numpy array (``ml_dtypes``) is
    refused by ``torch.from_numpy``; it is reinterpreted through its 16-bit
    pattern instead of a float round trip."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device=device, dtype=dtype)


# parameters the reference keeps in fp32 whatever the model's dtype
FP32_PARAMS = frozenset({
    "norm1", "norm2", "norm_x", "fuse_a", "fuse_s",     # norm scales
    "ssm_dt_bias", "ssm_A_log", "ssm_D_skip",           # SSM coefficients
    "gn_scale", "b_z", "b_i", "b_f", "b_o"})            # xLSTM norms, biases


def from_jax_params(params, cfg: ModelConfig, device=None, dtype=None) -> LM:
    """Build an ``LM`` for ``cfg`` holding ``params``: the reference's pytree
    as numpy arrays (``embed``, ``final_norm``, ``stacks[i]`` dicts with a
    leading layer dim, nested ``ffn`` / ``moe`` / ``ssm`` dicts and the flat
    mLSTM / sLSTM / ``xdec`` keys, optional ``lm_head``, and with an encoder
    ``enc_stacks`` and ``enc_norm``).  ``dtype`` overrides the weights'
    dtype; the names in :data:`FP32_PARAMS` and the final and encoder norms
    stay fp32."""
    lm = LM(cfg, device=device)

    def load(dst: torch.nn.Parameter, src, keep_dtype=False):
        t = to_tensor(src, lm.device, None if keep_dtype else dtype)
        if t.shape != dst.shape:
            raise ValueError(f"shape {tuple(t.shape)} does not fit "
                             f"{tuple(dst.shape)}")
        dst.data = t

    load(lm.embed, params["embed"])
    load(lm.final_norm, params["final_norm"], keep_dtype=True)
    if cfg.tie_embeddings != ("lm_head" not in params):
        raise ValueError("lm_head does not match cfg.tie_embeddings")
    if not cfg.tie_embeddings:
        load(lm.lm_head, params["lm_head"])
    if ("enc_stacks" in params) != (lm.enc_stacks is not None):
        raise ValueError("enc_stacks does not match cfg.enc_pattern")
    pairs = [(lm.stacks, params["stacks"], "pattern")]
    if lm.enc_stacks is not None:
        load(lm.enc_norm, params["enc_norm"], keep_dtype=True)
        pairs.append((lm.enc_stacks, params["enc_stacks"], "enc_pattern"))
    for stacks, srcs, field in pairs:
        if len(srcs) != len(stacks):
            raise ValueError(f"number of stacks does not match cfg.{field}")
        for dst, src in zip(stacks, srcs):
            flat = _flatten(src)
            if set(flat) != set(dst.keys()):
                raise ValueError(f"stack keys {sorted(flat)} != {sorted(dst.keys())}")
            for name, arr in flat.items():
                load(dst[name], arr, keep_dtype=name in FP32_PARAMS)
    return lm


def tree_from_jax(tree, device=None):
    """A reference pytree of numpy arrays (nested dicts and lists) as the
    same tree of tensors, bit-exact (bf16 through its bit pattern)."""
    return map_tree(lambda a: to_tensor(a, device), tree)


def opt_state_from_jax(opt, device=None) -> dict:
    """The reference's optimizer state ``{"m", "v", "step"}`` (numpy arrays)
    as the port's: fp32 moments on ``device`` in the parameters' tree (the
    reference's tree is the same as ``LM.param_tree()``'s), the step a 0-dim
    int32 CPU tensor."""
    return {"m": tree_from_jax(opt["m"], device), "v": tree_from_jax(opt["v"], device),
            "step": torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int32)}
