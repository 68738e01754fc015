"""A configuration's model is its architecture's file, found by name.

``dense`` draws the weights it drew before it moved into
``bench/architectures/``, bit for bit; a second architecture (a tiny
Mixtral-style ``moe`` stack, ``toy_moe.py``) runs end to end from new files
alone, and an altered copy of its reference fails the check."""
import hashlib
import json
from pathlib import Path

import pytest
import torch

from bench.architectures import dense
from bench.harness.cell import architecture, load
from bench.tests import tiny

# sha256 of each tensor's bytes as ``bench/harness/weights.py``'s ``draw``
# returned it at commit 2cd79636896d (before the move), on the CPU, for
# tiny.TINY with 2 kv heads at seed 2**31 + 5
DIGESTS = {
    "embed": "37afcd3bdcde25cdaa547acad8c9a3c40249d651dd9d1b3323587a8e7d1cb10c",
    "final_norm": "9e820f2b0129bbf841803f6817e380544d0a8137430c4a6eeb75f488d53645cc",
    "lm_head": "7398cfd77dd908a8727e6b8a89d157082cf5ac0f9064e267d51bca37c7398c62",
    "layers.norm1": "f16f77a28ddbc3f8f71f647523fb4f8f6c2feb1319778c9c33a6039eb0cc91fe",
    "layers.wq": "ebaf1671f29cdc518c17cbc622823c18584f6cca9184120023f7f11f5e95bf49",
    "layers.wk": "98ebf00bd598382d5e32cc70ffdebe39adc3393b2d3e46d9309aa33462154213",
    "layers.wv": "4676b26ce3af72c316d2e245fd64bf49513f5a1de72f276c82ac43e1a7a1d0fe",
    "layers.wo": "159e710b8f71def0b2fde8ca9a2b20480f90c2c2543be8925298025bd61f7df9",
    "layers.norm2": "ff0f99d30499746480cab94712af23b4d58d87dbb3da42b16b6bd04389ca7508",
    "layers.w_gate": "a2c1cf3545cc7cd93988d287c998ffa4a5d30b8a09fb07f30a9856551e55c309",
    "layers.w_up": "1b890be5e8ce4e899b5e2b804dd53cdd4099b6877a27a17eecce54d4fefdfc64",
    "layers.w_down": "ae15066949d3b99f6e11d979e292f7cea69c339d1445ade712b06345e8e8959e",
}


def digests(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(digests(v, f"{prefix}{k}."))
        else:
            raw = v.contiguous().view(torch.uint8).numpy().tobytes()
            out[prefix + k] = hashlib.sha256(raw).hexdigest()
    return out


def test_dense_draws_the_weights_it_drew_before_the_move():
    model = dict(tiny.TINY, n_kv_heads=2, rope_theta=10000.0, norm_eps=1e-5)
    assert digests(dense.draw(model, 2**31 + 5, "cpu")) == DIGESTS


def test_a_configuration_without_the_key_is_dense():
    for name in ("stablelm-1.6b-short", "stablelm-1.6b", "phi4-mini-3.8b"):
        config = load("configs", name)
        assert "architecture" not in config
        assert architecture(config).__file__ == dense.__file__


def _toy_moe(base: Path, top_k_of_reference=None):
    """Under ``base``: ``architectures/toy_moe.py`` (with its reference's
    routing replaced where asked) and ``configs/toy_moe.json`` naming it,
    phi4-mini's file shrunk, and the mix of cell 4 shrunk."""
    src = (Path(__file__).parent / "toy_moe.py").read_text()
    if top_k_of_reference is not None:
        line = 'top_k = self.m["top_k"]'
        assert src.count(line) == 1
        src = src.replace(line, f"top_k = {top_k_of_reference}")
    (base / "architectures").mkdir()
    (base / "architectures" / "toy_moe.py").write_text(src)
    config = load("configs", "phi4-mini-3.8b")
    mix = load("mixes", "tweets_top10_pointwise")
    tiny.shrink(config, mix)
    # 4 experts, top 2, and a capacity of every token for every expert
    # (n_experts / top_k): a dropped slot would make a row's answer depend
    # on its batch-mates, which a reference of one row at a time cannot
    # follow.  The port serves ``moe`` stacks without prefix reuse or a
    # paged pool, so the engine takes neither.
    config["model"].update(n_experts=4, top_k=2, capacity_factor=2.0)
    config["engine"].update(prefix_cache_size=0, pool_blocks=0, paged_kernel=False)
    config.update(name="toy_moe", architecture="toy_moe")
    (base / "configs").mkdir()
    (base / "configs" / "toy_moe.json").write_text(json.dumps(config))
    mix["family_args"] = {"n": 16}
    cell = {"name": "toy_moe.tweets_top10_pointwise", "config": "toy_moe",
            "traffic": "tweets_top10_pointwise", "chips": 1}
    return cell, load("configs", "toy_moe", base=base), mix


@pytest.mark.parametrize("top_k_of_reference, correct", [(None, True), (1, False)],
                         ids=["top2-reference-correct", "top1-reference-not-correct"])
def test_a_new_architecture_is_new_files_only(tmp_path, top_k_of_reference, correct):
    cell, config, mix = _toy_moe(tmp_path, top_k_of_reference)
    assert architecture(config, tmp_path).__file__ == str(
        tmp_path / "architectures" / "toy_moe.py")
    out = tiny.run(cell, config, mix, base=tmp_path)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["check"]["probe_rows_compared"]["value"] > 0
    assert out["correct"] is correct, out["check"]
    gap = out["check"]["probe_logit_gap"]
    assert (gap["value"] <= gap["limit"]) is correct
