"""The plain reference against the port's model on the CPU, at a reduced
configuration in fp32: prefill, suffix prefill over a cached prefix, and
decode steps, on the padded rows the engine serves."""
import pytest
import torch

from bench.architectures import dense
from bench.harness import reference as ref
from bench.harness import weights as W

MODEL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
         "d_ff": 128, "vocab_size": 512, "rope_theta": 10000.0, "norm_eps": 1e-5}


def _pair():
    from repro_torch.models import LM
    from repro_torch.models.config import ModelConfig
    w = dense.draw(MODEL, 2**31 + 3, "cpu")
    w = {k: ({n: t.float() for n, t in v.items()} if isinstance(v, dict) else v.float())
         for k, v in w.items()}
    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16,
                      pattern=(("attn", 2),), rope_theta=10000.0, dtype="float32")
    return LM.from_tree(cfg, dense.program_tree(w)), dense.Reference(MODEL, w)


@pytest.mark.parametrize("prompt", [
    ref.compare_prompt("player-3 w12 w7", "player-9 w4400", "player height"),
    ref.score_prompt("tweet-1 w5 w66 w777", "intensity of positivity"),
    "a plain prompt"])
def test_prefill_matches_the_port(prompt):
    lm, reference = _pair()
    row = ref.padded_row(ref.prompt_ids(prompt))
    with torch.inference_mode():
        got, _ = lm.prefill({"tokens": torch.tensor([row])})
    want = reference.logits(row, [len(row) - 1])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_suffix_prefill_over_a_cached_prefix_matches():
    lm, reference = _pair()
    prefix, suffix = ref.compare_prompt("player-3 w12", "player-9 w4400 w1", "player height")
    row = ref.padded_row(ref.prompt_ids((prefix, suffix)))
    start = len(row) - len(ref.encode(suffix, bos=False))
    with torch.inference_mode():
        _, caches = lm.prefill({"tokens": torch.tensor([row[:start]])})
        got, _ = lm.prefill_cont(caches, {"tokens": torch.tensor([row[start:]])})
    torch.testing.assert_close(got, reference.logits(row, [len(row) - 1]),
                               rtol=1e-4, atol=1e-4)


def test_decode_steps_match_and_token_gaps_read_zero():
    lm, reference = _pair()
    row = ref.padded_row(ref.prompt_ids("Criteria: x\nRanking: a > b\nJudge rationale:"))
    toks, logits = [], []
    with torch.inference_mode():
        out, caches = lm.prefill({"tokens": torch.tensor([row])}, reserve=8)
        for t in range(6):
            toks.append(int(out.argmax()))
            logits.append(out[0])
            out, caches = lm.decode_step(caches, torch.tensor([[toks[-1]]]), len(row) + t)
    at = list(range(len(row) - 1, len(row) + 5))
    want = reference.logits(row + toks[:-1], at)
    torch.testing.assert_close(torch.stack(logits), want, rtol=1e-4, atol=1e-4)
    assert want.argmax(dim=-1).tolist() == toks


def test_readout_pairs_are_centred():
    w = dense.draw(MODEL, 11, "cpu")
    from bench.harness.traffic import nba_heights
    table = nba_heights(40, seed=5)
    prompts = W.balance_prompts(table, 11, ["compare", "score"], n=16)
    assert set(prompts) == {(ref.TOK_A, ref.TOK_B), (ref.TOK_HI, ref.TOK_LO)}
    W.balance_readouts(dense, w, MODEL, prompts)
    r = dense.Reference(MODEL, w, quant="bf16")
    diffs = []
    for p in prompts[(ref.TOK_A, ref.TOK_B)]:
        row = ref.padded_row(ref.prompt_ids(p))
        lg = (r.hidden(row, [len(row) - 1]) @ w["lm_head"].float())[0]
        diffs.append(float(lg[ref.TOK_A] - lg[ref.TOK_B]))
    spread = torch.tensor(diffs).std()
    assert abs(sum(diffs) / len(diffs)) < 0.2 * spread
