"""The check fails a run whose timed path is broken underneath: an answer
altered where it is produced, logits altered where they are produced, half
of a submission left out (the mean of the rest in its place).  The
program's classes are patched for the test only (one chip: no exchange
between chips to leave out; the cells decode nothing, so no decode step
that could leave its state unchanged)."""
import numpy as np

from bench.harness.cell import load
from bench.tests import tiny


def _cell(name, **mix_kw):
    cell = tiny.cell_named(name)
    config, mix = load("configs", cell["config"]), load("mixes", cell["traffic"])
    tiny.shrink(config, mix)
    mix.update(mix_kw)
    return cell, config, mix


def _pointwise():
    return _cell("phi4-mini-3.8b.tweets_top10_pointwise", family_args={"n": 16})


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from repro_torch.core.oracles.model_oracle import ModelOracle
    finish = ModelOracle.finish_probe_round

    def altered(self, token, sink):
        raw = finish(self, token, sink)
        return [v + 0.5 for v in raw[:1]] + list(raw[1:])

    monkeypatch.setattr(ModelOracle, "finish_probe_round", altered)
    out = tiny.run(*_pointwise())
    assert not out["correct"]
    assert out["check"]["readout_faults"]["value"] > 0


def test_logits_altered_where_they_are_produced(monkeypatch):
    from repro_torch.serving.engine import ServeEngine
    submit = ServeEngine.submit_probes

    def altered(self, prompts, max_batch=None):
        out = submit(self, prompts, max_batch)
        return out + np.random.default_rng(0).normal(0, 1, out.shape).astype(out.dtype)

    monkeypatch.setattr(ServeEngine, "submit_probes", altered)
    out = tiny.run(*_pointwise())
    assert not out["correct"]
    assert out["check"]["probe_logit_gap"]["value"] > out["check"]["probe_logit_gap"]["limit"]


def test_half_of_the_batch_left_out(monkeypatch):
    from repro_torch.serving.engine import ServeEngine
    submit = ServeEngine.submit_probes

    def half(self, prompts, max_batch=None):
        keep = max(1, len(prompts) // 2)
        out = submit(self, list(prompts)[:keep], max_batch)
        rest = np.repeat(out.mean(axis=0, keepdims=True), len(prompts) - keep, axis=0)
        return np.concatenate([out, rest])

    monkeypatch.setattr(ServeEngine, "submit_probes", half)
    out = tiny.run(*_pointwise())
    assert not out["correct"]

