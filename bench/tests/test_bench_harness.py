"""The harness end to end on the CPU at a tiny size: a cell runs, its result
line has the contract's keys, and a new mix is found by its name alone."""
import json

from bench.harness.cell import load
from bench.tests import tiny


def test_a_new_mix_file_is_found_by_name(tmp_path):
    (tmp_path / "mixes").mkdir()
    mix = dict(load("mixes", "tweets_top10_pointwise"), family_args={"n": 12})
    (tmp_path / "mixes" / "throwaway_mix.json").write_text(json.dumps(mix))
    found = load("mixes", "throwaway_mix", base=tmp_path)
    assert found["family_args"] == {"n": 12}
    cell = dict(tiny.cell_named("phi4-mini-3.8b.tweets_top10_pointwise"),
                name="phi4-mini-3.8b.throwaway_mix", traffic="throwaway_mix")
    config = load("configs", cell["config"])
    tiny.shrink(config, found)
    out = tiny.run(cell, config, found)
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"probes_per_s", "setup_s"}
    assert list(out)[-1] == "check"


def test_quick_cell_runs_correct_and_traced():
    cell = tiny.cell_named("stablelm-1.6b-short.nba_top10_quick")
    config, mix = load("configs", cell["config"]), load("mixes", cell["traffic"])
    tiny.shrink(config, mix)
    mix["family_args"] = {"n": 40}
    out = tiny.run(cell, config, mix, traced=True)
    assert out["correct"], out["check"]
    assert {"operator_host_ms_per_tick", "probe_rows_per_submission",
            "prefix_hit_rate", "prefill_tokens_per_probe", "mfu"} <= set(out["metrics"])
    assert "paged_attention_roofline" not in out["metrics"]
    assert out["check"]["order_faults"]["value"] == 0
    assert out["device"]["window_s"] > 0 and "breakdown" in out


def test_the_weights_follow_the_configuration_not_the_run_seed(monkeypatch):
    from bench.harness import cell as cell_mod
    drawn = []
    architecture = cell_mod.architecture

    def recording(config, base=cell_mod.BENCH):
        arch = architecture(config, base)      # a fresh module each run
        draw = arch.draw

        def draw_recorded(model, seed, device):
            drawn.append(seed)
            return draw(model, seed, device)

        arch.draw = draw_recorded
        return arch

    monkeypatch.setattr(cell_mod, "architecture", recording)
    cell = tiny.cell_named("phi4-mini-3.8b.tweets_top10_pointwise")
    config, mix = load("configs", cell["config"]), load("mixes", cell["traffic"])
    tiny.shrink(config, mix)
    mix["family_args"] = {"n": 8}
    for seed in (5, 2**31 + 3):
        assert tiny.run(cell, config, mix, seed=seed, seconds=0.5)["correct"]
    assert drawn == [config["weights_seed"]] * 2


def test_a_tick_longer_than_the_window_is_still_traced():
    cell = tiny.cell_named("phi4-mini-3.8b.tweets_top10_pointwise")
    config, mix = load("configs", cell["config"]), load("mixes", cell["traffic"])
    tiny.shrink(config, mix)
    mix["family_args"] = {"n": 12}
    out = tiny.run(cell, config, mix, seconds=0.01, traced=True)
    assert out["correct"], out["check"]
    assert out["device"]["window_s"] > 0 and "breakdown" in out


def test_an_auto_mix_runs_through_the_optimizer_driver(tmp_path):
    mix = dict(load("mixes", "tweets_top10_pointwise"), path="auto", strategy="borda",
               sample_size=8, family_args={"n": 16}, readouts=["score", "compare", "inquire"])
    (tmp_path / "mixes").mkdir()
    (tmp_path / "mixes" / "auto_mix.json").write_text(json.dumps(mix))
    found = load("mixes", "auto_mix", base=tmp_path)
    cell = dict(tiny.cell_named("phi4-mini-3.8b.tweets_top10_pointwise"),
                name="phi4-mini-3.8b.auto_mix", traffic="auto_mix")
    config = load("configs", cell["config"])
    tiny.shrink(config, found, clients=1)
    found["wait_for_queries"] = False
    out = tiny.run(cell, config, found, seconds=1.0, traced=True)
    assert out["correct"], out["check"]
    assert out["metrics"]["operator_host_ms_per_tick"]["value"] > 0
