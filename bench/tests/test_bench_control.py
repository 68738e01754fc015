"""The control at a size a test run holds: the fp8 reference put in the
program's place reads above the limits the sound program stays under, and
the run's own predicate judges it not correct."""
from bench.harness.cell import load
from bench.tests import tiny


def test_the_fp8_control_fails_where_the_program_passes():
    cell = tiny.cell_named("stablelm-1.6b-short.nba_top10_quick")
    config, mix = load("configs", cell["config"]), load("mixes", cell["traffic"])
    tiny.shrink(config, mix)
    config["model"].update(n_layers=4, d_model=256, n_heads=4, n_kv_heads=4,
                           head_dim=64, d_ff=704)
    mix["family_args"] = {"n": 24}
    mix["check"]["probe_rows"] = 16
    out = tiny.run(cell, config, mix, control=True)
    gap = out["check"]["probe_logit_gap"]
    assert out["correct"] and gap["value"] <= gap["limit"]
    assert out["control"]["control_probe_logit_gap"] > gap["limit"]
    assert out["control"]["control_correct"] is False
