"""The port's launch tooling against the reference's: ``launch/specs.py``
(every arch x shape: input shapes and dtypes, ``cell_applicable``),
``launch/roofline.py`` (model FLOPs, inner-scan corrections; terms on the
H100 constants), ``launch/pricing.py`` (``tests/test_pricing.py``'s three
contracts, and the reference's ``PriceSheet`` from the same records at an
explicit price), ``launch/report.py`` (the reference's tables, the mesh
label aside), ``make_production_mesh``, and the kernels' ``bound_ms`` on the
constants ``launch/mesh.py`` now holds.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import get_reduced as jreduced
from repro.configs import list_archs as jlist
from repro.launch import pricing as jpricing
from repro.launch import report as jreport
from repro.launch import roofline as jroof
from repro.launch import specs as jspecs
from repro.models.config import SHAPES as JSHAPES
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.core import SimulatedOracle, llm_order_by
from repro_torch.core.datasets import passages
from repro_torch.kernels import (borda_count, decode_attention, flash_attention,
                                 mlstm_scan, moe_gating, paged_attention, ssm_scan,
                                 topk_scores)
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import pricing, report, roofline, specs
from repro_torch.models.config import SHAPES
from repro_torch.training.tree import leaves

CELLS = [(a, s) for a in jlist() for s in JSHAPES]


def test_arch_and_shape_lists_equal_reference():
    assert list_archs() == jlist()
    assert {k: (v.seq_len, v.global_batch, v.kind) for k, v in SHAPES.items()} == \
        {k: (v.seq_len, v.global_batch, v.kind) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("arch,shape", CELLS, ids=lambda x: x)
def test_input_specs_equal_reference(arch, shape):
    jcfg, cfg = jget(arch), get_config(arch)
    assert specs.cell_applicable(cfg, shape) == jspecs.cell_applicable(jcfg, shape)
    want = [(tuple(x.shape), str(np.dtype(x.dtype)))
            for x in jax.tree.leaves(jax.eval_shape(lambda: jspecs.input_specs(jcfg, shape)))]
    got_tree = specs.input_specs(cfg, shape)
    got = [(tuple(t.shape), str(t.dtype).replace("torch.", "")) for t in leaves(got_tree)]
    assert got == want
    assert all(t.device.type == "meta" for t in leaves(got_tree))


@pytest.mark.parametrize("arch", jlist())
def test_model_flops_and_scan_corrections_equal_reference(arch):
    for cfg, jcfg in ((get_config(arch), jget(arch)), (get_reduced(arch), jreduced(arch))):
        for name in SHAPES:
            for chunk in (cfg.scan_chunk, 64):
                c = dataclasses.replace(cfg, scan_chunk=chunk)
                jc = dataclasses.replace(jcfg, scan_chunk=chunk)
                assert roofline.model_flops(c, SHAPES[name]) == \
                    jroof.model_flops(jc, JSHAPES[name])
                assert roofline.inner_scan_flop_correction(c, SHAPES[name]) == \
                    jroof.inner_scan_flop_correction(jc, JSHAPES[name])


def fake_cell(arch="llama3-8b", shape="prefill_32k", **extra):
    rec = {"arch": arch, "shape": shape, "multi_pod": False, "chips": 256,
           "cost_analysis": {"flops": 3.0e13, "bytes accessed": 5.0e11},
           "collectives": {"bytes_by_axis": {"model": 4.0e9, "data": 1.0e9}}}
    rec.update(extra)
    return rec


def test_roofline_terms_use_the_h100_constants():
    cfg, shape = get_config("llama3-8b"), SHAPES["prefill_32k"]
    t = roofline.roofline_terms(fake_cell(), cfg, shape)
    assert t["compute_s"] == pytest.approx(3.0e13 / 989e12, rel=1e-5)
    assert t["memory_s"] == pytest.approx(5.0e11 / 3.35e12, rel=1e-5)
    assert t["collective_s"] == pytest.approx(4.0e9 / 450e9 + 1.0e9 / 50e9, rel=1e-5)
    assert t["dominant"] == "memory_s"
    assert t["step_time_bound_s"] == t["memory_s"]
    assert t["inner_scan_correction"] == 0.0
    assert t["hlo_flops_global"] == pytest.approx(3.0e13 * 256, rel=1e-5)
    assert t["model_flops"] == pytest.approx(roofline.model_flops(cfg, shape), rel=1e-5)
    jrec = {"chips": 256, "cost_analysis": {"flops": 3.0e13, "bytes accessed": 5.0e11},
            "collectives": {"total_bytes": 5.0e9}}
    assert set(t) == set(jroof.roofline_terms(jrec, jget("llama3-8b"), JSHAPES["prefill_32k"]))
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.HBM_BW, tmesh.NVLINK_BW, tmesh.IB_BW) == \
        (989e12, 3.35e12, 450e9, 50e9)


def test_production_mesh_is_hgx_nodes_of_eight():
    m = tmesh.make_production_mesh()
    assert m.axis_names == ("data", "model") and m.shape == {"data": 32, "model": 8}
    assert m.size == 256 and tmesh.mesh_label(m) == "32x8"
    mp = tmesh.make_production_mesh(multi_pod=True)
    assert mp.axis_names == ("pod", "data", "model")
    assert mp.size == 512 and tmesh.mesh_label(mp) == "2x32x8"


# ---------------------------------------------------------------- pricing
def fake_records():
    def rec(arch, shape, bound):
        return {"arch": arch, "shape": shape, "chips": 256, "multi_pod": False,
                "roofline": {"step_time_bound_s": bound}}
    return [rec("llama3-8b", "prefill_32k", 8.28),
            rec("llama3-8b", "decode_32k", 0.341)]


def test_price_sheet_math():
    ps = pricing.price_sheet_from_records(fake_records(), "llama3-8b",
                                          chip_hour_usd=1.2, utilization=1.0)
    pod_usd_s = 256 * 1.2 / 3600
    pre_tok_s = 32 * 32768 / 8.28
    assert ps.input_per_mtok == pytest.approx(pod_usd_s / pre_tok_s * 1e6)
    assert ps.output_per_mtok > ps.input_per_mtok  # decode >> prefill $/tok
    assert "self-hosted" in ps.name


def test_optimizer_runs_on_selfhosted_prices():
    ps = pricing.price_sheet_from_records(fake_records(), "llama3-8b", chip_hour_usd=1.2)
    task = passages(n=40, seed=50)
    oracle = SimulatedOracle(task.profile, prices=ps)
    res, rep = llm_order_by(task.keys, task.criteria, oracle, path="auto",
                            descending=True, limit=10)
    assert rep.total_cost == pytest.approx(oracle.spend(), rel=1e-6)
    assert res.cost > 0


def test_missing_arch_raises():
    with pytest.raises(KeyError):
        pricing.price_sheet_from_records(fake_records(), "qwen2-vl-7b", chip_hour_usd=1.2)


def test_price_needs_an_explicit_chip_price_and_equals_reference():
    with pytest.raises(TypeError):
        pricing.price_sheet_from_records(fake_records(), "llama3-8b")
    for price, util in ((1.2, 0.6), (2.99, 1.0)):
        got = pricing.price_sheet_from_records(fake_records(), "llama3-8b",
                                               chip_hour_usd=price, utilization=util)
        want = jpricing.price_sheet_from_records(fake_records(), "llama3-8b",
                                                 chip_hour_usd=price, utilization=util)
        assert (got.input_per_mtok, got.output_per_mtok, got.name) == \
            (want.input_per_mtok, want.output_per_mtok, want.name)


# ----------------------------------------------------------------- report
def report_records():
    ok = fake_cell(memory_analysis={"argument_size_in_bytes": 3 << 30,
                                    "temp_size_in_bytes": 5 << 20},
                   collectives={"bytes": {"all-reduce": 1 << 30, "all-gather": 2048,
                                          "all-to-all": 0, "collective-permute": 0}},
                   roofline={"compute_s": 0.1, "memory_s": 0.2, "collective_s": 0.01,
                             "dominant": "memory_s", "model_flops": 1e15,
                             "hlo_flops_global": 2e15, "useful_ratio": 0.5,
                             "step_time_bound_s": 0.2})
    return [ok, dict(ok, multi_pod=True, compile_s=1.5),
            {"arch": "llama3-8b", "shape": "long_500k", "multi_pod": False,
             "skipped": "pure full-attention arch: a 524288-token dense KV cache"},
            {"arch": "hymba-1.5b", "shape": "train_4k", "multi_pod": True,
             "error": "NotImplementedError: hymba-1.5b: tensor parallelism"}]


def test_report_tables_equal_reference_but_the_mesh_label():
    recs = report_records()
    want = jreport.dryrun_table(recs).replace("2x16x16", "2x32x8").replace("16x16", "32x8")
    assert report.dryrun_table(recs) == want
    assert report.roofline_table(recs) == jreport.roofline_table(recs)
    assert report.dryrun_table([dict(recs[0], mesh="1x1")]).splitlines()[2].startswith(
        "| llama3-8b | prefill_32k | 1x1 |")


# ------------------------------------------------------- card constants
def test_kernel_bounds_unchanged_by_the_shared_constants():
    """``bound_ms`` of every kernel at a few shapes, against the values the
    kernels' own copies of the H100 figures (3.35e12 B/s, 989e12 / 67e12
    FLOP/s) gave."""
    hbm, bf16, fp32 = 3.35e12, 989e12, 67e12
    item = 2
    fl_bytes = item * 64 * (2 * 2 * 8 * 128 + 2 * 2 * 2 * 128)
    fl_ops = 4 * 64 * 2 * 8 * (128 * 129 // 2)
    assert flash_attention.bound_ms(2, 8, 2, 128, 128, 64, torch.bfloat16, causal=True) == \
        max((1e3 * fl_bytes / hbm, "bytes"), (1e3 * fl_ops / bf16, "operations"))
    assert flash_attention.bound_ms(2, 8, 2, 128, 128, 64, torch.float32, causal=True)[0] == \
        pytest.approx(max(2e3 * fl_bytes / hbm, 1e3 * fl_ops / fp32))
    assert decode_attention.bound_ms(600, 32, 32, 8, 1024, 128, 2) == pytest.approx(
        1e3 * decode_attention.live_bytes(600, 32, 32, 8, 1024, 128, 2) / hbm)
    ctx = [17, 200, 33]
    assert paged_attention.bound_ms(ctx, 16, 32, 8, 128, 2) == pytest.approx(
        1e3 * paged_attention.live_bytes(ctx, 16, 32, 8, 128, 2) / hbm)
    assert moe_gating.bound_ms(2048, 8, 2, 4) == max(
        (1e3 * moe_gating.live_bytes(2048, 8, 2, 4) / hbm, "bytes"),
        (1e3 * moe_gating.operations(2048, 8, 2) / fp32, "operations"))
    ops = ssm_scan.OPS_PER_STATE * 16 * 128 * 1600 * 16
    assert ssm_scan.bound_ms(16, 128, 1600, 16, 2) == max(
        (1e3 * ssm_scan.live_bytes(16, 128, 1600, 16, 2) / hbm, "bytes"),
        (1e3 * ops / fp32, "operations"))
    assert mlstm_scan.bound_ms(16, 4, 128, 256, 512, torch.bfloat16) == max(
        (1e3 * mlstm_scan.live_bytes(16, 4, 128, 256, 512, 2) / hbm, "bytes"),
        (1e3 * mlstm_scan.operations(16, 4, 128, 256, 512) / bf16, "operations"))
    assert topk_scores.bound_ms(1 << 20, 64, 4) == max(
        (1e3 * topk_scores.live_bytes(1 << 20, 64, 4) / hbm, "bytes"),
        (1e3 * topk_scores.operations(1 << 20, 64, 1024) / fp32, "operations"))
    assert borda_count.bound_ms(8, 8, 8) == (1e3 * borda_count.live_bytes(8, 8, 8) / hbm,
                                             "bytes")
