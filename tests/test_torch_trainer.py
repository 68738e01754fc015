"""The reference's training contracts, held inside the port on the CPU:
``tests/test_training.py`` (loss decreases, gradient accumulation equals one
batch, error feedback, compressed training converges, checkpoint round trip,
uncommitted and async checkpoints), ``tests/test_fault_tolerance.py`` (a
crashed and resumed run equals an uninterrupted one, the watchdog,
``elastic_plan``, pipeline restarts), ``tests/test_data.py``, and the
training launcher.  Reduced configs in their own bf16, as the reference's
tests run them.  Parity with the reference itself: test_torch_training.py.

The port's crash-and-resume contract is bitwise (the reference's allows 2e-2
on the loss): on one device the resumed run repeats the same operations on
the same restored bits."""
import os
import tempfile
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.data import EOS, PAD, ByteTokenizer, DataConfig, DataPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import LM
from repro_torch.training import (OptimConfig, TrainConfig, Trainer, checkpoint,
                                  init_opt_state, schedule)
from repro_torch.training.compression import compressed_grads, init_error_state
from repro_torch.training.fault_tolerance import (ElasticPlan, SimulatedFailure,
                                                  StragglerWatchdog, elastic_plan)
from repro_torch.training.tree import leaves, map_tree


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops: one intra-op thread, since the suite runs
    several workers on the machine's cores and oversubscribed threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_setup(arch="stablelm-1.6b", steps=20, **tc_kw):
    cfg = get_reduced(arch)
    lm = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tc = TrainConfig(steps=steps, log_every=0,
                     optim=OptimConfig(lr=5e-3, warmup_steps=3, total_steps=steps), **tc_kw)
    pipe = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8))
    return lm, tc, pipe


def batch_of(pipe, step=0):
    return {k: torch.from_numpy(v) for k, v in pipe.batch(step).items()}


def snapshot(lm):
    return [p.detach().clone() for p in leaves(lm.param_tree())]


# ------------------------------------------------------- tests/test_training.py
@pytest.mark.parametrize("compression", [False, True], ids=["plain", "compressed"])
def test_loss_decreases(compression):
    lm, tc, pipe = small_setup(steps=25, compression=compression)
    tr = Trainer(lm, tc)
    h = tr.run(tr.init_state(), iter(pipe), resume=False)["history"]
    assert [r["step"] for r in h] == list(range(1, 26))
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in h)
    assert h[-1]["loss"] < h[0]["loss"] * 0.95


def test_init_state_draws_from_its_generator():
    """``init_state(generator)`` redraws the model as ``LM(cfg, generator)``
    draws it (the reference's ``lm.init(key)``); without one the model keeps
    its parameters."""
    cfg = get_reduced("llama3-8b")
    want = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    lm = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(6))
    tr = Trainer(lm, TrainConfig(compression=True))
    kept = snapshot(lm)
    tr.init_state()
    assert all(torch.equal(a, b) for a, b in zip(snapshot(lm), kept))
    state = tr.init_state(torch.Generator().manual_seed(5))
    assert all(torch.equal(a, b) for a, b in zip(leaves(state["params"]), snapshot(want)))
    assert set(state) == {"params", "opt", "err"} and int(state["opt"]["step"]) == 0
    assert all(not m.any() for m in leaves(state["opt"]["m"]) + leaves(state["err"]))


def test_wsd_schedule_shape():
    cfg = OptimConfig(lr=1.0, schedule="wsd", warmup_steps=10, total_steps=100,
                      decay_start_frac=0.8)
    lrs = [float(schedule(cfg, s)) for s in range(101)]
    assert lrs[0] < 0.2
    assert lrs[10] == pytest.approx(1.0)
    assert lrs[50] == pytest.approx(1.0)
    assert lrs[100] < 0.1
    cos = OptimConfig(lr=1.0, schedule="cosine", warmup_steps=10, total_steps=100)
    assert float(schedule(cos, 55)) < 1.0


def test_grad_accum_matches_single_batch():
    """accum=2 over a batch == one step over the same batch (same grads)."""
    _, _, pipe = small_setup()
    optim = OptimConfig(lr=1e-3, warmup_steps=0, total_steps=1, schedule="const")
    out = []
    for accum in (1, 2):
        lm, _, _ = small_setup()
        tr = Trainer(lm, TrainConfig(steps=1, grad_accum=accum, log_every=0, optim=optim))
        state, metrics = tr.step(tr.init_state(), batch_of(pipe))
        assert int(state["opt"]["step"]) == 1 and np.isfinite(float(metrics["loss"]))
        out.append(snapshot(lm))
    for a, b in zip(*out):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=2e-2)


def test_compression_error_feedback():
    lm, _, pipe = small_setup()
    loss, _ = lm.loss(batch_of(pipe))
    flat = leaves(lm.param_tree())
    grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
    grads = map_tree(lambda _p, g: g, lm.param_tree(), list(grads))
    deq, err2 = compressed_grads(grads, init_error_state(lm.param_tree()))
    for g, d in zip(leaves(grads), leaves(deq)):
        g = g.float().numpy()
        np.testing.assert_allclose(d.float().numpy(), g, atol=(np.abs(g).max() + 1e-12) / 100)
    for g, e in zip(leaves(grads), leaves(err2)):
        step = (np.abs(g.float().numpy()).max() + 1e-12) / 127.0
        assert np.abs(e.numpy()).max() <= step * 1.01


def test_checkpoint_roundtrip_bitwise():
    lm, _, _ = small_setup()
    params = lm.param_tree()
    state = {"params": params, "opt": init_opt_state(params)}
    with tempfile.TemporaryDirectory() as td:
        checkpoint.save(td, 12, state, extra={"note": "x"})
        assert checkpoint.latest_step(td) == 12
        restored, manifest = checkpoint.restore(td, 12, state)
        assert manifest["step"] == 12 and manifest["extra"]["note"] == "x"
        for a, b in zip(leaves(state), leaves(restored)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert manifest["leaves"][0]["path"] == "opt/m/embed"


def test_uncommitted_checkpoint_ignored():
    with tempfile.TemporaryDirectory() as td:
        checkpoint.save(td, 5, {"w": torch.ones(4)})
        os.makedirs(os.path.join(td, "step_9"))     # a torn write: no COMMITTED
        assert checkpoint.latest_step(td) == 5


def test_async_checkpointer():
    with tempfile.TemporaryDirectory() as td:
        ac = checkpoint.AsyncCheckpointer(td, keep=2)
        x = torch.zeros(8)
        for s in (1, 2, 3):
            x.fill_(s)                  # the state changes in place after submit
            ac.submit(s, {"x": x})
        ac.wait()
        assert checkpoint.latest_step(td) == 3
        assert len(checkpoint.latest_step_all(td)) <= 2
        got, _ = checkpoint.restore(td, 2, {"x": x})
        assert torch.equal(got["x"], torch.full((8,), 2.0))


# ------------------------------------------------ tests/test_fault_tolerance.py
def setup(steps, td, **kw):
    lm, _, _ = small_setup("phi4-mini-3.8b")      # as tests/test_fault_tolerance.py
    tc = TrainConfig(steps=steps, log_every=0, ckpt_dir=td, ckpt_every=5, ckpt_async=False,
                     optim=OptimConfig(lr=3e-3, warmup_steps=2, total_steps=steps), **kw)
    pipe = DataPipeline(DataConfig(vocab_size=lm.cfg.vocab_size, seq_len=32, global_batch=8))
    return lm, tc, pipe


@pytest.mark.parametrize("kw", [{}, dict(grad_accum=2, compression=True)],
                         ids=["plain", "accum_compressed"])
def test_crash_restart_matches_uninterrupted_run(kw):
    with tempfile.TemporaryDirectory() as td1, tempfile.TemporaryDirectory() as td2:
        lm, tc, pipe = setup(12, td1, **kw)
        tr = Trainer(lm, tc)
        ref = tr.run(tr.init_state(), iter(pipe), resume=False)["history"]
        ref_params = snapshot(lm)

        lm2, tc2, pipe2 = setup(12, td2, **kw)
        tr2 = Trainer(lm2, tc2)
        tr2.injector.crash_at_step = 8            # after the step-5 checkpoint
        with pytest.raises(SimulatedFailure):
            tr2.run(tr2.init_state(), iter(pipe2), resume=False)
        lm3, tc3, pipe3 = setup(12, td2, **kw)    # a fresh process: new model, new state
        tr3 = Trainer(lm3, tc3)
        out = tr3.run(tr3.init_state(), iter(pipe3), resume=True)["history"]
        assert out[0]["step"] == 6
        ref_tail = {r["step"]: r for r in ref}
        for r in out:
            assert (r["loss"], r["grad_norm"], r["lr"]) == (
                ref_tail[r["step"]]["loss"], ref_tail[r["step"]]["grad_norm"],
                ref_tail[r["step"]]["lr"])
        for a, b in zip(snapshot(lm3), ref_params):
            assert torch.equal(a, b)
        assert checkpoint.latest_step(td2) == 12


def test_watchdog_flags_straggler():
    wd = StragglerWatchdog(threshold=3.0)
    for i in range(8):
        wd.start()
        time.sleep(0.005)
        wd.stop(i)
    wd.start()
    time.sleep(0.1)
    wd.stop(99)
    assert any(step == 99 for step, _, _ in wd.flagged)


def test_elastic_plan_shrinks_data_axis_only():
    p = elastic_plan(n_alive=512, model_parallel=16)
    assert p == ElasticPlan(data=32, model=16, dropped_hosts=0)
    p = elastic_plan(n_alive=472, model_parallel=16)
    assert p.model == 16 and p.data == 16
    assert p.n_devices <= 472
    with pytest.raises(RuntimeError):
        elastic_plan(n_alive=8, model_parallel=16)


def test_data_pipeline_restart_determinism():
    cfg = DataConfig(vocab_size=1000, seq_len=16, global_batch=8, seed=3)
    a = DataPipeline(cfg, n_shards=4, shard_id=2)
    b = DataPipeline(cfg, n_shards=4, shard_id=2)
    np.testing.assert_array_equal(a.batch(17)["tokens"], b.batch(17)["tokens"])
    c = DataPipeline(cfg, n_shards=4, shard_id=3)
    assert not (a.batch(17)["tokens"] == c.batch(17)["tokens"]).all()


# ---------------------------------------------------------- tests/test_data.py
def test_tokenizer_roundtrip():
    tok = ByteTokenizer()
    s = "hello ORDER BY world"
    assert tok.decode(tok.encode(s)) == s
    padded = tok.pad_to(tok.encode("ab"), 8)
    assert len(padded) == 8 and padded[-1] == PAD


def test_pipeline_shapes_and_range():
    b = DataPipeline(DataConfig(vocab_size=5000, seq_len=64, global_batch=16)).batch(0)
    assert b["tokens"].shape == (16, 64)
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 5000


def test_pipeline_step_determinism_and_variation():
    p = DataPipeline(DataConfig(vocab_size=5000, seq_len=32, global_batch=8, seed=1))
    np.testing.assert_array_equal(p.batch(3)["tokens"], p.batch(3)["tokens"])
    assert not (p.batch(3)["tokens"] == p.batch(4)["tokens"]).all()


def test_pipeline_shards_partition_batch():
    cfg = DataConfig(vocab_size=100, seq_len=8, global_batch=8)
    batches = [DataPipeline(cfg, n_shards=4, shard_id=i).batch(0)["tokens"] for i in range(4)]
    assert all(b.shape == (2, 8) for b in batches)
    assert not (batches[0] == batches[1]).all()


def test_corpus_backend_packs_documents():
    docs = ["first document text", "second one", "third piece of text here"]
    p = DataPipeline(DataConfig(vocab_size=300, seq_len=16, global_batch=4, backend="corpus"),
                     corpus=docs)
    b = p.batch(0)
    assert b["tokens"].shape == (4, 16)
    assert (b["tokens"] == EOS).any()


# ----------------------------------------------------------------- launcher
def test_launcher_trains_on_the_cpu(capsys):
    out = launch_train.main(["--device", "cpu", "--reduced", "--steps", "3",
                             "--arch", "minicpm-2b"])
    h = out["history"]
    assert [r["step"] for r in h] == [1, 2, 3] and all(np.isfinite(r["loss"]) for r in h)
    text = capsys.readouterr().out
    assert "arch=minicpm-2b-smoke" in text and "schedule=wsd" in text and "done: loss" in text


def test_launcher_resumes_from_its_checkpoints(capsys):
    with tempfile.TemporaryDirectory() as td:
        args = ["--device", "cpu", "--reduced", "--steps", "2", "--ckpt-dir", td]
        launch_train.main(args)
        assert checkpoint.latest_step(td) == 2
        again = launch_train.main(args)
        assert again["history"] == []
        assert "already trained" in capsys.readouterr().out
