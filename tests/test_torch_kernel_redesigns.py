"""repro_torch's chunkwise mLSTM algebra on the CPU: ``mlstm_chunkwise_plain``
(the arithmetic the bf16 CUDA kernel runs, in fp32 PyTorch) against the
reference's Pallas kernel in interpret mode and against the per-step
``mlstm_scan_plain``, a ragged last chunk and the stabiliser's -50 floor
included; and the chunk the kernel is built for.

Tolerances: against the Pallas kernel, which computes the same chunkwise
algebra in fp32, 1e-5 (absolute and relative: h reaches about 20 at these
inputs); against the per-step recurrence 2e-3, the reference's own, since the
two forms apply the stabiliser at other points."""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_scan import mlstm_scan as pallas_mlstm
from repro_torch.kernels import mlstm_scan as ml

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
# (b, h, s, dqk, dv, chunk): test_mlstm_scan's sweep, then the shapes of
# chip_smoke.py's mLSTM sweep with a chunk that divides S, and the kernel's
# own chunk where it divides S
PALLAS_SWEEP = [(1, 2, 128, 32, 64, 32), (2, 2, 64, 16, 16, 16), (1, 2, 128, 32, 64, ml.CHUNK),
                (1, 1, 40, 8, 100, 8), (1, 2, 24, 64, 64, 8), (1, 1, 24, 128, 72, 12),
                (1, 2, 48, 256, 512, 16)]


def ident(shape):
    return "-".join(map(str, shape))


def mlstm_inputs(seed, b, h, s, dq, dv, f_shift=2.0, i_shift=0.0):
    """As test_mlstm_scan: forget gates shifted towards remembering (or by
    ``f_shift``), input gates by ``i_shift``."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, dq)).astype(np.float32)
    k = rng.standard_normal((b, h, s, dq)).astype(np.float32)
    v = rng.standard_normal((b, h, s, dv)).astype(np.float32)
    ig = (rng.standard_normal((b, h, s)) + i_shift).astype(np.float32)
    fg = (rng.standard_normal((b, h, s)) + f_shift).astype(np.float32)
    return q, k, v, ig, fg


def both(arrs):
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("shape", PALLAS_SWEEP, ids=ident)
def test_chunkwise_plain_matches_the_pallas_kernel(shape):
    b, h, s, dq, dv, ch = shape
    jargs, targs = both(mlstm_inputs(30, b, h, s, dq, dv))
    got = ml.mlstm_chunkwise_plain(*targs, chunk=ch).numpy()
    want = np.asarray(pallas_mlstm(*jargs, chunk=ch, interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("s", [40, 24, 1])
@pytest.mark.parametrize("chunk", [ml.CHUNK, 16])
def test_ragged_last_chunk_matches_the_per_step_recurrence(s, chunk):
    _, targs = both(mlstm_inputs(31 + s, 1, 2, s, 16, 24))
    got = ml.mlstm_chunkwise_plain(*targs, chunk=chunk)
    assert got.shape == (1, 2, s, 24)
    np.testing.assert_allclose(got.numpy(), ml.mlstm_scan_plain(*targs).numpy(), atol=2e-3,
                               rtol=0)


def test_ragged_chunk_equals_the_same_steps_cut_off():
    """A last chunk of t < chunk steps is the Pallas algebra with t steps: the
    first 40 steps of S 64 in chunks of 64 equal S 40 in one chunk of 40."""
    _, targs = both(mlstm_inputs(32, 1, 2, 64, 16, 24))
    cut = [t[:, :, :40].contiguous() for t in targs]
    np.testing.assert_allclose(ml.mlstm_chunkwise_plain(*cut, chunk=ml.CHUNK).numpy(),
                               ml.mlstm_chunkwise_plain(*cut, chunk=40).numpy(), atol=0, rtol=0)


def test_gates_that_reach_the_stabiliser_floor():
    """Forget gates far negative and input gates near -60: the chunk's
    stabiliser of every row past the first few sits on the floor of -50, and
    h is about 1e-25.  Relative agreement with the Pallas kernel and the
    per-step recurrence (which has no floor: the stabiliser cancels)."""
    arrs = mlstm_inputs(33, 1, 2, 64, 16, 16, f_shift=-3.0, i_shift=-60.0)
    jargs, targs = both(arrs)
    # the chunk's running sums: the rows whose every term lies below -50
    bcum = np.cumsum(np.log(1 / (1 + np.exp(-arrs[4].astype(np.float64)))), axis=-1)
    dmax = np.max(bcum[..., :, None] - bcum[..., None, :] + arrs[3][..., None, :]
                  + np.triu(np.full((64, 64), -1e30), 1), axis=-1)
    assert (np.maximum(dmax, bcum) < ml.LOG_FLOOR).mean() > 0.5
    got = ml.mlstm_chunkwise_plain(*targs, chunk=ml.CHUNK).numpy().astype(np.float64)
    assert 0 < np.abs(got).max() < 1e-20
    scale = 1 / np.abs(got).max()
    want = np.asarray(pallas_mlstm(*jargs, chunk=ml.CHUNK, interpret=True)).astype(np.float64)
    np.testing.assert_allclose(got * scale, want * scale, atol=1e-5, rtol=1e-5)
    per_step = ml.mlstm_scan_plain(*targs).numpy().astype(np.float64)
    np.testing.assert_allclose(got * scale, per_step * scale, atol=2e-3, rtol=0)


def test_bf16_inputs_give_bf16():
    _, targs = both(mlstm_inputs(34, 1, 1, 70, 8, 16))
    targs[:3] = [t.bfloat16() for t in targs[:3]]
    got = ml.mlstm_chunkwise_plain(*targs)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 1, 70, 16)
    np.testing.assert_allclose(got.float().numpy(), ml.mlstm_scan_plain(*targs).float().numpy(),
                               atol=2e-2, rtol=2e-2)


def test_the_kernel_is_built_for_the_module_chunk():
    """``mlstm_scan.CHUNK`` is the chunk the CUDA source is built for (its
    kT), and the wrapper hands it to the launcher, which checks it."""
    src = (CSRC / "mlstm_scan.cu").read_text()
    assert int(re.search(r"constexpr int kT = (\d+);", src).group(1)) == ml.CHUNK
    assert "if (chunk != repro::mlstm::kT) return -3;" in src
    wrapper = (CSRC.parent / "mlstm_scan.py").read_text()
    assert "_DTYPE_CODE[q.dtype], CHUNK, scale, stream" in wrapper


@pytest.mark.parametrize("name", ["decode_attention", "paged_attention"])
def test_both_decode_kernels_walk_the_shared_ring(name):
    """The dense and the paged decode kernels are one cp.async ring loop
    (``decode_tile.cuh::ring_walk``) with two row maps."""
    src = (CSRC / f"{name}.cu").read_text()
    assert '#include "decode_tile.cuh"' in src and "dtile::ring_walk(" in src
    assert "attn_tile.cuh" not in src


@pytest.mark.parametrize("dqk,dv", [(256, 512), (8, 100), (32, 72), (128, 16)])
def test_chunk_layout_pads_rows_for_the_tensor_maps(dqk, dv):
    """What the bf16 kernel's TMA boxes need: q and k rows of 64, 128 or 256
    values, v rows of a multiple of 8, the added columns zero; xLSTM's shape
    (dqk 256, dv 512) passes through without a copy."""
    _, (q, k, v, _, _) = both(mlstm_inputs(35, 1, 2, 24, dqk, dv))
    q, k, v = (t.bfloat16() for t in (q, k, v))
    q2, k2, v2, dqk_row, dv_row = ml._chunk_layout(q, k, v)
    assert dqk_row == max(dqk, 64) and dv_row % 8 == 0 and dv <= dv_row < dv + 8
    assert q2.shape[-1] == k2.shape[-1] == dqk_row and v2.shape[-1] == dv_row
    for got, want in ((q2, q), (k2, k), (v2, v)):
        assert torch.equal(got[..., :want.shape[-1]], want)
        assert not got[..., want.shape[-1]:].any()
        assert got.is_contiguous() and got.data_ptr() % 16 == 0
    if (dqk, dv) == (256, 512):
        assert q2 is q and k2 is k and v2 is v
