"""thor_tpu_torch's dequant + inverse transform against thor_tpu's, exactly.

Inputs come from numpy seeds and go through the JAX function and its
torch port on the CPU; the codec is integer arithmetic, so the
comparison is exact (tolerance 0).
"""
import numpy as np
import pytest
import torch

from thor_tpu.dec import device_pixels as JDP
from thor_tpu.ops import transform as JT
from thor_tpu_torch.dec import device_pixels as PDP
from thor_tpu_torch.ops import transform as PT

torch.set_num_threads(1)


def _coeffs(rng, B, size):
    qsize = min(size, 16)
    coeff = np.zeros((B, size, size), np.int32)
    for b in range(B):
        mag = [64, 512, 4096, 32767][b % 4]
        coeff[b, :qsize, :qsize] = rng.integers(-mag, mag, (qsize, qsize))
    return coeff


@pytest.mark.parametrize("size", [4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("bitdepth", [8, 10])
def test_inv_transform_batch(size, bitdepth):
    coeff = _coeffs(np.random.default_rng(size + bitdepth), 12, size)
    ref = np.asarray(JT.inv_transform_batch(coeff, size, bitdepth))
    got = PT.inv_transform_batch(torch.from_numpy(coeff), size, bitdepth)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("size", [4, 8, 16, 32, 64, 128])
def test_residual_batch_int16_wrap(size):
    rng = np.random.default_rng(100 + size)
    qs = min(size, 16)
    B = 16
    coeff = rng.integers(-32767, 32768, (B, qs, qs)).astype(np.int32)
    qp = rng.integers(0, 52, B).astype(np.int32)
    qp[:4] = 51
    # the dequantized value before its int16 cast must leave the int16
    # range somewhere, or the wrap is not exercised
    lshift, rshift = qp // 6, int(np.log2(size)) - 1
    pre = coeff.astype(np.int64) * np.array([40, 45, 51, 57, 64, 72])[
        qp % 6][:, None, None]
    pre = np.where((lshift >= rshift)[:, None, None],
                   pre << np.maximum(lshift - rshift, 0)[:, None, None], pre)
    assert (np.abs(pre) > 32767).any()
    ref = np.asarray(JDP.residual_batch(coeff, qp, size, 8))
    got = PDP.residual_batch(torch.from_numpy(coeff), torch.from_numpy(qp),
                             size, 8)
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("bitdepth", [8, 10])
def test_dense_residual(bitdepth):
    """A 128x128 plane tiled by TBs of every size, each at its own qp."""
    rng = np.random.default_rng(7 + bitdepth)
    hp = wp = 128
    coefp = rng.integers(-3000, 3000, (hp, wp)).astype(np.int16)
    qp4 = np.zeros((hp // 4, wp // 4), np.int32)
    ls4 = np.zeros((hp // 4, wp // 4), np.int32)

    def tile(y, x, s):
        if s > 4 and rng.random() < 0.6:
            h = s // 2
            for dy in (0, h):
                for dx in (0, h):
                    tile(y + dy, x + dx, h)
            return
        qp4[y // 4:(y + s) // 4, x // 4:(x + s) // 4] = rng.integers(0, 52)
        ls4[y // 4:(y + s) // 4, x // 4:(x + s) // 4] = int(np.log2(s))

    tile(0, 0, 128)
    sizes = (4, 8, 16, 32, 64, 128)
    ref = np.asarray(JDP._dense_residual(coefp, qp4, ls4, bitdepth, sizes))
    got = PDP._dense_residual(torch.from_numpy(coefp), torch.from_numpy(qp4),
                              torch.from_numpy(ls4), bitdepth, sizes)
    assert np.array_equal(got.numpy(), ref)


def test_tables_to_device():
    """The port's parameters are the host tables and the constants the
    JAX modules build from them, unchanged."""
    from thor_tpu.ops import filters as JOF
    from thor_tpu.tables import GDEQUANT, TRANSFORM_TABLES
    from thor_tpu_torch import tables as PTB
    assert np.array_equal(PTB.LUMA_BANK, JDP._LUMA_BANK)
    assert np.array_equal(PTB.CHROMA_BANK, JDP._CHROMA_BANK)
    assert np.array_equal(PTB.LOWPASS_K, JDP._LOWPASS_K)
    assert np.array_equal(PTB.DIR_PROJ, JOF._DIR_PROJ)
    assert np.array_equal(PTB.DIV_TABLE, JOF._DIV_TABLE)
    tb = PTB.to_device("cpu")
    assert tb is PTB.to_device(torch.device("cpu"))
    for s, m in TRANSFORM_TABLES.items():
        assert np.array_equal(tb["transform"][s].numpy(), np.asarray(m))
    assert np.array_equal(tb["gdequant"].numpy(), GDEQUANT)
    assert np.array_equal(tb["luma_bank"].numpy(), JDP._LUMA_BANK)
    assert np.array_equal(
        tb["dir_proj"].numpy().reshape(64, 8, 15).transpose(1, 0, 2),
        JOF._DIR_PROJ)
