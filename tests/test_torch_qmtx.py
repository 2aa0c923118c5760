"""thor_tpu_torch's weighted dequantization (qmtx) against thor_tpu's,
exactly: `residual_batch_w` with products past 2^31, the dense residual
with weight slots, and the host operands `build_qm_operands`."""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from thor_tpu import qmtx as JQ
from thor_tpu.dec import device_pixels as JDP
from thor_tpu.dec import native_parse as JNP
from thor_tpu_torch import qmtx as PQ
from thor_tpu_torch.dec import device_pixels as PDP
from thor_tpu_torch.dec import native_parse as PNP

torch.set_num_threads(1)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("bitdepth", [8, 10])
@pytest.mark.parametrize("size", [4, 8, 16, 32, 64])
def test_residual_batch_w(size, bitdepth):
    """Every qp 0..51; coefficient x weight x scale passes 2^31 (the
    product must run in int64) and the result wraps to int16."""
    rng = np.random.default_rng(size + bitdepth)
    qs = min(size, 16)
    n = 104
    coeff = rng.integers(-3000, 3000, (n, qs, qs)).astype(np.int32)
    iw = rng.integers(16, 951, (n, qs, qs)).astype(np.int32)
    qp = (np.arange(n) % 52).astype(np.int32)
    coeff[0], iw[0], qp[0] = 32767, 950, 51
    coeff[1], iw[1], qp[1] = -32768, 950, 5
    with jax.enable_x64():
        want = np.asarray(JDP.residual_batch_w(coeff, qp, iw, size,
                                               bitdepth))
    got = PDP.residual_batch_w(*_t(coeff, qp, iw), size, bitdepth)
    assert got.dtype == torch.int32 and got.shape == (n, size, size)
    assert np.array_equal(got.numpy(), want)
    # inverse weights reach 950 in the codec's tables: on these inputs
    # the product does not fit int32
    from thor_tpu_torch.tables import GDEQUANT
    prod = (coeff.astype(np.int64) * iw *
            np.asarray(GDEQUANT)[qp % 6][:, None, None])
    assert np.abs(prod).max() >= 2 ** 31


def test_dense_residual_weighted():
    """A 64x64 plane of TBs of every size, each with its qp and its weight
    slot; int16 coefficients as the parser's dense plane holds them."""
    rng = np.random.default_rng(11)
    hp = wp = 64
    coefp = rng.integers(-3000, 3000, (hp, wp)).astype(np.int16)
    qp4 = np.zeros((hp // 4, wp // 4), np.int32)
    ls4 = np.zeros((hp // 4, wp // 4), np.int32)
    ws4 = np.zeros((hp // 4, wp // 4), np.int32)

    def tile(y, x, s):
        if s > 4 and rng.random() < 0.6:
            for dy in (0, s // 2):
                for dx in (0, s // 2):
                    tile(y + dy, x + dx, s // 2)
            return
        sl = (slice(y // 4, (y + s) // 4), slice(x // 4, (x + s) // 4))
        qp4[sl] = rng.integers(0, 52)
        ls4[sl] = int(np.log2(s))
        ws4[sl] = rng.integers(0, PDP.QM_SLOTS)

    tile(0, 0, 64)
    sizes = (4, 8, 16, 32, 64)
    bank = {s: rng.integers(16, 256, (PDP.QM_SLOTS, min(s, 16), min(s, 16))
                            ).astype(np.int32) for s in sizes}
    with jax.enable_x64():
        want = np.asarray(JDP._dense_residual(coefp, qp4, ls4, 8, sizes,
                                              ws4, bank))
    got = PDP._dense_residual(*_t(coefp, qp4, ls4), 8, sizes, _t(ws4)[0],
                              {s: _t(b)[0] for s, b in bank.items()})
    assert np.array_equal(got.numpy(), want)


def test_qm_tables_equal():
    def leaves(m):
        return [x for q in m for plane in q for flavour in plane
                for x in flavour]

    for fn in ("get_iwmatrices", "get_wmatrices"):
        got, want = leaves(getattr(PQ, fn)()), leaves(getattr(JQ, fn)())
        assert len(got) == len(want) == 12 * 3 * 2 * 6
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("qmtx_offset", [0, -8, 12])
def test_build_qm_operands(qmtx_offset):
    """A 64x64 frame of four 32x32 blocks and sixteen 16x16 ones over
    them, intra and inter, at several qps: slots and banks equal."""
    assert PDP.QM_SLOTS == JDP.QM_SLOTS
    dec = SimpleNamespace(h=SimpleNamespace(qmtx_offset=qmtx_offset),
                          iwmatrix=JQ.get_iwmatrices())
    plan = SimpleNamespace(qp4={"y": np.zeros((16, 16), np.int32)})
    outs = []
    for DP, NP in ((JDP, JNP), (PDP, PNP)):
        r = np.random.default_rng(5)
        recs = []
        for size in (32, 16):
            for y in range(0, 64, size):
                for x in range(0, 64, size):
                    b = np.zeros(NP.BREC_W, np.int32)
                    b[NP.B_YPOS], b[NP.B_XPOS], b[NP.B_SIZE] = y, x, size
                    b[NP.B_MODE] = r.integers(0, 4)
                    b[NP.B_QPY] = r.choice([10, 22, 32, 44, 51])
                    recs.append(b)
        outs.append(DP.build_qm_operands(dec, plan, np.stack(recs)))
    (wy, wc, banks), (gy, gc, gbanks) = outs
    assert len(np.unique(wy)) > 2
    np.testing.assert_array_equal(gy, wy)
    np.testing.assert_array_equal(gc, wc)
    assert sorted(gbanks) == sorted(banks)
    for k in banks:
        assert sorted(gbanks[k]) == sorted(banks[k])
        for s in banks[k]:
            assert gbanks[k][s].dtype == banks[k][s].dtype
            np.testing.assert_array_equal(gbanks[k][s], banks[k][s])
