"""The CUDA kernels against their plain torch versions, on a card.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports no JAX, so that it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX for the other tests).
"""
import numpy as np
import pytest
import torch

from thor_tpu_torch.ops import mc as MC

LUMA = ("rsel", "y0", "x0", "op", "vf", "hf", "fs")
CHROMA = ("rsel", "y0", "x0", "op", "vf", "hf")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card run: chip_smoke.py)")
    return torch.device("cuda")


def _cells(rng, n, R, Hp, Wp, cs, nfrac, luma, dev):
    """Cells inside the planes, past every border, and with indices out of
    range (clamped as JAX's gather clamps them)."""
    c = {"rsel": rng.integers(-1, R + 1, n),
         "y0": rng.integers(-8, Hp + 8, n), "x0": rng.integers(-8, Wp + 8, n),
         "op": rng.integers(0, 4, n), "vf": rng.integers(-1, nfrac + 1, n),
         "hf": rng.integers(-1, nfrac + 1, n)}
    if luma:
        c["fs"] = rng.integers(-1, 3, n)
    inner = rng.random(n) < 0.7
    c["y0"] = np.where(inner, rng.integers(2, Hp - cs - 3, n), c["y0"])
    c["x0"] = np.where(inner, rng.integers(2, Wp - cs - 3, n), c["x0"])
    keys = LUMA if luma else CHROMA
    return [torch.from_numpy(c[k].astype(np.int32)).to(dev) for k in keys]


@pytest.mark.cuda
@pytest.mark.parametrize("bitdepth", [8, 10])
def test_luma_kernel_equals_plain(cuda, bitdepth):
    rng = np.random.default_rng(50 + bitdepth)
    R, Hp, Wp, n = 2, 200, 264, 5000
    ref = torch.from_numpy(rng.integers(0, 1 << bitdepth, (R, Hp, Wp))
                           .astype(np.int16)).to(cuda)
    cells = _cells(rng, n, R, Hp, Wp, 4, 4, True, cuda)
    before = MC.LUMA_LAUNCHES
    got = MC.mc_cells_luma(ref, *cells, 4, bitdepth)
    torch.cuda.synchronize()
    assert MC.LUMA_LAUNCHES == before + 1
    assert torch.equal(got, MC.mc_cells_luma_plain(ref, *cells, 4, bitdepth))


@pytest.mark.cuda
@pytest.mark.parametrize("bitdepth", [8, 10])
def test_chroma_kernel_equals_plain(cuda, bitdepth):
    rng = np.random.default_rng(60 + bitdepth)
    R, Hp, Wp, n = 2, 120, 152, 5000
    u, v = (torch.from_numpy(rng.integers(0, 1 << bitdepth, (R, Hp, Wp))
                             .astype(np.int16)).to(cuda) for _ in range(2))
    cells = _cells(rng, n, R, Hp, Wp, 2, 8, False, cuda)
    before = MC.CHROMA_LAUNCHES
    pu, pv = MC.mc_cells_chroma_uv(u, v, *cells, 2, bitdepth)
    one = MC.mc_cells_chroma(v, *cells, 2, bitdepth)
    torch.cuda.synchronize()
    assert MC.CHROMA_LAUNCHES == before + 2
    assert torch.equal(pu, MC.mc_cells_chroma_plain(u, *cells, 2, bitdepth))
    assert torch.equal(pv, MC.mc_cells_chroma_plain(v, *cells, 2, bitdepth))
    assert torch.equal(one, pv)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    ref = torch.zeros((1, 32, 32), dtype=torch.int32, device=cuda)
    cell = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):        # the kernel reads int16 planes
        MC.mc_cells_luma(ref, *[cell] * 7, 4, 8)
    ref16 = ref.to(torch.int16)
    with pytest.raises(ValueError):        # metadata on the host
        MC.mc_cells_luma(ref16, *[cell.cpu()] * 7, 4, 8)
    with pytest.raises(ValueError):        # planes of two shapes
        MC.mc_cells_chroma_uv(ref16, ref16[:, :16], *[cell] * 6, 2, 8)
