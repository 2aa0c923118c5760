"""Intra wave scan cases shared by the CPU tests against thor_tpu
(test_torch_intra.py) and the card tests of the kernel
(test_torch_cuda.py): quadtree frames of intra block records, the
segment tables that DeviceFrameDecoder.run fills from them, and apron
planes with residual rows.  Imports no JAX."""
import numpy as np

from thor_tpu_torch.dec import device_frame as PDF
from thor_tpu_torch.dec import native_parse as NP
from thor_tpu_torch.spec import inter


def quadtree_recs(rng, H, W, sizes, sb=64, modes=(0, 10)):
    """Intra block records tiling an H x W frame in coding order: each
    sb x sb superblock split into quarters down to sizes[-1], then at
    random down to sizes[0]; intra modes drawn from [modes[0],
    modes[1])."""
    recs = []

    def split(y, x, s):
        if s > sizes[0] and (s > sizes[-1] or rng.random() < 0.6):
            h = s // 2
            for dy, dx in ((0, 0), (0, h), (h, 0), (h, h)):
                split(y + dy, x + dx, h)
            return
        r = np.zeros(NP.BREC_W, np.int32)
        r[NP.B_YPOS], r[NP.B_XPOS], r[NP.B_SIZE] = y, x, s
        r[NP.B_MODE] = PDF.MODE_INTRA
        r[NP.B_INTRA_MODE] = rng.integers(*modes)
        recs.append(r)

    for y in range(0, H, sb):
        for x in range(0, W, sb):
            split(y, x, sb)
    return np.stack(recs)


def wave_inputs(recs, H, W, sizes, sb, lanes=64, spare=3):
    """(segment count, segs, segcls) of recs, filled as
    DeviceFrameDecoder.run fills them, then one segment of a size class
    with no active lane and `spare` empty rows."""
    seg_list = PDF.build_wave_segments(recs, H, W, sizes, lanes)
    segs = np.zeros((len(seg_list) + 1 + spare, PDF.LANES, 7), np.int32)
    segcls = np.zeros(len(segs), np.int32)
    segcls[len(seg_list)] = 1
    for si, (cls, idx) in enumerate(seg_list):
        segcls[si] = cls
        for li, ri in enumerate(idx):
            y, x, s = (int(recs[ri, k]) for k in (NP.B_YPOS, NP.B_XPOS,
                                                  NP.B_SIZE))
            segs[si, li] = (1, y, x, int(np.log2(s)),
                            recs[ri, NP.B_INTRA_MODE],
                            inter.get_upright_available(y, x, s, s, W, H, sb),
                            inter.get_downleft_available(y, x, s, s, W, H,
                                                         sb))
    return len(seg_list), segs, segcls


def intra_planes(rng, H, W, bd, apron):
    """Apron planes ([H, W] and [H/2, W/2] plus `apron` rows and columns)
    of smooth content, chroma following luma in U and against it in V
    (so that CFL remaps with either sign), and residual rows [H, W] and
    [H/2, W/2] cut from wider planes as pixel_core cuts them; the left
    half's residuals are small, so that CFL also skips."""
    maxv = (1 << bd) - 1
    ph, fy, fx = rng.random(3) * 6

    def field(h, w, step):
        yy, xx = np.mgrid[0:h, 0:w] * step
        return maxv / 2 * (1 + np.sin(yy / (9 + fy) + ph) *
                           np.cos(xx / (13 + fx)))

    def clip(a):
        return np.clip(a + rng.integers(-6, 7, a.shape), 0,
                       maxv).astype(np.int32)

    fc = field(H // 2 + apron, W // 2 + apron, 2)
    planes = [clip(field(H + apron, W + apron, 1)), clip(fc * 0.6 + 30),
              clip(maxv - fc)]
    res = []
    for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2)):
        r = rng.integers(-maxv // 6, maxv // 6 + 1, (h + 8, w + 16))
        r[:, :w // 2] //= 24
        res.append(r.astype(np.int32))
    return planes, res
