"""Exact bit count of the coefficient syntax, batched (torch port of
thor_tpu/ops/coeff_cost.py; reference enc/write_bits.c:145-242).

`coeff_bits_batch` returns, for a batch of quantized blocks, the number
of bits `enc.writer.write_coeff` would emit.  The reference's scan is a
two-mode walk (level mode / run mode with an adaptive VLC table); per
zigzag position it is an automaton over 8 states:

  state s in [0,8): mode = s&1 (0=level mode, 1=run mode),
                    va   = (s>>1)&1 (adaptive VLC table),
                    fb   = (s>>2)&1 (the current zero-run began with a
                           level-mode zero, which consumed one zero symbol)

The realized chain is resolved by a log-depth (Hillis-Steele) scan over
the per-position transition maps, with the bit counts accumulated per
entry state: 8 steps for 256 positions.  All arithmetic is integer, so
the scan order does not change the result.
"""
from __future__ import annotations

import torch

MAX_QUANT_SIZE = 16


def _log2i(v):
    """31 - clz(int32 v), as lax.clz gives it: floor(log2(v)) for v >= 1,
    -1 for 0 and 31 for a negative v (frexp of the float64 value is
    exact)."""
    v = v.to(torch.int32)
    _, e = torch.frexp(v.to(torch.float64))
    lg = e.to(torch.int32) - 1
    return torch.where(v > 0, lg, torch.where(v == 0, -1, 31))


def len_vlc01(va, cn):
    """Length of put_vlc(va, cn) for tables 0/1 (va in {0,1})."""
    l0 = torch.where(cn < 5, 1 + cn,
                     6 + 2 * _log2i(torch.clamp(cn - 4, min=1)))
    l1 = torch.where(cn < 10, 2 + (cn >> 1),
                     5 + 2 * _log2i(torch.clamp(cn - 8, min=1)))
    return torch.where(va == 0, l0, l1)


def len_vlc6(cn):
    """Length of put_vlc(6, cn)."""
    cn1 = cn + 1  # the table-6 remap (bitstream.py:106-108)
    return torch.where(cn == 0, 2,
                       torch.where(cn1 < 20, 3 + (cn1 >> 2),
                                   4 + 2 * _log2i(torch.clamp(cn1 - 16,
                                                              min=1))))


def len_vlc10(cn):
    """Length of put_vlc(10, cn)."""
    return 1 + 2 * _log2i(cn + 1)


def len_vlc0_signed(level, sign_neg):
    """Length of the level suffix for run-mode levels > 1:
    put_vlc(0, (level-2)*2 + sign)."""
    cn = (level - 2) * 2 + sign_neg
    return len_vlc01(torch.zeros_like(cn), cn)


def _scan_maps8(nxt, bits):
    """Inclusive scan along dim 1 of 8-state maps (next state, bits
    emitted) per entry state: out[p] = t[p] o ... o t[0]."""
    n = nxt.shape[1]
    d = 1
    while d < n:
        an, ab = nxt[:, :-d], bits[:, :-d]
        bn, bb = nxt[:, d:], bits[:, d:]
        rn = torch.gather(bn, 2, an)
        rb = ab + torch.gather(bb, 2, an)
        nxt = torch.cat([nxt[:, :d], rn], dim=1)
        bits = torch.cat([bits[:, :d], rb], dim=1)
        d *= 2
    return nxt, bits


def coeff_bits_batch(sc, size: int, chroma: int, intra: int):
    """Exact write_coeff bit count for a batch of blocks.

    sc: [N, n2] SIGNED quantized levels in zigzag scan order
    (n2 = qsize*qsize, qsize = min(16, size)).  Returns bits [N] int32.
    Only meaningful for blocks with cbp != 0 (all-zero rows return the
    epilogue-only count; callers mask by cbp)."""
    qsize = min(MAX_QUANT_SIZE, size)
    n2 = qsize * qsize
    assert sc.shape[-1] == n2
    N = sc.shape[0]
    dev = sc.device
    i32 = torch.int32
    vlc_adaptive0 = 1 if (intra and not chroma) else 0
    eob_pos = 0 if chroma else 2
    use_vlc10 = bool(chroma and size <= 8)

    lev = sc.abs().to(i32)
    sgn = (sc < 0).to(i32)
    idx = torch.arange(n2, dtype=i32, device=dev)
    nz = lev > 0
    last_pos = torch.where(nz, idx, -1).max(dim=1).values          # [N]

    # zeros-before: distance to the previous nonzero minus one
    prev_nz = torch.cummax(torch.where(nz, idx, -1), dim=1).values
    prev_nz = torch.cat([torch.full((N, 1), -1, dtype=i32, device=dev),
                         prev_nz[:, :-1]], dim=1)
    zbefore = idx[None, :] - prev_nz - 1

    def run_len(code):
        return len_vlc10(code) if use_vlc10 else len_vlc6(code)

    states = torch.arange(8, dtype=i32, device=dev)
    mode = states & 1
    va = (states >> 1) & 1
    fb = (states >> 2) & 1

    levB = lev[:, :, None]
    sgnB = sgn[:, :, None]
    zB = zbefore[:, :, None]
    is_nz = levB > 0

    # level mode emission/transition (where mode==0)
    l_bits = len_vlc01(va[None, None, :], levB) + is_nz.to(i32)
    va_next_l = ((levB > 3).to(i32) if not chroma
                 else va[None, None, :].expand(l_bits.shape))
    l_next = torch.where(is_nz, va_next_l << 1,
                         (va_next_l << 1) | 1 | (1 << 2))

    # run mode: zeros are free; nonzeros emit run+level codes
    run = zB - fb[None, None, :]
    interval = 5
    cn = torch.where(levB == 1, (run * interval) // (interval - 1),
                     run * interval + interval - 1)
    r_bits = run_len(cn + (cn >= eob_pos).to(i32)) + \
        torch.where(levB > 1, len_vlc0_signed(levB, sgnB), 1)
    r_bits = torch.where(is_nz, r_bits, 0)
    r_next = torch.where(
        levB > 1, va[None, None, :] << 1,
        torch.where(is_nz, (va[None, None, :] << 1) | 1,
                    states[None, None, :]))

    t_next = torch.where((mode == 0)[None, None, :], l_next, r_next)
    t_bits = torch.where((mode == 0)[None, None, :], l_bits, r_bits)
    # positions past last_pos: identity, no bits
    act = (idx[None, :] <= last_pos[:, None])[:, :, None]
    t_next = torch.where(act, t_next, states[None, None, :]).to(torch.int64)
    t_bits = torch.where(act, t_bits, 0).to(i32)

    cn_, cb_ = _scan_maps8(t_next, t_bits)
    final_next, final_bits = cn_[:, -1, :], cb_[:, -1, :]

    # entry state: level mode, va = vlc_adaptive0, fb irrelevant
    entry = vlc_adaptive0 << 1
    fstate = final_next[:, entry].to(i32)
    bits = final_bits[:, entry]

    # ---- epilogue (write_bits.c:234-241) ----
    pos_end = last_pos + 1
    in_level = (fstate & 1) == 0
    fva = (fstate >> 1) & 1
    extra = torch.where((pos_end < n2) & in_level,
                        len_vlc01(fva, torch.zeros_like(fva)), 0)
    pos_end = pos_end + ((pos_end < n2) & in_level).to(i32)
    eobl = run_len(torch.full((N,), eob_pos, dtype=i32, device=dev))
    extra = extra + torch.where(pos_end < n2, eobl, 0)
    bits = bits + extra

    # ---- chroma prologue (write_bits.c:161-169) ----
    if chroma:
        special = (last_pos == 0) & (lev[:, 0] == 1)
        bits = torch.where(special, 2, bits + 1)
    return bits.to(i32)
