"""Faults planted in the port's encoder, for the checks that `correct`
must fail (`control.py --fault`, on the card at the cell's size, and
the CPU tests).  Each is a list of (target, make) replacements for
`spans.patched`; every one writes a stream that decodes to the
encoder's own reconstruction, so only the numbers that see the
decisions can catch it.

- `all_skip`: every block of a P frame coded as a skip at the zero
  motion vector, so each frame repeats the last (a step that returns
  its state unchanged);
- `search_off`: the motion search returns zero vectors, so inter blocks
  code the whole displacement as residual or fall back to intra;
- `intra_only`: inter and skip are never chosen, so P frames are coded
  as I frames are;
- `clpf_off`: the CLPF search finds no strength, so the filter is never
  applied.
"""
from __future__ import annotations


def _all_skip(eval_skip):
    def planted(org, reff, mv_s, lam, H, W, s, bd):
        import torch
        cost, mv = eval_skip(org, reff, mv_s, lam, H, W, s, bd)
        return torch.zeros_like(cost), torch.zeros_like(mv)
    return planted


def _never(evaluate):
    def planted(*args, **kwargs):
        import torch
        cost, *rest = evaluate(*args, **kwargs)
        return (torch.full_like(cost, float("inf")), *rest)
    return planted


def _zero_mv(search):
    def planted(*args, **kwargs):
        import torch
        return torch.zeros_like(search(*args, **kwargs))
    return planted


def _no_clpf(clpf_test_frame):
    def planted(*args, **kwargs):
        return 0, 0
    return planted


TURBO = "thor_tpu_torch.enc.turbo"
FILTERS = "thor_tpu_torch.enc.filters_rdo"
FAULTS = {
    "all_skip": [(f"{TURBO}:eval_skip", _all_skip)],
    "search_off": [(f"{TURBO}:prepass_half", _zero_mv),
                   (f"{TURBO}:refine16", _zero_mv),
                   (f"{TURBO}:upsize_mv", _zero_mv)],
    "intra_only": [(f"{TURBO}:eval_inter", _never),
                   (f"{TURBO}:eval_skip", _never)],
    "clpf_off": [(f"{FILTERS}:clpf_test_frame", _no_clpf)],
}
