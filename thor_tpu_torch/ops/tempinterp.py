"""Temporal interpolation is not ported yet (ROADMAP.md, Queue 1,
"Temporal interpolation").  The host decoder imports
`interpolate_frames_auto` from this module's place for streams with
interp_ref > 0 (thor_tpu/dec/decoder.py:1263); the port's decode_stream
refuses those streams, and this entry point raises if it is reached."""


def interpolate_frames_auto(*args, **kwargs):
    raise NotImplementedError(
        "temporal interpolation (ops/tempinterp.py) is not ported to "
        "thor_tpu_torch yet: ROADMAP.md Queue 1, 'Temporal interpolation'")

