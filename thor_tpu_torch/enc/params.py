"""Encoder parameters: registry with the exact defaults of the reference
flag system (enc/strings.c:287-356) + config-file parsing + validation
(enc/strings.c:470-555)."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class EncParams:
    num_frames: int = 600
    skip: int = 0
    width: int = 1920
    height: int = 1080
    qp: int = 32
    log2_sb_size: int = 7
    frame_rate: float = 60.0
    lambda_coeffI: float = 1.0
    lambda_coeffP: float = 1.0
    lambda_coeffB: float = 1.0
    lambda_coeffB0: float = 1.0
    lambda_coeffB1: float = 1.0
    lambda_coeffB2: float = 1.0
    lambda_coeffB3: float = 1.0
    early_skip_thr: float = 0.0
    enable_tb_split: int = 0
    enable_pb_split: int = 0
    max_num_ref: int = 1
    HQperiod: int = 1
    num_reorder_pics: int = 0
    dyadic_coding: int = 1
    interp_ref: int = 0
    dqpP: int = 0
    dqpB: int = 0
    dqpB0: int = 0
    dqpB1: int = 0
    dqpB2: int = 0
    dqpB3: int = 0
    mqpP: float = 1.0
    mqpB: float = 1.0
    mqpB0: float = 1.0
    mqpB1: float = 1.0
    mqpB2: float = 1.0
    mqpB3: float = 1.0
    dqpI: int = 0
    intra_period: int = 0
    intra_rdo: int = 0
    max_delta_qp: int = 0
    delta_qp_step: int = 1
    encoder_speed: int = 0
    sync: int = 0
    deblocking: int = 1
    cdef: int = 2
    clpf: int = 0
    snrcalc: int = 1
    use_block_contexts: int = 0
    enable_bipred: int = 0
    bitrate: int = 0
    max_qp: int = 51
    min_qp: int = 1
    max_qpI: int = 32
    min_qpI: int = 32
    qmtx: int = 0
    qmtx_offset: int = 0
    subsample: int = 420
    max_clpf_strength: int = 4
    cfl_intra: int = 1
    cfl_inter: int = 0
    bitdepth: int = 8
    frame_bitdepth: int = 8
    input_bitdepth: int = 8
    # thor_tpu extension: turbo throughput mode (batched device
    # decisions + exact emission, enc/turbo.py); not a reference flag
    turbo: int = 0
    # thor_tpu extension: bit-exact wavefront device encoder for the
    # supported (LDB-LC) path (enc/device_lc.py); not a reference flag
    device_enc: int = 0
    # set only via y4m probing (enc/strings.c:285,427-433)
    aspectnum: int = 1
    aspectden: int = 1
    file_headerlen: int = 0
    frame_headerlen: int = 0

    def validate(self):
        """check_parameters (enc/strings.c:470-555), minus file checks."""
        assert self.num_frames > 0
        assert self.width % 8 == 0 and self.height % 8 == 0
        assert 1 <= self.max_num_ref <= 4
        assert self.max_delta_qp < 8
        if self.num_reorder_pics > 0 and self.HQperiod > 1:
            assert self.HQperiod % (self.num_reorder_pics + 1) == 0
        if self.dyadic_coding:
            nrp1 = self.num_reorder_pics + 1
            if self.num_reorder_pics == 2:
                self.dyadic_coding = 0
            else:
                assert nrp1 & (nrp1 - 1) == 0
        if self.num_reorder_pics > 0:
            assert self.max_num_ref >= 2
        assert self.intra_period % (self.num_reorder_pics + 1) == 0
        if self.sync:
            assert self.encoder_speed >= 2
        if self.bitrate > 0:
            assert self.num_reorder_pics == 0
        assert 6 <= self.log2_sb_size <= 7
        if self.bitdepth > 8:
            self.frame_bitdepth = 16
        return self


# flag name -> (attr, type); mirrors add_param_to_list order
_FLAGS = {
    "-n": ("num_frames", int), "-skip": ("skip", int),
    "-width": ("width", int), "-height": ("height", int),
    "-qp": ("qp", int), "-log2_sb_size": ("log2_sb_size", int),
    "-turbo": ("turbo", int),
    "-device_enc": ("device_enc", int),
    "-f": ("frame_rate", float),
    "-lambda_coeffI": ("lambda_coeffI", float),
    "-lambda_coeffP": ("lambda_coeffP", float),
    "-lambda_coeffB": ("lambda_coeffB", float),
    "-lambda_coeffB0": ("lambda_coeffB0", float),
    "-lambda_coeffB1": ("lambda_coeffB1", float),
    "-lambda_coeffB2": ("lambda_coeffB2", float),
    "-lambda_coeffB3": ("lambda_coeffB3", float),
    "-early_skip_thr": ("early_skip_thr", float),
    "-enable_tb_split": ("enable_tb_split", int),
    "-enable_pb_split": ("enable_pb_split", int),
    "-max_num_ref": ("max_num_ref", int),
    "-HQperiod": ("HQperiod", int),
    "-num_reorder_pics": ("num_reorder_pics", int),
    "-dyadic_coding": ("dyadic_coding", int),
    "-interp_ref": ("interp_ref", int),
    "-dqpP": ("dqpP", int), "-dqpB": ("dqpB", int),
    "-dqpB0": ("dqpB0", int), "-dqpB1": ("dqpB1", int),
    "-dqpB2": ("dqpB2", int), "-dqpB3": ("dqpB3", int),
    "-mqpP": ("mqpP", float), "-mqpB": ("mqpB", float),
    "-mqpB0": ("mqpB0", float), "-mqpB1": ("mqpB1", float),
    "-mqpB2": ("mqpB2", float), "-mqpB3": ("mqpB3", float),
    "-dqpI": ("dqpI", int), "-intra_period": ("intra_period", int),
    "-intra_rdo": ("intra_rdo", int),
    "-max_delta_qp": ("max_delta_qp", int),
    "-delta_qp_step": ("delta_qp_step", int),
    "-encoder_speed": ("encoder_speed", int), "-sync": ("sync", int),
    "-deblocking": ("deblocking", int), "-cdef": ("cdef", int),
    "-clpf": ("clpf", int), "-snrcalc": ("snrcalc", int),
    "-use_block_contexts": ("use_block_contexts", int),
    "-enable_bipred": ("enable_bipred", int),
    "-bitrate": ("bitrate", int), "-max_qp": ("max_qp", int),
    "-min_qp": ("min_qp", int), "-max_qpI": ("max_qpI", int),
    "-min_qpI": ("min_qpI", int), "-qmtx": ("qmtx", int),
    "-qmtx_offset": ("qmtx_offset", int), "-subsample": ("subsample", int),
    "-max_clpf_strength": ("max_clpf_strength", int),
    "-enable_cfl_intra": ("cfl_intra", int),
    "-enable_cfl_inter": ("cfl_inter", int),
    "-bitdepth": ("bitdepth", int),
    "-frame_bitdepth": ("frame_bitdepth", int),
    "-input_bitdepth": ("input_bitdepth", int),
    "-ph": ("file_headerlen", int), "-fh": ("frame_headerlen", int),
}


def _tokenize_config(text: str):
    """Config file tokens; ';' starts a comment to end of line
    (enc/strings.c:64-122)."""
    toks = []
    for line in text.splitlines():
        for tok in line.split():
            if tok.startswith(";"):
                break
            toks.append(tok)
        else:
            continue
    return toks


def apply_args(params: EncParams, args):
    i = 0
    while i < len(args):
        a = args[i]
        if a == "-cf":
            sub = _tokenize_config(open(args[i + 1]).read())
            apply_args(params, sub)
            i += 2
            continue
        if a in _FLAGS:
            attr, typ = _FLAGS[a]
            setattr(params, attr, typ(args[i + 1]))
            i += 2
            continue
        raise ValueError(f"Unknown parameter: {a}")
    return params


def parse_config_file(path: str, **overrides) -> EncParams:
    p = EncParams()
    apply_args(p, ["-cf", path])
    for k, v in overrides.items():
        setattr(p, k, v)
    return p.validate()
