"""Encoder of the port: the turbo encoder (torch port of thor_tpu/enc's
turbo path; encoder.py drives it)."""
from .encoder import Encoder, encode_sequence  # noqa: F401
from .params import EncParams, parse_config_file  # noqa: F401
