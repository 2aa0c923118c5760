"""Encoder of the port: thor_tpu's exact host-RDO encoder and its turbo
encoder (torch port of thor_tpu/enc; encoder.py drives both)."""
from .encoder import Encoder, encode_sequence  # noqa: F401
from .params import EncParams, parse_config_file  # noqa: F401
