"""Decoder of the port: the host frame driver (decoder.py, copied from
thor_tpu) over the native block parser (native_parse.py), driving the
torch/CUDA frame decoder (device_frame.DeviceFrameDecoder)."""
