"""Decoder of the port: the host syntax walk of thor_tpu driving the
torch/CUDA frame decoder (device_frame.DeviceFrameDecoder)."""
