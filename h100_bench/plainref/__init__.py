"""The benchmark's plain reference: a Thor decoder in exact integer numpy
and pure Python (`decoder.decode_stream`), a frozen copy of the JAX
package's spec decoder and its host tier (bit reader, tables, frame
buffers, spec/) without any device, native-parser or environment path.
It imports numpy and the files beside it only."""
