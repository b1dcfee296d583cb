"""Public surface of the native (C++) components.

The Golomb-Rice index-stream codec (GR_encoder parity, GR_encoder.{h,cpp})
and the segment delta transforms, compiled from
saena_tpu_torch/_native/gr_codec.cpp with g++ at first use (numpy versions
without a toolchain)."""
from saena_tpu_torch._native import (
    delta_decode,
    delta_encode,
    gr_compress,
    gr_decompress,
    gr_pick_k,
    have_native,
)

__all__ = [
    "delta_decode", "delta_encode", "gr_compress", "gr_decompress",
    "gr_pick_k", "have_native",
]
