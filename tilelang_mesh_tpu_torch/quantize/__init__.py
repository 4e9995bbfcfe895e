"""Host-side weight quantization (numpy), as the JAX package's
``quantize`` package exports it."""

from .quantization import (pack_int4, unpack_int4_ref,  # noqa: F401
                           quantize_int4_groups, dequantize_int4_ref,
                           quantize_int4_planar, dequantize_int4_planar_ref)

__all__ = ["pack_int4", "unpack_int4_ref", "quantize_int4_groups",
           "dequantize_int4_ref", "quantize_int4_planar",
           "dequantize_int4_planar_ref"]
