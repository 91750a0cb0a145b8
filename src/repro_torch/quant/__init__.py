"""Wire codecs (fp16/int8/int4, per-row or per-block scale+zero-point)
for the embedding transmission paths: the sample exchange's float
payload, PS pulls and gradient pushes, and the Alg.-1 cost term that
prices them."""
from .codecs import (CODEC_NAMES, Codec, codec_name, dequantize_rows,
                     fake_quant, get_codec, meta_row_bytes, pack_int4,
                     quantize_rows, quantize_with_feedback,
                     resolve_link_codecs, row_wire_bytes, ste, unpack_int4,
                     wire_row_bytes)

__all__ = ["CODEC_NAMES", "Codec", "get_codec", "codec_name", "quantize_rows",
           "dequantize_rows", "fake_quant", "ste", "quantize_with_feedback",
           "pack_int4", "unpack_int4", "wire_row_bytes", "meta_row_bytes",
           "row_wire_bytes", "resolve_link_codecs"]
