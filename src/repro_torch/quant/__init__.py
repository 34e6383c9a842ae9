"""Quantization substrate of the port: sym/asym x tensor/channel/group,
INT8/INT4, nibble packing, weight-only serving."""
from repro_torch.quant.qtypes import (A8_ASYM_TENSOR, A8_SYM_TENSOR, QuantConfig,
                                      QuantizedTensor, W4_SYM_GROUP, W8_SYM_CHANNEL)
from repro_torch.quant.quantize import (dequantize, pack_int4, quantize,
                                        quantize_kv_int4, quantize_kv_int8,
                                        quantize_values, unpack_int4)
from repro_torch.quant.qlinear import dequant_param, qdot, quantize_params, weight_cfg

__all__ = [
    "QuantConfig", "QuantizedTensor", "W8_SYM_CHANNEL", "W4_SYM_GROUP",
    "A8_ASYM_TENSOR", "A8_SYM_TENSOR", "dequantize", "pack_int4", "quantize",
    "quantize_kv_int4", "quantize_kv_int8", "quantize_values", "unpack_int4",
    "dequant_param", "qdot", "quantize_params", "weight_cfg",
]
