"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its plain
PyTorch version. Sources live in ``fp8_quantization_tpu_torch/csrc``;
``build`` compiles them at first use."""

from . import approx_matmul, attention, decode_attention, dequant_matmul, fused_matmul

# every kernel wrapper, whose ``launches`` attribute counts its launches
KERNELS = {
    "K1": fused_matmul.quantize_block,
    "K2": fused_matmul.fused_quant_matmul,
    "K3": approx_matmul.approx_matmul,
    "K4": dequant_matmul.dequant_matmul,
    "K5": dequant_matmul.int4_matmul,
    "K6": decode_attention.decode_attention,
    "K7": attention.fused_sdpa,
}
