"""Typed configuration: a copy of ``fp8_quantization_tpu/config.py``.

The port keeps its own copy so it never imports the JAX package. Field names
and defaults are identical (tests compare ``dataclasses.asdict`` of both), so
the reference's experiment flag sets build the same config in either package.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class QMethod(enum.Enum):
    """Quantizer family."""

    symmetric_uniform = "symmetric_uniform"
    asymmetric_uniform = "asymmetric_uniform"
    fp_quantizer = "fp_quantizer"


class RangeMethod(enum.Enum):
    """Range estimator."""

    current_minmax = "current_minmax"
    allminmax = "allminmax"
    running_minmax = "running_minmax"
    MSE = "MSE"
    cross_entropy = "cross_entropy"


class OptMethod(enum.Enum):
    """Line-search optimizer."""

    grid = "grid"
    golden_section = "golden_section"


@dataclasses.dataclass(frozen=True)
class FP8Config:
    """FP8-specific quantizer options."""

    maxval: Optional[float] = None
    mantissa_bits: int = 4
    set_maxval: bool = False
    learn_maxval: bool = False
    learn_mantissa_bits: bool = False
    mse_include_mantissa_bits: bool = True
    allow_unsigned: bool = False


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    """Per-site range estimation options."""

    method: RangeMethod = RangeMethod.current_minmax
    percentile: Optional[float] = None
    momentum: float = 0.9
    num_candidates: int = 111
    opt_method: OptMethod = OptMethod.grid
    range_margin: float = 0.5


@dataclasses.dataclass(frozen=True)
class QuantizerConfig:
    """One tensor-site quantizer."""

    method: QMethod = QMethod.fp_quantizer
    n_bits: int = 8
    per_channel: bool = False
    scale_domain: str = "linear"
    fp8: FP8Config = FP8Config()


@dataclasses.dataclass(frozen=True)
class RunMethodConfig:
    """Forward-protocol switches."""

    approx_flag: bool = False
    quantize_after_mult_and_add: bool = False
    res_quantizer_flag: bool = False
    original_quantize_res: bool = False

    def __post_init__(self):
        if (self.approx_flag or self.quantize_after_mult_and_add) and not self.res_quantizer_flag:
            raise ValueError(
                "quantize_after_mult_and_add or approx_flag is set but "
                "res_quantizer_flag is not set"
            )


@dataclasses.dataclass(frozen=True)
class ApproxConfig:
    """Approximate-multiplier simulation knobs."""

    expo_width: int = 3
    mant_width: int = 4
    dnsmp_factor: int = 3
    with_comp: bool = False
    with_approx: bool = False
    with_s2nn2s_opt: bool = False
    sim_hw_add_ofuf: bool = False
    with_of_opt: bool = False
    with_uf_opt: bool = False
    golden_clip_of: bool = False
    quant_btw_mult_accu: bool = True
    debug_mode: bool = False
    self_check_mode: bool = False


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Model-wide quantization setup."""

    method: QMethod = QMethod.fp_quantizer
    act_method: Optional[QMethod] = None
    n_bits: int = 8
    n_bits_act: Optional[int] = None
    per_channel_weights: bool = False
    quantize_input: bool = False
    quant_setup: str = "all"  # all | FP_logits | fc4 | fc4_dw8 | LSQ | LSQ_paper
    weight_range: EstimatorConfig = EstimatorConfig(RangeMethod.current_minmax)
    act_range: EstimatorConfig = EstimatorConfig(RangeMethod.running_minmax)
    percentile: Optional[float] = None
    fp8: FP8Config = FP8Config()
    run_method: RunMethodConfig = RunMethodConfig()
    approx: ApproxConfig = ApproxConfig()

    def weight_quantizer(self, n_bits: Optional[int] = None) -> QuantizerConfig:
        return QuantizerConfig(
            method=self.method,
            n_bits=n_bits if n_bits is not None else self.n_bits,
            per_channel=self.per_channel_weights,
            fp8=self.fp8,
        )

    def act_quantizer(self, n_bits: Optional[int] = None) -> QuantizerConfig:
        return QuantizerConfig(
            method=self.act_method or self.method,
            n_bits=n_bits if n_bits is not None else (self.n_bits_act or self.n_bits),
            per_channel=False,
            fp8=self.fp8,
        )
