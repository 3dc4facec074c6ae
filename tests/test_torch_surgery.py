"""Spec surgery and the demo of the port against the JAX package's, on the
CPU: ``plan_sequential``, ``QuantizedSequential`` (a 1-D conv, a stride-2
transposed conv with torch's explicit padding, an average pool with its own
or a tied site, a linear+BN layer and a final linear), ``QuantizedDemoModel``
and ``validate-quantized-demo``.

Both sides build from the same JAX variables (``models.bridge``), calibrate
on the same batch and evaluate the same one. Tolerances: the site state
after ESTIMATE and the FIXED outputs bit for bit (integer inputs and
kernels; every sum of grid values is exact in f32 in any order, BN's
``var + eps`` is a power of four); the demo CLI's metrics and result file
equal to the JAX CLI's on the same seed (its loss within ``rtol=1e-6``:
the frameworks' ``log_softmax`` may differ in the last bit).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu import cli as jcli
from fp8_quantization_tpu import config as jc
from fp8_quantization_tpu.models import demo as jdemo
from fp8_quantization_tpu.models import surgery as js
from fp8_quantization_tpu.quant import sites as jsites
from fp8_quantization_tpu_torch import cli as tcli
from fp8_quantization_tpu_torch import config as tc
from fp8_quantization_tpu_torch.models import demo as tdemo
from fp8_quantization_tpu_torch.models import surgery as ts
from fp8_quantization_tpu_torch.models.bridge import from_jax_variables
from fp8_quantization_tpu_torch.models.porting import conv_transpose_padding_from_torch
from fp8_quantization_tpu_torch.quant import sites as tsites

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

LENGTH, C_IN = 8, 3


def _qc(mod, quantize_input=True):
    """``scripts/image_net.sh``'s FP8 E3M4 flags; without ``quantize_input``
    the average pool's site is tied to the layer before it."""
    return mod.QuantConfig(
        method=mod.QMethod.fp_quantizer, per_channel_weights=True,
        quantize_input=quantize_input,
        weight_range=mod.EstimatorConfig(mod.RangeMethod.current_minmax),
        act_range=mod.EstimatorConfig(mod.RangeMethod.allminmax),
        fp8=mod.FP8Config(set_maxval=True, mse_include_mantissa_bits=False),
        run_method=mod.RunMethodConfig(res_quantizer_flag=True, original_quantize_res=True))


def _specs(mod):
    """Each new kind in one plan: Conv1d(+act), a stride-2 ConvTranspose1d
    with torch's padding 1 and output padding 1 (+act), an average pool,
    Flatten, Linear+BN(+act) and a final Linear."""
    return (mod.Conv(4, (3,), (1,)), mod.Act("relu"),
            mod.ConvTranspose(4, (3,), (2,), conv_transpose_padding_from_torch((3,), 2, 1, 1)),
            mod.Act("relu"), mod.AvgPool((2,)), mod.Flatten(),
            mod.Linear(6), mod.BatchNorm(), mod.Act("relu"), mod.Linear(5))


def _plan_view(plan):
    return [(kind, type(s).__name__, dataclasses.astuple(s), act,
             None if bn is None else dataclasses.astuple(bn)) for kind, s, act, bn in plan]


def test_plan_matches_jax():
    specs = _specs(ts) + (ts.Conv(4, (3, 3), (2, 2), groups=2), ts.BatchNorm(), ts.Act("relu6"),
                          ts.LayerNorm(), ts.MaxPool((2, 2)), ts.Act("gelu"))
    jspecs = _specs(js) + (js.Conv(4, (3, 3), (2, 2), groups=2), js.BatchNorm(),
                           js.Act("relu6"), js.LayerNorm(), js.MaxPool((2, 2)), js.Act("gelu"))
    plan = ts.plan_sequential(specs)
    assert _plan_view(plan) == _plan_view(js.plan_sequential(jspecs))
    assert [p[0] for p in plan] == ["conv", "convtranspose", "plain", "plain", "bnlinear",
                                    "linear", "bnconv", "layernorm", "plain", "plain"]
    with pytest.raises(TypeError):
        ts.plan_sequential((ts.ConvTranspose(4), ts.BatchNorm()))


def _tree(t):
    return jax.tree.map(np.asarray, dict(t))


def _integer_params(variables, rng):
    """Small-integer kernels and biases, BN's ``var + eps`` a power of four."""
    out = {}
    for name, p in variables["params"].items():
        p = dict(p)
        p["kernel"] = rng.integers(-2, 3, size=p["kernel"].shape).astype(np.float32)
        if "bias" in p:
            p["bias"] = rng.integers(-2, 3, size=p["bias"].shape).astype(np.float32)
        out[name] = p
    stats = {name: {"mean": rng.integers(-2, 3, size=s["mean"].shape).astype(np.float32),
                    "var": (np.float32(4.0) ** rng.integers(-1, 2, size=s["var"].shape)
                            .astype(np.float32) - np.float32(1e-5)).astype(np.float32)}
             for name, s in variables.get("batch_stats", {}).items()}
    return {**variables, "params": out, "batch_stats": stats}


def _held(jm, jv, tm, calib, x, phases):
    """ESTIMATE on ``calib`` on both sides (equal site state), then each of
    ``phases`` on ``x`` bit for bit; returns the FIXED output."""
    _, ups = jm.apply(jv, jnp.asarray(calib), jsites.ESTIMATE, mutable=["quant", "quant_est"])
    jv = {**jv, **_tree(ups)}
    with torch.no_grad():
        tm(torch.from_numpy(calib), tsites.ESTIMATE)
    got = tm.state_dict()
    want = from_jax_variables({k: jv[k] for k in ("quant", "quant_est")})
    assert set(want) == {k for k in got if "quantizer" in k}
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value.numpy(), err_msg=key)
    for phase in phases:
        ref = np.asarray(jsites.decoded(jm.apply(jv, jnp.asarray(x), getattr(jsites, phase))))
        with torch.no_grad():
            out = tm(torch.from_numpy(x), getattr(tsites, phase)).float().numpy()
        np.testing.assert_array_equal(out, ref, err_msg=phase)
    return out


@pytest.mark.parametrize("quantize_input", [True, False], ids=["untied_pool", "tied_pool"])
def test_sequential_matches_jax(quantize_input, rng):
    """``QuantizedSequential`` built from the same variables: the state_dict
    names are the flax auto-names (the pool's site ``layers_1_activation_
    quantizer`` when tied to the transposed conv, ``layers_2_...`` when
    not), then ESTIMATE and FIXED bit for bit."""
    calib, x = (rng.integers(-3, 4, size=(2, LENGTH, C_IN)).astype(np.float32)
                for _ in range(2))
    jm = js.QuantizedSequential(qc=_qc(jc, quantize_input), specs=_specs(js))
    tm = ts.QuantizedSequential(_qc(tc, quantize_input), _specs(ts), (LENGTH, C_IN))
    jv = _integer_params(_tree(jm.init(jax.random.key(0), jnp.asarray(calib), jsites.ESTIMATE)),
                         rng)
    tm.load_state_dict(from_jax_variables(jv), strict=True)
    pool_site = "layers_1" if not quantize_input else "layers_2"
    assert hasattr(tm, f"{pool_site}_activation_quantizer")
    out = _held(jm, jv, tm, calib, x, ("FIXED",))
    assert out.shape == (2, 5) == (2, *tm.output_shape) and np.abs(out).max() > 0


def test_demo_matches_jax(rng):
    """``QuantizedDemoModel``: one ``QuantDense`` named ``fc``; ESTIMATE,
    FIXED and FAST bit for bit."""
    calib, x = (rng.integers(-3, 4, size=(4, 10)).astype(np.float32) for _ in range(2))
    jm = jdemo.QuantizedDemoModel(qc=_qc(jc))
    tm = tdemo.QuantizedDemoModel(_qc(tc))
    jv = _integer_params(_tree(jm.init(jax.random.key(0), jnp.asarray(calib), jsites.ESTIMATE)),
                         rng)
    tm.load_state_dict(from_jax_variables(jv), strict=True)
    assert {k.split(".")[0] for k in tm.state_dict()} == {"fc"}
    _held(jm, jv, tm, calib, x, ("FIXED", "FAST"))


def _result(path):
    with open(path) as f:
        return f.read().splitlines()


def test_demo_cli_matches_jax(tmp_path):
    """``validate-quantized-demo`` on the same seed and flags (the published
    FP8 flags at batch 8). The JAX CLI draws its weights from the seed's
    key; the port's CLI starts from the same variables (the JAX CLI's init,
    a zeros forward of one example included), saved as a port checkpoint
    and passed as ``--model-dir``. Equal top-1 / top-5 and result file, the
    loss within ``rtol=1e-6``, no kernel launch on the CPU."""
    from fp8_quantization_tpu_torch.ops.cuda import KERNELS
    from fp8_quantization_tpu_torch.utils.checkpoint import save_checkpoint

    flags = ["validate-quantized-demo", "--architecture", "demo_quantized", "--seed", "3",
             "--batch-size", "8", "--qmethod", "fp_quantizer", "--per-channel",
             "--weight-quant-method", "current_minmax", "--act-quant-method", "allminmax",
             "--quantize-input", "--res-quantizer-flag", "--original-quantize-res",
             "--fp8-set-maxval", "--no-fp8-mse-include-mantissa-bits"]
    jargs = jcli.build_parser().parse_args(flags)
    jm, example = jcli.build_model("demo_quantized", jcli.config_from_args(jargs))
    init = jm.init(jax.random.key(3), example, jsites.ESTIMATE)
    tm = tdemo.QuantizedDemoModel(tcli.config_from_args(tcli.build_parser().parse_args(flags)))
    tm.load_state_dict(from_jax_variables(_tree(init)), strict=True)
    save_checkpoint(str(tmp_path / "init"), tm)

    want = jcli.main(flags + ["--approx-output-dir", str(tmp_path / "jax")])
    before = {k: fn.launches for k, fn in KERNELS.items()}
    out = tcli.main(flags + ["--no-cuda", "--approx-output-dir", str(tmp_path / "port"),
                             "--model-dir", str(tmp_path / "init")])
    assert {k: fn.launches for k, fn in KERNELS.items()} == before
    got = out["metrics"]
    assert {k: got[k] for k in ("top_1_accuracy", "top_5_accuracy")} == {
        k: want[k] for k in ("top_1_accuracy", "top_5_accuracy")}
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
    jfile, = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path / "jax") for f in fs]
    tlines, jlines = _result(out["result_file"]), _result(jfile)
    assert tlines[:2] == jlines[:2] and out["result_file"].startswith(
        str(tmp_path / "port" / "demo_quantized" / "E3M4D3"))
    assert out["images"] == 8 * (1 + 4)
