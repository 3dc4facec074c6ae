"""The port's interceptor (``models/flax_surgery.py``) against the JAX
package's, on the CPU: one case for each case of
``tests/test_flax_surgery.py``, and a foreign two-layer MLP held whole
against JAX's ``ForeignMLP``.

Each side wraps its own foreign model (flax ``nn.Dense`` / ``nn.Conv`` /
``nn.LayerNorm`` there, ``torch.nn.Linear`` / ``Conv2d`` / ``LayerNorm``
here), both get the same parameters (``models.bridge.
from_flax_surgery_variables`` carries the JAX variables across, transposing
the kernels) and calibrate on the same numpy batch in ``ESTIMATE``; the site
state must then be equal, and so must the outputs. Tolerances: bit for bit
where the JAX test is, and the approximate multiplier (the port's plain K3
version here, JAX's Pallas kernel in interpret mode) at ``rtol = atol =
1e-6``, as ``tests/test_approx_pallas.py``. The operands are multiples of
1/8 and 1/16 whose quantized products sum exactly in f32 in any order, so
XLA's and PyTorch's sums agree. JAX runs op by op (compiled, XLA fuses a
multiply and an add into one rounding) and creates the site state in its
first ``ESTIMATE`` apply.

Departures the tests pin: torch has no asymmetric padding, so the conv case
takes an odd input (9 x 9, stride 2), where flax's "SAME" pads (1, 1) as
torch's ``padding=1`` does (``tests/test_flax_surgery.py`` takes 8 x 8,
where "SAME" pads (0, 1)); the FP32 phase is held to the foreign PyTorch
model (``F.linear``, the fused ``F.layer_norm``), not to XLA's ops; a torch
LayerNorm declares no ``use_fast_variance``, so the whole-MLP case reads the
variance two-pass while JAX's ``ForeignMLP`` takes flax's fast variance
(equal here: the LayerNorm's inputs are small multiples of a power of two,
whose moments are exact both ways). XLA's CPU ``rsqrt`` is not correctly
rounded; at these seeds it agrees with PyTorch's on every row.
"""

import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu import config as jc
from fp8_quantization_tpu.models.flax_surgery import quantize_flax_model as j_quantize
from fp8_quantization_tpu.quant import sites as jsites
from fp8_quantization_tpu_torch import config as tc
from fp8_quantization_tpu_torch.models import QuantizedFlaxModel, quantize_flax_model
from fp8_quantization_tpu_torch.models.bridge import from_flax_surgery_variables
from fp8_quantization_tpu_torch.ops import layers as tlayers
from fp8_quantization_tpu_torch.quant import sites as tsites
from tests.test_flax_surgery import ForeignMLP

torch.set_num_threads(1)  # the suite's test workers share the machine's cores


def _qc(mod, **kw):
    """``tests/test_flax_surgery.py``'s configuration in either package."""
    base = dict(
        method=mod.QMethod.fp_quantizer,
        per_channel_weights=True,
        quantize_input=True,
        weight_range=mod.EstimatorConfig(mod.RangeMethod.current_minmax),
        act_range=mod.EstimatorConfig(mod.RangeMethod.allminmax),
        fp8=mod.FP8Config(set_maxval=True, mse_include_mantissa_bits=False),
        run_method=mod.RunMethodConfig(res_quantizer_flag=True, original_quantize_res=True),
    )
    base.update({k: v(mod) if callable(v) else v for k, v in kw.items()})
    return mod.QuantConfig(**base)


def _approx(mod):
    return mod.ApproxConfig(expo_width=3, mant_width=4, with_approx=True, with_comp=True)


def _approx_run(mod):
    return mod.RunMethodConfig(res_quantizer_flag=True, approx_flag=True)


class TorchMLP(torch.nn.Module):
    """The PyTorch twin of JAX's ``ForeignMLP``; it knows nothing about
    quantization (flax's LayerNorm epsilon)."""

    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(8, 16)
        self.ln = torch.nn.LayerNorm(16, eps=1e-6)
        self.head = torch.nn.Linear(16, 4)

    def forward(self, x):
        return self.head(self.ln(torch.relu(self.fc1(x))))


def _grid(rng, shape, scale=8, top=40):
    """Multiples of ``1/scale`` in ``[-top/scale, top/scale]``."""
    return (rng.integers(-top, top + 1, size=shape) / scale).astype(np.float32)


def _mlp_params(rng):
    return {"model": {
        "fc1": {"kernel": _grid(rng, (8, 16), 16), "bias": _grid(rng, (16,), 16)},
        "ln": {"scale": 1.0 + _grid(rng, (16,), 64, 16), "bias": _grid(rng, (16,), 16, 8)},
        "head": {"kernel": _grid(rng, (16, 4), 16), "bias": _grid(rng, (4,), 16)}}}


def _tree(t):
    return jax.tree.map(np.asarray, dict(t))


def _nchw(x):
    """A channels-last numpy batch as torch's NCHW."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _pair(j_model, t_model, qc_kw, params, x, to_torch=torch.from_numpy):
    """Both wrappers, JAX's calibrated on ``x`` from ``params`` (site state
    created by that first ESTIMATE apply), the port's carrying the same
    parameters and calibrated on the same batch (``to_torch(x)``); the site
    state must be equal entry for entry. Returns (JAX wrapper, its
    variables, port wrapper)."""
    jm = j_quantize(j_model, _qc(jc, **qc_kw))
    variables = {"params": params}
    _, ups = jm.apply(variables, jnp.asarray(x), qp=jsites.ESTIMATE,
                      mutable=["quant", "quant_est"])
    variables = {**variables, **_tree(ups)}
    tm = quantize_flax_model(t_model, _qc(tc, **qc_kw))
    missing, unexpected = tm.load_state_dict(from_flax_surgery_variables({"params": params}),
                                             strict=False)
    assert not unexpected and missing and all("quantizer" in k for k in missing)
    with torch.no_grad():
        tm(to_torch(x), qp=tsites.ESTIMATE)
    want = from_flax_surgery_variables({k: variables[k] for k in ("quant", "quant_est")})
    got = tm.state_dict()
    assert set(want) == set(missing)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value.numpy(), err_msg=key)
    return jm, variables, tm


def _run(jm, jv, tm, x, qp_name, to_torch=torch.from_numpy):
    """(port output, JAX output) under the phase ``qp_name``; an NCHW port
    output is taken back to channels-last."""
    want = np.asarray(jm.apply(jv, jnp.asarray(x), qp=getattr(jsites, qp_name)))
    with torch.no_grad():
        got = tm(to_torch(x), qp=getattr(tsites, qp_name))
    if to_torch is _nchw:
        got = got.permute(0, 2, 3, 1)
    return got.numpy(), want


def _layer_state(tm, prefix="model."):
    """One intercepted layer's site state and cache, without its parameters
    (as a port layer loads them)."""
    state = {k[len(prefix):]: v for k, v in tm.state_dict().items() if k.startswith(prefix)}
    return {k: v for k, v in state.items() if "quantizer" in k or k.startswith("w_")}


def test_quant_collections_appear_under_module_paths(rng):
    """The site state sits under each layer's name, with the port layers'
    sub-names, and equals JAX's ``quant``/``quant_est`` collections there;
    the foreign model's own parameter names are kept."""
    x = _grid(rng, (4, 8))
    _, jv, tm = _pair(ForeignMLP(), TorchMLP(), {}, _mlp_params(rng), x)
    assert set(jv["quant"]["model"]) == {"fc1", "ln", "head"}
    sd = tm.state_dict()
    for layer in ("fc1", "head"):
        for site in ("activation_quantizer", "weight_quantizer", "res_quantizer"):
            assert f"model.{layer}.{site}.maxval" in sd
        assert f"model.{layer}.weight" in sd and f"model.{layer}.bias" in sd
    assert "model.ln.res_quantizer.maxval" not in sd
    # per-channel weight quant: fc1's (16, 8) weight -> 16 channel maxvals
    assert sd["model.fc1.weight_quantizer.maxval"].shape == (16,)


def test_fp32_phase_matches_plain_model(rng):
    """With quantization off the intercepted model equals the foreign
    PyTorch model bit for bit (each layer runs its own op), and the given
    module keeps its own layers and forward."""
    foreign = TorchMLP()
    before = dict(foreign.named_modules())
    tm = quantize_flax_model(foreign, _qc(tc))
    x = torch.from_numpy(_grid(rng, (4, 8)))
    with torch.no_grad():
        tm(x, qp=tsites.ESTIMATE)
        out_fp32 = tm(x, qp=tsites.FP32)
        out_plain = foreign(x)
        # an intercepted layer outside a wrapper call is the foreign layer
        assert torch.equal(tm.model.fc1(x), foreign.fc1(x))
    assert torch.equal(out_fp32, out_plain)
    assert dict(foreign.named_modules()) == before and "forward" not in vars(foreign.fc1)
    assert not any("quantizer" in k for k in foreign.state_dict())
    # the intercepted layers hold the foreign layer's own parameters
    assert tm.model.fc1.weight is foreign.fc1.weight


@pytest.mark.parametrize("quantize_input", [True, False])
def test_dense_parity_vs_quantdense(rng, quantize_input):
    """One intercepted ``nn.Linear`` equals JAX's intercepted ``nn.Dense``
    and the port's ``QuantDense`` holding the same weights and the layer's
    site state, in both quant positions, bit for bit."""
    kw = dict(quantize_input=quantize_input,
              run_method=lambda m: m.RunMethodConfig(res_quantizer_flag=quantize_input,
                                                     original_quantize_res=quantize_input))
    x = _grid(rng, (4, 8))
    params = {"model": {"kernel": _grid(rng, (8, 16), 16), "bias": _grid(rng, (16,), 16)}}
    jm, jv, tm = _pair(fnn.Dense(16), torch.nn.Linear(8, 16), kw, params, x)
    got, want = _run(jm, jv, tm, x, "FIXED")
    np.testing.assert_array_equal(got, want)

    ours = tlayers.QuantDense(_qc(tc, **kw), 8, 16)
    ours.load_state_dict({"kernel": torch.from_numpy(params["model"]["kernel"]),
                          "bias": torch.from_numpy(params["model"]["bias"]),
                          **_layer_state(tm, "model.")}, strict=True)
    with torch.no_grad():
        np.testing.assert_array_equal(ours(torch.from_numpy(x), tsites.FIXED).numpy(), got)


def test_conv_parity_vs_quantconv(rng):
    """One intercepted ``nn.Conv2d`` (stride 2, torch's padding 1 on a 9 x 9
    input: flax's "SAME" there) equals JAX's intercepted ``nn.Conv`` and the
    port's ``QuantConv`` bit for bit; NCHW outside, channels-last inside."""
    x = _grid(rng, (2, 9, 9, 3), 8, 16)
    params = {"model": {"kernel": _grid(rng, (3, 3, 3, 8), 16, 16),
                        "bias": _grid(rng, (8,), 16)}}
    jm, jv, tm = _pair(fnn.Conv(8, kernel_size=(3, 3), strides=(2, 2), padding="SAME"),
                       torch.nn.Conv2d(3, 8, 3, stride=2, padding=1), {}, params, x, _nchw)
    got, want = _run(jm, jv, tm, x, "FIXED", _nchw)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 5, 5, 8)

    ours = tlayers.QuantConv(_qc(tc), 3, 8, kernel_size=(3, 3), strides=(2, 2), padding="SAME")
    ours.load_state_dict({"kernel": torch.from_numpy(params["model"]["kernel"]),
                          "bias": torch.from_numpy(params["model"]["bias"]),
                          **_layer_state(tm)}, strict=True)
    with torch.no_grad():
        np.testing.assert_array_equal(ours(torch.from_numpy(x), tsites.FIXED).numpy(), got)


def test_layernorm_parity_vs_quantlayernorm(rng):
    """One intercepted ``nn.LayerNorm`` equals JAX's intercepted one (flax's
    two-pass variance, ``use_fast_variance=False``, as
    ``tests/test_flax_surgery.py`` takes) and the port's
    ``QuantLayerNorm``, bit for bit."""
    x = _grid(rng, (4, 16), 8, 24)
    params = {"model": {"scale": 1.0 + _grid(rng, (16,), 64, 16),
                        "bias": _grid(rng, (16,), 16, 8)}}
    jm, jv, tm = _pair(fnn.LayerNorm(use_fast_variance=False),
                       torch.nn.LayerNorm(16, eps=1e-6), {}, params, x)
    got, want = _run(jm, jv, tm, x, "FIXED")
    np.testing.assert_array_equal(got, want)
    ours = tlayers.QuantLayerNorm(_qc(tc), 16, epsilon=1e-6)
    ours.load_state_dict({"scale": torch.from_numpy(params["model"]["scale"]),
                          "bias": torch.from_numpy(params["model"]["bias"]),
                          **_layer_state(tm)}, strict=True)
    with torch.no_grad():
        np.testing.assert_array_equal(ours(torch.from_numpy(x), tsites.FIXED).numpy(), got)


def test_filter_fn_skips_layers(rng):
    """FP_logits-style setup: the head stays unquantized (no site state, its
    own op), the rest is quantized. The output equals JAX's within a few f32
    ulps: the unquantized head multiplies raw f32 LayerNorm outputs, whose
    16 products XLA and PyTorch sum in their own orders."""
    x = _grid(rng, (4, 8))
    params = _mlp_params(rng)
    jm = j_quantize(ForeignMLP(), _qc(jc), filter_fn=lambda path, mod: "head" not in path)
    _, ups = jm.apply({"params": params}, jnp.asarray(x), qp=jsites.ESTIMATE,
                      mutable=["quant", "quant_est"])
    jv = {"params": params, **_tree(ups)}
    assert "head" not in jv["quant"]["model"]
    paths = []
    tm = quantize_flax_model(TorchMLP(), _qc(tc),
                             filter_fn=lambda path, mod: paths.append(path) or path != "head")
    assert paths == ["fc1", "ln", "head"]
    tm.load_state_dict(from_flax_surgery_variables(jv), strict=True)
    assert not any(k.startswith("model.head.") and "quantizer" in k for k in tm.state_dict())
    assert "model.fc1.activation_quantizer.maxval" in tm.state_dict()
    seen = []
    tm.model.head.register_forward_hook(lambda mod, args, out: seen.append((args[0], out)))
    got, want = _run(jm, jv, tm, x, "FIXED")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    (head_in, head_out), = seen
    assert torch.equal(head_out, torch.nn.functional.linear(head_in, tm.model.head.weight,
                                                           tm.model.head.bias))


def test_specials_override(rng):
    """A custom handler replaces the default ``nn.Linear`` interception: it
    runs on each Linear (given the intercepted layer, with the phase) and no
    site state is made for them."""
    calls = []

    def spy_dense(qc_, mod, x, qp):
        calls.append((mod.out_features, qp))
        return x @ mod.weight.t() + mod.bias

    tm = quantize_flax_model(TorchMLP(), _qc(tc), specials={torch.nn.Linear: spy_dense})
    with torch.no_grad():
        tm(torch.from_numpy(_grid(rng, (4, 8))), qp=tsites.ESTIMATE)
    assert calls == [(16, tsites.ESTIMATE), (4, tsites.ESTIMATE)]
    assert not any(k.startswith(("model.fc1.", "model.head.")) and "quantizer" in k
                   for k in tm.state_dict())
    assert "model.ln.activation_quantizer.maxval" in tm.state_dict()


def test_approx_path_parity(rng):
    """An intercepted ``nn.Linear`` under ``approx_flag`` equals the port's
    ``QuantDense`` under it bit for bit (one K3 wrapper: its plain version
    here), and JAX's intercepted ``nn.Dense`` (its Pallas kernel in
    interpret mode) at ``rtol = atol = 1e-6``."""
    kw = dict(run_method=_approx_run, approx=_approx)
    x = _grid(rng, (4, 8))
    params = {"model": {"kernel": _grid(rng, (8, 8), 16), "bias": _grid(rng, (8,), 16)}}
    jm, jv, tm = _pair(fnn.Dense(8), torch.nn.Linear(8, 8), kw, params, x)
    got, want = _run(jm, jv, tm, x, "FIXED")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(want).max() > 0
    ours = tlayers.QuantDense(_qc(tc, **kw), 8, 8)
    ours.load_state_dict({"kernel": torch.from_numpy(params["model"]["kernel"]),
                          "bias": torch.from_numpy(params["model"]["bias"]),
                          **_layer_state(tm)}, strict=True)
    with torch.no_grad():
        np.testing.assert_array_equal(ours(torch.from_numpy(x), tsites.FIXED).numpy(), got)


def test_weight_cache_roundtrip(rng):
    """A ``cache_weights`` forward fills each layer's ``w_q`` (the (in, out)
    layout, equal to JAX's ``quant_cache``), the fixed phase then uses it,
    and the cache carries across from JAX's variables."""
    x = _grid(rng, (4, 8))
    jm, jv, tm = _pair(ForeignMLP(), TorchMLP(), {}, _mlp_params(rng), x)
    cache_qp = dict(phase="fixed", cache_weights=True)
    out_j, ups = jm.apply(jv, jnp.asarray(x), qp=jsites.QuantPhase(**cache_qp),
                          mutable=["quant_cache"])
    jv = {**jv, **_tree(ups)}
    with torch.no_grad():
        out_ref = tm(torch.from_numpy(x), qp=tsites.QuantPhase(**cache_qp))
        assert tm.model.fc1.w_q is not None and tm.model.fc1.w_q.shape == (8, 16)
        out_cached = tm(torch.from_numpy(x), qp=tsites.FIXED)
    assert torch.equal(out_cached, out_ref)
    np.testing.assert_array_equal(out_ref.numpy(), np.asarray(out_j))
    state = from_flax_surgery_variables(jv)
    assert {k for k in state if ".w_" in k} == {k for k in tm.state_dict() if ".w_" in k}
    # a fresh wrapper takes the cache (and everything else) from JAX's variables
    fresh = quantize_flax_model(TorchMLP(), _qc(tc))
    fresh.load_state_dict(state, strict=True)
    with torch.no_grad():
        np.testing.assert_array_equal(fresh(torch.from_numpy(x), qp=tsites.FIXED).numpy(),
                                      np.asarray(jm.apply(jv, jnp.asarray(x), qp=jsites.FIXED)))


def test_foreign_mlp_matches_jax(rng):
    """The torch twin of ``ForeignMLP`` held whole against JAX's in FIXED:
    the site state after ESTIMATE (checked in ``_pair``) and the logits, bit
    for bit; the foreign model's own ``state_dict`` loads into the
    intercepted tree unchanged."""
    x = _grid(rng, (4, 8))
    params = _mlp_params(rng)
    jm, jv, tm = _pair(ForeignMLP(), TorchMLP(), {}, params, x)
    got, want = _run(jm, jv, tm, x, "FIXED")
    np.testing.assert_array_equal(got, want)
    foreign = TorchMLP()
    missing, unexpected = tm.model.load_state_dict(foreign.state_dict(), strict=False)
    assert not unexpected and all("quantizer" in k for k in missing)
    assert torch.equal(tm.model.head.weight, foreign.head.weight)


def test_phase_does_not_leak(rng):
    """The phase lives for one wrapper call in its own thread: a failing
    forward restores it, and a forward in another thread sees none."""
    tm = quantize_flax_model(TorchMLP(), _qc(tc))
    x = torch.from_numpy(_grid(rng, (4, 8)))
    with torch.no_grad():
        tm(x, qp=tsites.ESTIMATE)
    seen = []

    class Boom(torch.nn.Module):
        def forward(self, x):
            seen.append(tm._slot.qp)
            thread = threading.Thread(target=lambda: seen.append(tm._slot.qp))
            thread.start()
            thread.join()
            raise RuntimeError("boom")

    tm.model.boom = Boom()
    tm.model.forward = lambda x: tm.model.boom(x)
    with pytest.raises(RuntimeError):
        tm(x, qp=tsites.FIXED)
    assert seen == [tsites.FIXED, None] and tm._slot.qp is None
    with torch.no_grad():
        assert torch.equal(tm.model.fc1(x), torch.nn.functional.linear(
            x, tm.model.fc1.weight, tm.model.fc1.bias))


def test_refusals(rng):
    """What the handlers refuse: a conv ``padding_mode`` other than "zeros"
    (no counterpart in flax) and, as JAX's, the approx path on a grouped
    foreign conv."""
    with pytest.raises(ValueError, match="padding_mode"):
        quantize_flax_model(torch.nn.Conv2d(2, 2, 3, padding=1, padding_mode="reflect"),
                            _qc(tc))
    tm = quantize_flax_model(torch.nn.Conv2d(4, 4, 3, groups=2),
                             _qc(tc, run_method=_approx_run, approx=_approx))
    assert isinstance(tm, QuantizedFlaxModel)
    with pytest.raises(NotImplementedError, match="grouped foreign convs"):
        with torch.no_grad():
            tm(torch.from_numpy(_grid(rng, (1, 4, 5, 5))), qp=tsites.ESTIMATE)
