"""The port's oscillation dampening and freezing, its QAT rounding variants
and its cosine schedules against the JAX package's, on the same numpy
inputs: ``dampening_loss`` and its gradient, the freezing functions (bit
for bit), three QAT steps with both on a 4-bit demo, ``CosineTempDecay`` /
``cosine_anneal``, ``scale_grad``, ``ewgs_round``,
``stacked_sigmoid_round`` and ``stochastic_round_ste``, and ``train-qat``
with the ``--oscillations-*`` flags.

The JAX side runs op by op where bit-exactness is claimed (under
``jax.jit`` XLA may fuse ``m * a + (1 - m) * b`` into one rounding).
Tolerances: the dampening loss sums squares in another order (``rtol =
1e-6``); the sigmoid of ``stacked_sigmoid_round``'s gradient and the
cosines are libm calls of each framework (``rtol = 1e-6``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from fp8_quantization_tpu import config as jc
from fp8_quantization_tpu.models.demo import QuantizedDemoModel as JDemo
from fp8_quantization_tpu.numerics import rounding as jround
from fp8_quantization_tpu.quant import ESTIMATE as J_ESTIMATE
from fp8_quantization_tpu.quant import oscillations as josc
from fp8_quantization_tpu.quant import qat as jqat
from fp8_quantization_tpu.utils import misc as jmisc
from fp8_quantization_tpu_torch import cli as tcli
from fp8_quantization_tpu_torch import config as tc
from fp8_quantization_tpu_torch.models.bridge import from_jax_variables
from fp8_quantization_tpu_torch.models.demo import QuantizedDemoModel as TDemo
from fp8_quantization_tpu_torch.numerics import rounding as tround
from fp8_quantization_tpu_torch.ops.layers import QuantDense
from fp8_quantization_tpu_torch.quant import oscillations as tosc
from fp8_quantization_tpu_torch.quant import qat as tqat
from fp8_quantization_tpu_torch.utils import misc as tmisc

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

RTOL = 1e-6
LAYERS = {"a": (6, 5), "b": (5, 4)}


def _uniform_qc(mod, method="symmetric_uniform", per_channel=False, n_bits=4):
    """``tests/test_oscillations.py::_uniform_qc``, per-channel optional."""
    return mod.QuantConfig(
        method=mod.QMethod(method), n_bits=n_bits, per_channel_weights=per_channel,
        quantize_input=True, weight_range=mod.EstimatorConfig(mod.RangeMethod.current_minmax),
        act_range=mod.EstimatorConfig(mod.RangeMethod.allminmax))


def _sites(rng, method, per_channel):
    """Two layers' kernels and weight-quantizer states, as numpy."""
    out = {}
    for name, (k, n) in LAYERS.items():
        c = n if per_channel else 1
        out[name] = (rng.normal(size=(k, n)).astype(np.float32) * 0.3,
                     {"delta": rng.uniform(0.05, 0.1, size=c).astype(np.float32),
                      "zero_float": rng.uniform(5.0, 9.0, size=c).astype(np.float32),
                      "signed": np.ones(1, np.int32)})
    return out


def _jax_trees(sites):
    params = {n: {"kernel": jnp.asarray(w)} for n, (w, _) in sites.items()}
    quant = {n: {"weight_quantizer": {"q": jax.tree.map(jnp.asarray, q)}}
             for n, (_, q) in sites.items()}
    return params, quant


class _Layers(nn.Module):
    """Two port ``QuantDense`` layers holding ``sites``."""

    def __init__(self, qc, sites):
        super().__init__()
        for name, (k, n) in LAYERS.items():
            setattr(self, name, QuantDense(qc, k, n))
        self.load(sites)

    def load(self, sites):
        with torch.no_grad():
            for name, (w, q) in sites.items():
                layer = getattr(self, name)
                layer.kernel.copy_(torch.from_numpy(w))
                for k, v in q.items():
                    getattr(layer.weight_quantizer, k).copy_(torch.from_numpy(v))


CASES = [("symmetric_uniform", False), ("asymmetric_uniform", True)]


@pytest.mark.parametrize("aggregation", ["sum", "mean", "kernel_mean"])
def test_dampening_loss_and_gradient_match_jax(aggregation, rng):
    qcs = _uniform_qc(jc, per_channel=True), _uniform_qc(tc, per_channel=True)
    sites = _sites(rng, "symmetric_uniform", True)
    params, quant = _jax_trees(sites)
    wq = qcs[0].weight_quantizer()
    want, grads = jax.value_and_grad(
        lambda p: josc.dampening_loss(p, quant, wq, aggregation))(params)
    model = _Layers(qcs[1], sites)
    loss = tosc.dampening_loss(model, qcs[1].weight_quantizer(), aggregation)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=RTOL)
    for name in LAYERS:
        np.testing.assert_allclose(getattr(model, name).kernel.grad.numpy(),
                                   np.asarray(grads[name]["kernel"]), rtol=RTOL, atol=1e-9)
        # the quantized weight is a constant: no gradient reaches the range
        assert getattr(model, name).weight_quantizer.delta.grad is None


@pytest.mark.parametrize("method,per_channel", CASES)
@pytest.mark.parametrize("use_ema", [True, False])
def test_freezing_functions_bit_exact(method, per_channel, use_ema, rng):
    """``freeze_init``, six ``freeze_update``s over weights that flip back
    and forth (and some that drift), ``project_frozen`` and
    ``mask_frozen_updates``, each state tensor bit for bit."""
    jqc, tqc = _uniform_qc(jc, method, per_channel), _uniform_qc(tc, method, per_channel)
    jcfg = jc.OscFreezeConfig(threshold=0.1, ema_momentum=0.3, use_ema=use_ema)
    tcfg = tc.OscFreezeConfig(threshold=0.1, ema_momentum=0.3, use_ema=use_ema)
    j_wq, t_wq = jqc.weight_quantizer(), tqc.weight_quantizer()
    sites = _sites(rng, method, per_channel)
    params, quant = _jax_trees(sites)
    model = _Layers(tqc, sites)
    j_state = josc.freeze_init(jcfg, j_wq, params, quant)
    t_state = tosc.freeze_init(tcfg, t_wq, model)
    assert set(j_state) == set(t_state) == set(LAYERS)
    # each weight moves by about a grid step, back and forth
    kicks = {n: rng.choice([-1.0, 1.0], size=w.shape) * q["delta"] * 0.7
             for n, (w, q) in sites.items()}
    for i in range(6):
        sites = {n: (w + kicks[n] * (1 if i % 2 == 0 else -1) * (1.0 + 0.1 * i), q)
                 for n, (w, q) in sites.items()}
        params, quant = _jax_trees(sites)
        model.load(sites)
        thr = josc.freeze_threshold(jcfg, i, 6)
        j_state = josc.freeze_update(jcfg, j_wq, j_state, params, quant, thr)
        t_state = tosc.freeze_update(tcfg, t_wq, t_state, model,
                                     tosc.freeze_threshold(tcfg, i, 6))
        for name in LAYERS:
            for key, value in j_state[name].items():
                np.testing.assert_array_equal(t_state[name][key].numpy(), np.asarray(value),
                                              err_msg=f"{i} {name} {key}")
    assert 0.0 < float(tosc.frozen_fraction(t_state)) < 1.0
    assert float(tosc.frozen_fraction(t_state)) == float(josc.frozen_fraction(j_state))
    # project the frozen weights onto their codes, and undo an update of them
    j_proj = josc.project_frozen(j_wq, j_state, params, quant)
    tosc.project_frozen(t_wq, t_state, model)
    before = tosc.kernels(model, t_state)
    upd = {n: rng.normal(size=shape).astype(np.float32) * 0.01 for n, shape in LAYERS.items()}
    j_upd = josc.mask_frozen_updates(
        j_state, {n: {"kernel": jnp.asarray(u), "bias": jnp.ones(LAYERS[n][1])}
                  for n, u in upd.items()})
    with torch.no_grad():
        for name in LAYERS:
            np.testing.assert_array_equal(getattr(model, name).kernel.numpy(),
                                          np.asarray(j_proj[name]["kernel"]))
            getattr(model, name).kernel.add_(torch.from_numpy(upd[name]))
    tosc.mask_frozen_updates(t_state, model, before)
    for name in LAYERS:
        np.testing.assert_array_equal(
            getattr(model, name).kernel.detach().numpy(),
            np.asarray(j_proj[name]["kernel"] + j_upd[name]["kernel"]))
        np.testing.assert_array_equal(np.asarray(j_upd[name]["bias"]), 1.0)


def test_fp_and_high_bit_layers_not_tracked(rng):
    cfg = tc.OscFreezeConfig(threshold=0.1, max_bits=4)
    fp = tc.QuantConfig(method=tc.QMethod.fp_quantizer, quantize_input=True)
    model = _Layers(_uniform_qc(tc), _sites(rng, "symmetric_uniform", False))
    assert tosc.freeze_init(cfg, fp.weight_quantizer(), model) == {}
    assert tosc.freeze_init(cfg, _uniform_qc(tc, n_bits=8).weight_quantizer(), model) == {}
    assert float(tosc.frozen_fraction({})) == 0.0


def test_qat_damp_and_freeze_steps_match_jax(rng):
    """Three QAT steps with dampening and freezing on the calibrated 4-bit
    symmetric demo at a high rate: the frozen masks, target codes and
    ``frozen_fraction`` equal JAX's after every step, and a frozen weight
    keeps its code."""
    qc = _uniform_qc(jc)
    jm = JDemo(qc=qc)
    x = rng.normal(size=(8, 10)).astype(np.float32)
    y = rng.integers(0, 10, size=(8,)).astype(np.int32)

    @jax.jit
    def calibrated(x):
        variables = jm.init(jax.random.key(0), x, J_ESTIMATE)
        _, ups = jm.apply(variables, x, J_ESTIMATE, mutable=["quant", "quant_est"])
        return {**variables, **ups}

    variables = calibrated(jnp.asarray(x))
    tm = TDemo(_uniform_qc(tc))
    tm.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, dict(variables))),
                       strict=True)
    kw = dict(total_steps=3)
    j_step, j_init = jqat.make_qat_step(
        jm, jqat.make_optimizer("SGD", learning_rate=0.3),
        osc_damp=jc.OscDampConfig(weight=0.1, weight_final=0.01, anneal_start=0.0),
        osc_freeze=jc.OscFreezeConfig(threshold=0.2, ema_momentum=0.5), **kw)
    t_step, t_init = tqat.make_qat_step(
        tm, tqat.make_optimizer("SGD", learning_rate=0.3),
        osc_damp=tc.OscDampConfig(weight=0.1, weight_final=0.01, anneal_start=0.0),
        osc_freeze=tc.OscFreezeConfig(threshold=0.2, ema_momentum=0.5), **kw)
    j_state, t_state = j_init(variables), t_init(tm)
    for i in range(3):
        j_state, j_loss = j_step(j_state, jnp.asarray(x), jnp.asarray(y))
        t_state, t_loss = t_step(t_state, x, y)
        np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
        jf, tf = j_state.osc["freeze"]["fc"], t_state.osc["freeze"]["fc"]
        np.testing.assert_array_equal(tf["frozen"].numpy(), np.asarray(jf["frozen"]))
        np.testing.assert_array_equal(tf["target_int"].numpy(), np.asarray(jf["target_int"]))
        assert (float(tosc.frozen_fraction(t_state.osc["freeze"]))
                == float(josc.frozen_fraction(j_state.osc["freeze"])))
    frozen = t_state.osc["freeze"]["fc"]["frozen"]
    assert frozen.any()
    x_int, _, _ = tosc._int_coords(tm.qc.weight_quantizer(), tm.fc.weight_quantizer.quant_state(),
                                   tm.fc.kernel.detach())
    assert torch.equal(x_int[frozen], t_state.osc["freeze"]["fc"]["target_int"][frozen])


def test_cosine_schedules_match_jax():
    j, t = jmisc.CosineTempDecay(50, (20.0, 2.0), 0.2), tmisc.CosineTempDecay(50, (20.0, 2.0), 0.2)
    for step in (0, 9, 10, 11, 30, 50):
        assert t(step) == pytest.approx(j(step), rel=RTOL)
    for final in (None, 0.1):
        for step in (0, 24, 25, 26, 60, 100):
            np.testing.assert_allclose(
                float(tosc.cosine_anneal(step, 100, 1.0, final, 0.25)),
                float(josc.cosine_anneal(jnp.int32(step), 100, 1.0, final, 0.25)), rtol=RTOL)


def _jax_vjp(fn, x, g, *args):
    y, vjp = jax.vjp(lambda v: fn(v, *args), jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("name,arg", [("scale_grad", 0.125), ("ewgs_round", 0.2),
                                      ("stacked_sigmoid_round", 4.0)])
def test_rounding_variants_match_jax(name, arg, rng):
    x = (rng.normal(size=(64,)) * 3).astype(np.float32)
    x[:4] = [0.5, 1.5, -2.5, 3.0]            # ties round to even
    g = rng.normal(size=x.shape).astype(np.float32)
    y_want, g_want = _jax_vjp(getattr(jround, name), x, g, arg)
    xt = torch.tensor(x, requires_grad=True)
    y = getattr(tround, name)(xt, arg)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), y_want)
    np.testing.assert_allclose(xt.grad.numpy(), g_want, rtol=RTOL, atol=1e-7)


def test_stochastic_round_ste():
    x = torch.linspace(-3, 3, 1001, requires_grad=True)
    gen = lambda: torch.Generator().manual_seed(7)  # noqa: E731
    y = tround.stochastic_round_ste(x, gen())
    assert torch.equal(y, tround.stochastic_round_ste(x, gen()))
    floor = torch.floor(x.detach())
    assert bool(((y == floor) | (y == floor + 1)).all())
    assert 0.0 < float((y == floor + 1).float().mean()) < 1.0
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
    y.backward(g)
    assert torch.equal(x.grad, g)


def test_cli_train_qat_with_osc_flags():
    """``tests/test_qat.py::test_train_qat_cli_with_osc_flags`` on the port."""
    metrics = tcli.main([
        "train-qat", "--architecture", "demo_quantized", "--batch-size", "8",
        "--quantize-input", "--max-epochs", "1", "--steps-per-epoch", "2", "--n-bits", "4",
        "--oscillations-dampen-weight", "0.1", "--oscillations-freeze-threshold", "0.01",
        "--no-cuda",
    ])
    assert "loss" in metrics and np.isfinite(metrics["loss"])
