"""The port's QAT against the JAX package's, on the same numpy inputs and
the same JAX variables (carried in through ``models.bridge``): partitioning,
the schedules, ``make_qat_step`` (SGD and Adam, a shared or a separate
range optimizer, ``estimate_ranges_train``, LSQ ``grad_scaling``), one step
of a depth-cut MobileNetV2, ``train_qat`` and the ``train-qat`` CLI.

Tolerances. The forward is the JAX package's arithmetic, so the step-1
loss agrees to ``rtol=1e-6``. ``torch.optim`` and optax round an update
differently: SGD's ``p - lr * buf`` may be one fused multiply-add where
optax rounds ``-lr * trace`` first, and Adam's bias corrections and
``sqrt`` run in another order. Each differs from the other by a few ulps
of the update, and the update itself is at most ``lr`` times the gradient
(Adam: about ``lr``), so after a step the weights and ranges agree to
``rtol=1e-5`` with ``atol`` four ulps of the largest value of the tensor
(``_close``). The gradients themselves come from products summed in
another order, which the same tolerance covers after two steps.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu import cli as jcli
from fp8_quantization_tpu import config as jc
from fp8_quantization_tpu.eval.trainer import train_qat as j_train_qat
from fp8_quantization_tpu.models.demo import QuantizedDemoModel as JDemo
from fp8_quantization_tpu.quant import ESTIMATE as J_ESTIMATE
from fp8_quantization_tpu.quant import qat as jqat
from fp8_quantization_tpu.quant import quantizers as jq
from fp8_quantization_tpu_torch import cli as tcli
from fp8_quantization_tpu_torch import config as tc
from fp8_quantization_tpu_torch.eval.driver import calibrate as t_calibrate
from fp8_quantization_tpu_torch.eval.trainer import train_qat as t_train_qat
from fp8_quantization_tpu_torch.models.bridge import from_jax_variables
from fp8_quantization_tpu_torch.models.demo import QuantizedDemoModel as TDemo
from fp8_quantization_tpu_torch.ops.cuda import KERNELS
from fp8_quantization_tpu_torch.quant import qat as tqat
from fp8_quantization_tpu_torch.quant import quantizers as tq
from fp8_quantization_tpu_torch.quant import sites as tsites
from fp8_quantization_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

LOSS_RTOL = 1e-6
STATE_RTOL = 1e-5
ULPS = 4


def _qc(mod, **fp8):
    """``tests/test_qat.py::_qc``: the FP8 demo with learnable maxval."""
    return mod.QuantConfig(
        method=mod.QMethod.fp_quantizer, quantize_input=True,
        weight_range=mod.EstimatorConfig(mod.RangeMethod.current_minmax),
        act_range=mod.EstimatorConfig(mod.RangeMethod.allminmax),
        fp8=mod.FP8Config(set_maxval=True, mse_include_mantissa_bits=False,
                          **{"learn_maxval": True, **fp8}),
        run_method=mod.RunMethodConfig(res_quantizer_flag=True, original_quantize_res=True))


def _uniform_qc(mod, method="asymmetric_uniform", n_bits=4, per_channel=False):
    return mod.QuantConfig(
        method=mod.QMethod(method), n_bits=n_bits, per_channel_weights=per_channel,
        quantize_input=True, weight_range=mod.EstimatorConfig(mod.RangeMethod.current_minmax),
        act_range=mod.EstimatorConfig(mod.RangeMethod.allminmax))


def _data(seed=10):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(8, 10)).astype(np.float32)
    y = rng.integers(0, 10, size=(8,)).astype(np.int32)
    return x, y


def _np(tree):
    return jax.tree.map(np.asarray, dict(tree))


@functools.lru_cache(maxsize=None)
def _calibrated(kind: str):
    """The JAX demo (``kind``: "fp8" or "uniform") initialized and calibrated
    on the first batch, as numpy variables."""
    qc = _qc(jc) if kind == "fp8" else _uniform_qc(jc)
    model = JDemo(qc=qc)
    x, _ = _data()

    @jax.jit
    def calibrated(x):
        variables = model.init(jax.random.key(0), x, J_ESTIMATE)
        _, ups = model.apply(variables, x, J_ESTIMATE, mutable=["quant", "quant_est"])
        return {**variables, **ups}

    return _np(calibrated(jnp.asarray(x)))


def _pair(kind: str, **fp8):
    """(JAX model, its variables, port model loaded with them)."""
    qc_kw = fp8 if kind == "fp8" else {}
    jqc = _qc(jc, **qc_kw) if kind == "fp8" else _uniform_qc(jc)
    tqc = _qc(tc, **qc_kw) if kind == "fp8" else _uniform_qc(tc)
    variables = _calibrated(kind)
    tm = TDemo(tqc)
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    return JDemo(qc=jqc), variables, tm


def _close(ours, theirs, name):
    theirs = np.asarray(theirs, np.float32)
    atol = ULPS * float(np.spacing(np.float32(np.abs(theirs).max(initial=0.0))))
    np.testing.assert_allclose(ours, theirs, rtol=STATE_RTOL, atol=atol, err_msg=name)


def _jax_state_dict(state):
    return from_jax_variables(_np(jqat.merge_variables(state[0], state[1], state[2])))


def _assert_state(tm, want: dict):
    got = tm.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        _close(got[key].detach().numpy(), value.numpy(), key)


@pytest.mark.parametrize("learn_maxval", [False, True])
@pytest.mark.parametrize("learn_mbits", [False, True])
def test_partition_merge_roundtrip(learn_maxval, learn_mbits):
    fp8 = dict(learn_maxval=learn_maxval, learn_mantissa_bits=learn_mbits)
    jm, variables, tm = _pair("fp8", **fp8)
    trainable = jqat.trainable_range_params(jm.qc)
    assert tqat.trainable_range_params(tm.qc) == trainable
    j_mp, j_qt, j_rest = jqat.partition_variables(variables, trainable)
    mp, qt, rest = tqat.partition_variables(tm, trainable)
    assert set(mp) == set(from_jax_variables({"params": j_mp}))
    assert set(qt) == set(from_jax_variables({"quant": j_qt}))
    assert set(qt) == {f"{site}.{k}" for site in ("fc.activation_quantizer",
                                                  "fc.res_quantizer", "fc.weight_quantizer")
                       for k, on in (("maxval", learn_maxval), ("mantissa_bits", learn_mbits))
                       if on}
    merged = tqat.merge_variables(mp, qt, rest)
    assert list(merged) != [] and set(merged) == set(tm.state_dict())
    for key, value in tm.state_dict(keep_vars=True).items():
        assert merged[key] is value
    # all four names (make_qat_step's default) take both FP ranges
    _, qt_all, _ = tqat.partition_variables(tm)
    assert {k.rsplit(".", 1)[1] for k in qt_all} == {"maxval", "mantissa_bits"}


@pytest.mark.parametrize("schedule", ["MultiStepLR:2:3", "cosine:1e-4", None])
def test_schedule_matches_optax(schedule):
    spe, total = 5, 20
    j = jqat.make_schedule(0.1, schedule, total, spe)
    t = tqat.make_schedule(0.1, schedule, total, spe)
    if schedule is None:
        assert t == j == 0.1
        return
    # optax applies a boundary's scale from the count equal to it on
    steps = [0, 9, 10, 11, 14, 15, 16, total]
    want = [float(j(jnp.int32(c))) for c in steps]
    np.testing.assert_allclose([t(c) for c in steps], want, rtol=1e-6)
    if schedule.startswith("Multi"):
        assert t(9) == pytest.approx(0.1) and t(10) == pytest.approx(0.01)
        assert t(15) == pytest.approx(0.001)


# (model optimizer, range optimizer or None for the same one, step options)
STEP_CASES = {
    "sgd shared": (("SGD", 0.05, 0.9, 1e-3), None, {}),
    "sgd + adam ranges": (("SGD", 0.05, 0.9, 1e-3), ("Adam", 0.01), {}),
    "adam shared": (("Adam", 0.01, 0.9, 1e-4), None, {}),
    "estimate ranges": (("SGD", 0.05, 0.9, None), None, {"estimate_ranges_train": True}),
}


def _opts(pkg, spec):
    if spec is None:
        return None
    return pkg.make_optimizer(*spec)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_qat_step_matches_jax(case):
    """One and two steps on the calibrated FP8 demo: the loss, then every
    weight and range (the rest unchanged), against JAX."""
    m_spec, q_spec, kw = STEP_CASES[case]
    jm, variables, tm = _pair("fp8")
    x, y = _data(11)
    j_step, j_init = jqat.make_qat_step(jm, _opts(jqat, m_spec), _opts(jqat, q_spec), **kw)
    t_step, t_init = tqat.make_qat_step(tm, _opts(tqat, m_spec), _opts(tqat, q_spec), **kw)
    j_state, t_state = j_init(jax.tree.map(jnp.asarray, variables)), t_init(tm)
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    for i in range(2):
        xs = x * (7.0 if i == 0 and kw else 1.0)  # estimate: a wider batch moves the ranges
        j_state, j_loss = j_step(j_state, jnp.asarray(xs), jnp.asarray(y))
        t_state, t_loss = t_step(t_state, xs, y)
        if i == 0:
            np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=LOSS_RTOL)
        _assert_state(tm, _jax_state_dict(j_state))
    assert {k: fn.launches for k, fn in KERNELS.items()} == launches
    assert t_state.osc["step"] == 2 and t_state.m_opt_state.count == 2
    if kw:
        mv = float(tm.fc.activation_quantizer.maxval.detach()[0])
        assert mv == pytest.approx(float(np.abs(x * 7.0).max()))


def test_estimate_ranges_train_tracks_the_estimator():
    """``tests/test_qat.py:103``: under ``estimate_ranges_train`` a much
    wider batch widens the allminmax act range to its own max, overriding
    the optimizer's update of the ranges; the weights still learn."""
    jm, variables, tm = _pair("fp8")
    x, y = _data(11)
    step, init = tqat.make_qat_step(tm, tqat.make_optimizer("SGD", learning_rate=0.05),
                                    estimate_ranges_train=True)
    state = init(tm)
    kernel = tm.fc.kernel.detach().clone()
    state, _ = step(state, x * 7.0, y)
    assert float(tm.fc.activation_quantizer.maxval.detach()[0]) == pytest.approx(
        float(np.abs(x * 7.0).max()))
    assert not torch.equal(tm.fc.kernel, kernel)
    state, loss = step(state, x, y)
    assert np.isfinite(float(loss))


@pytest.mark.parametrize("method,per_channel", [("asymmetric_uniform", False),
                                                ("asymmetric_uniform", True),
                                                ("symmetric_uniform", True)])
def test_lsq_grad_scaling_matches_jax(method, per_channel, rng):
    """LSQ gradient scaling on a 4-bit uniform site: the gradients of
    ``delta`` and ``zero_float`` against ``jax.grad`` (the forward is
    unchanged, bit for bit)."""
    jcfg = jc.QuantizerConfig(method=jc.QMethod(method), n_bits=4, per_channel=per_channel)
    tcfg = tc.QuantizerConfig(method=tc.QMethod(method), n_bits=4, per_channel=per_channel)
    x = rng.normal(size=(16, 6)).astype(np.float32)
    n = 6 if per_channel else 1
    state = {"delta": rng.uniform(0.1, 0.3, size=n).astype(np.float32),
             "zero_float": rng.uniform(3.0, 9.0, size=n).astype(np.float32),
             "signed": np.ones(1, np.int32)}
    g_out = rng.normal(size=x.shape).astype(np.float32)

    def j_loss(d, z, gs):
        q = {"delta": d, "zero_float": z, "signed": jnp.asarray(state["signed"])}
        return jnp.sum(jq.uniform_apply(jcfg, q, jnp.asarray(x), -1, gs) * g_out)

    ts = {k: torch.tensor(v) for k, v in state.items()}
    for gs in (False, True):
        want = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(state["delta"]),
                                                 jnp.asarray(state["zero_float"]), gs)
        d, z = (ts["delta"].clone().requires_grad_(), ts["zero_float"].clone().requires_grad_())
        y = tq.uniform_apply(tcfg, {**ts, "delta": d, "zero_float": z}, torch.tensor(x), -1, gs)
        (y * torch.tensor(g_out)).sum().backward()
        np.testing.assert_allclose(d.grad.numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-6)
        # a symmetric grid never reads zero_float: no gradient, zeros in JAX
        zg = torch.zeros_like(z) if z.grad is None else z.grad
        np.testing.assert_allclose(zg.numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-6)
        assert np.any(np.asarray(want[0]) != 0)
        if gs:
            assert not np.allclose(d.grad.numpy(), ungated)
        ungated = d.grad.numpy()
    np.testing.assert_array_equal(
        tq.uniform_apply(tcfg, ts, torch.tensor(x), -1, True).detach().numpy(),
        np.asarray(jq.uniform_apply(jcfg, jax.tree.map(jnp.asarray, state), jnp.asarray(x),
                                    -1, True)))


def test_qat_step_grad_scaling_matches_jax():
    """One ``grad_scaling`` step on the calibrated 4-bit asymmetric demo:
    the per-tensor sites go through ``uniform_apply`` while training, so
    ``delta`` and ``zero_float`` train as in JAX."""
    jm, variables, tm = _pair("uniform")
    x, y = _data(11)
    opt = ("SGD", 0.05, 0.9, None)
    j_step, j_init = jqat.make_qat_step(jm, jqat.make_optimizer(*opt), grad_scaling=True)
    t_step, t_init = tqat.make_qat_step(tm, tqat.make_optimizer(*opt), grad_scaling=True)
    j_state, t_state = j_init(jax.tree.map(jnp.asarray, variables)), t_init(tm)
    before = {k: v.detach().clone() for k, v in t_state.quant_train.items()}
    j_state, j_loss = j_step(j_state, jnp.asarray(x), jnp.asarray(y))
    t_state, t_loss = t_step(t_state, x, y)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=LOSS_RTOL)
    _assert_state(tm, _jax_state_dict(j_state))
    assert any(not torch.equal(before[k], v) for k, v in t_state.quant_train.items())


# MobileNetV2 at width 0.25 with its table cut to the t = 1 block (the CNN
# parity tests cut it to four blocks, whose JAX train step compiles for
# ~12 s): 8x8 images, built for 64 so that its pool averages the last 2x2
# map
CNN_SETTING = ((1, 16, 1, 2),)
CNN_IMAGE, CNN_BUILT, CNN_CLASSES = 8, 64, 10


def _cnn_qc(mod):
    """``scripts/image_net.sh``'s configuration with learnable maxval."""
    return mod.QuantConfig(
        method=mod.QMethod.fp_quantizer, per_channel_weights=True, quantize_input=True,
        weight_range=mod.EstimatorConfig(mod.RangeMethod.current_minmax),
        act_range=mod.EstimatorConfig(mod.RangeMethod.allminmax),
        fp8=mod.FP8Config(set_maxval=True, mse_include_mantissa_bits=False, learn_maxval=True),
        run_method=mod.RunMethodConfig(res_quantizer_flag=True, original_quantize_res=True))


def _to_jax(shapes, state):
    """The JAX variables of ``shapes`` (a flax variables tree) filled from a
    port ``state_dict``, by ``models.bridge``'s naming: paths joined with
    dots, a site's ``q`` / ``est`` level dropped."""
    def leaf(path, _):
        keys = [k.key for k in path]
        coll, keys = keys[0], keys[1:]
        if coll in ("quant", "quant_est") and keys[-2] in ("q", "est"):
            keys = keys[:-2] + keys[-1:]
        # a copy: JAX may alias a numpy buffer on the CPU, and the port's
        # step writes these tensors in place
        return jnp.asarray(state[".".join(keys)].numpy().copy())
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_bn_cnn_step_matches_jax(monkeypatch):
    """One QAT step of the depth-cut MobileNetV2 (BN with its running stats,
    ReLU6, per-channel FP8 weights; SGD for the model, Adam for the ranges):
    the loss to ``rtol=1e-6``, every weight, BN parameter and range to the
    module's tolerance. ReLU6 meets exact zeros (FP8 flushes small conv
    outputs to 0, and BN maps them to ``beta = 0``), where ``jnp.clip``
    splits the gradient: the port's clamps do the same."""
    from fp8_quantization_tpu.models import mobilenet_v2 as j_mobilenet
    from fp8_quantization_tpu.models.mobilenet_v2 import QuantizedMobileNetV2 as JMob
    from fp8_quantization_tpu.quant.sites import QuantPhase as JPhase
    from fp8_quantization_tpu_torch.models import mobilenet_v2 as t_mobilenet
    from fp8_quantization_tpu_torch.models.mobilenet_v2 import MobileNetV2Spec
    from fp8_quantization_tpu_torch.models.mobilenet_v2 import QuantizedMobileNetV2 as TMob

    monkeypatch.setattr(j_mobilenet, "INVERTED_RESIDUAL_SETTING", CNN_SETTING)
    monkeypatch.setattr(t_mobilenet, "INVERTED_RESIDUAL_SETTING", CNN_SETTING)
    rng = np.random.default_rng(0)
    calib, x = (rng.normal(size=(2, CNN_IMAGE, CNN_IMAGE, 3)).astype(np.float32)
                for _ in range(2))
    y = np.array([3, 7], np.int32)
    jm = JMob(qc=_cnn_qc(jc), num_classes=CNN_CLASSES, width_mult=0.25, input_size=CNN_BUILT)
    tm = TMob(_cnn_qc(tc), MobileNetV2Spec(num_classes=CNN_CLASSES, width_mult=0.25,
                                           image_size=CNN_BUILT),
              generator=torch.Generator().manual_seed(0))
    t_calibrate(tm, [calib])
    # the JAX variables are the port's calibrated state, laid on the tree of
    # flax's init traced abstractly (compiling it would take ~5 s)
    shapes = jax.eval_shape(lambda c: jm.init(jax.random.key(0), c, JPhase(phase="estimate")),
                            jnp.asarray(calib))
    variables = _to_jax(shapes, tm.state_dict())
    assert from_jax_variables(_np(variables)).keys() == tm.state_dict().keys()
    trainable = jqat.trainable_range_params(jm.qc)
    kw = dict(trainable=trainable)
    j_step, j_init = jqat.make_qat_step(jm, jqat.make_optimizer("SGD", 0.05, 0.9, 1e-4),
                                        jqat.make_optimizer("Adam", 0.01), **kw)
    t_step, t_init = tqat.make_qat_step(tm, tqat.make_optimizer("SGD", 0.05, 0.9, 1e-4),
                                        tqat.make_optimizer("Adam", 0.01), **kw)
    j_state, j_loss = jax.block_until_ready(
        j_step(j_init(variables), jnp.asarray(x), jnp.asarray(y)))
    before = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    _, t_loss = t_step(t_init(tm), x, y)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=LOSS_RTOL)
    want = _jax_state_dict(j_state)
    _assert_state(tm, want)
    moved = [k for k, v in tm.state_dict().items() if not torch.equal(v, before[k])]
    assert any(k.endswith(".beta") for k in moved)
    assert any(k.endswith("activation_quantizer.maxval") for k in moved)


def _demo_batches(seed, n=2):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(8, 10)).astype(np.float32),
             rng.integers(0, 10, size=(8,)).astype(np.int32)) for _ in range(n)]


def test_train_qat_matches_jax(tmp_path):
    """``train_qat`` on the calibrated FP8 demo, 2 epochs x 2 steps, Adam
    and a separate range optimizer: each epoch's loss and top-1/top-5
    against JAX's ``train_qat``, and the ``latest`` checkpoint restores to
    equal logits."""
    jm, variables, tm = _pair("fp8")
    data = _demo_batches(12)
    kw = dict(max_epochs=2, steps_per_epoch=2, optimizer="Adam", learning_rate=5e-2,
              sep_quant_optimizer=True)
    _, j_hist = j_train_qat(jm, jax.tree.map(jnp.asarray, variables), lambda: iter(data),
                            eval_batches=lambda: iter(data), **kw)
    _, t_hist = t_train_qat(tm, lambda: iter(data), eval_batches=lambda: iter(data),
                            save_checkpoint_dir=str(tmp_path), **kw)
    assert [h["epoch"] for h in t_hist] == [0, 1]
    for th, jh in zip(t_hist, j_hist):
        assert set(th) == set(jh)
        np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
        assert th["top_1_accuracy"] == jh["top_1_accuracy"]
        assert th["top_5_accuracy"] == jh["top_5_accuracy"]
    # the ranges are plain buffers again after training
    assert not any(t.requires_grad for t in tm.buffers())
    restored = TDemo(_qc(tc))
    load_checkpoint(str(tmp_path / "latest"), restored)
    x = torch.from_numpy(data[0][0])
    with torch.no_grad():
        assert torch.equal(restored(x, tsites.FIXED), tm(x, tsites.FIXED))


TRAIN_QAT_FLAGS = ("learning_rate", "optimizer", "momentum", "weight_decay",
                   "learning_rate_schedule", "max_epochs", "sep_quant_optimizer",
                   "quant_optimizer", "quant_learning_rate", "grad_scaling", "steps_per_epoch",
                   "tb_logging_dir")


@pytest.mark.parametrize("argv", [[], ["--sep-quant-optimizer", "--grad-scaling",
                                       "--learning-rate-schedule", "cosine:1e-5",
                                       "--weight-decay", "1e-4", "--steps-per-epoch", "3"]],
                         ids=["defaults", "set"])
def test_train_qat_flags_parse_as_jax(argv):
    """The 12 ``train-qat`` flags (and the rest of its parser) parse to the
    JAX CLI's values."""
    argv = ["train-qat", "--architecture", "demo_quantized"] + argv
    j = vars(jcli.build_parser().parse_args(argv))
    t = vars(tcli.build_parser().parse_args(argv))
    assert set(TRAIN_QAT_FLAGS) <= set(j)
    assert t == j


def test_training_through_a_kernel_raises(tmp_path):
    """What would send a training forward through a kernel, or through a
    cached weight without a gradient, raises: the approximate multiplier
    (K3), a weight cache or packed codes, and the CLI's serving modes."""
    approx = tc.QuantConfig(
        method=tc.QMethod.fp_quantizer, quantize_input=True,
        run_method=tc.RunMethodConfig(res_quantizer_flag=True, approx_flag=True))
    model = TDemo(approx)
    _, init = tqat.make_qat_step(model, tqat.make_optimizer())
    with pytest.raises(ValueError, match="approximate multiplier"):
        init(model)
    _, _, model = _pair("fp8")
    from fp8_quantization_tpu_torch.eval.driver import cache_quantized_weights

    cache_quantized_weights(model, torch.zeros(1, 10))
    _, init = tqat.make_qat_step(model, tqat.make_optimizer())
    with pytest.raises(ValueError, match="weight caches"):
        init(model)
    for flag in ("--fast-mode", "--packed-weights", "--chained-acts"):
        with pytest.raises(ValueError, match="fixed phase"):
            tcli.main(["train-qat", "--architecture", "demo_quantized", "--no-cuda", flag])
