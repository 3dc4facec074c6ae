"""Porting torch state dicts and the port's checkpoints, on the CPU.

* Each ``port_*`` on a state dict the test writes under the source's own
  names (HF ViT at depth 2; torchvision ResNet-18 and ResNet-50 and the
  reference's MobileNetV2 at full width, with conv biases ahead of BN to
  fold into ``running_mean``; a two-layer HF Llama at small widths) equals
  the JAX package's ported tree after ``models.bridge.from_jax_variables``
  exactly, and reads every tensor of the file but the BN counters. No
  full-size forward runs.
* ``merge_ported`` lays the ported tensors over a built model's state.
* ``validate-quantized --model-dir`` round trip on a depth-cut ViT: a
  ``.pth`` of HF names loads (every ported entry equal to the file's tensor
  after its layout change), ``--save-checkpoint-dir`` saves the calibrated
  model, a second run from that checkpoint (``--model-dir <dir>``) restores
  every buffer and gives equal metrics.
* ``save_checkpoint`` / ``load_checkpoint``: bit-equal for every buffer of
  a calibrated, MSE-elected and packed model (the elected
  ``mantissa_bits``, the bf16 weight cache and the packed codes included)
  and equal PACKED logits.
"""

import functools

import numpy as np
import pytest
import torch

from fp8_quantization_tpu.models import porting as jporting
from fp8_quantization_tpu_torch import cli as tcli
from fp8_quantization_tpu_torch.models import porting as tporting
from fp8_quantization_tpu_torch.models.bridge import from_jax_variables
from fp8_quantization_tpu_torch.models.vit import ViTSpec

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

VIT_DEPTH2 = ViTSpec(num_layers=2)
TINY_VIT = ViTSpec(hidden_size=32, num_layers=2, num_heads=4, mlp_dim=64, patch_size=8,
                   image_size=32, num_classes=10)
CASES = {
    "vit_depth2": ("vit_quantized", lambda s: jporting.port_vit(s, num_layers=2),
                   lambda s: tporting.port_vit(s, num_layers=2), dict(spec=VIT_DEPTH2)),
    "resnet18": ("resnet18_quantized", lambda s: jporting.port_resnet(s, 18),
                 lambda s: tporting.port_resnet(s, 18), dict(conv_bias=True)),
    "resnet50": ("resnet50_quantized", lambda s: jporting.port_resnet(s, 50),
                 lambda s: tporting.port_resnet(s, 50), dict(conv_bias=True)),
    "mobilenet_v2": ("mobilenet_v2_quantized", jporting.port_mobilenet_v2,
                     tporting.port_mobilenet_v2, dict(conv_bias=True)),
}


def _jax_ported(params, stats):
    tree = {"params": jax_tree(params)}
    if stats:
        tree["batch_stats"] = jax_tree(stats)
    return from_jax_variables(tree)


def jax_tree(t):
    return {k: jax_tree(v) if isinstance(v, dict) else np.asarray(v) for k, v in t.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_jax(case):
    arch, jport, tport, kw = CASES[case]
    state = tporting.seeded_source_state(arch, torch.Generator().manual_seed(1), **kw)
    used = tporting.UsedKeys(state)
    ours = tport(used)
    assert tporting.unported_keys(used) == ()
    counters = [k for k in state if k.endswith("num_batches_tracked")]
    assert len(used.used) + len(counters) == len(state)
    want = _jax_ported(*jport(jporting.torch_state_to_numpy(state)))
    assert set(ours) == set(want)
    for key, value in want.items():
        assert ours[key].dtype == torch.float32 and torch.equal(ours[key], value), key


def test_port_llama_matches_jax():
    """``port_llama``: HF Llama names at small widths, two layers."""
    gen = torch.Generator().manual_seed(2)
    h, f, v = 16, 24, 40
    state = {"model.embed_tokens.weight": torch.randn(v, h, generator=gen),
             "model.norm.weight": torch.randn(h, generator=gen),
             "lm_head.weight": torch.randn(v, h, generator=gen)}
    for i in range(2):
        src = f"model.layers.{i}"
        state[f"{src}.input_layernorm.weight"] = torch.randn(h, generator=gen)
        state[f"{src}.post_attention_layernorm.weight"] = torch.randn(h, generator=gen)
        for name, shape in (("self_attn.q_proj", (h, h)), ("self_attn.k_proj", (8, h)),
                            ("self_attn.v_proj", (8, h)), ("self_attn.o_proj", (h, h)),
                            ("mlp.gate_proj", (f, h)), ("mlp.up_proj", (f, h)),
                            ("mlp.down_proj", (h, f))):
            state[f"{src}.{name}.weight"] = torch.randn(*shape, generator=gen)
    used = tporting.UsedKeys(state)
    ours = tporting.port_llama(used, num_layers=2)
    assert used.used == set(state)
    want = _jax_ported(*jporting.port_llama(jporting.torch_state_to_numpy(state), num_layers=2))
    assert set(ours) == set(want)
    for key, value in want.items():
        assert torch.equal(ours[key], value), key


def test_merge_ported_overlays_a_model():
    model, _ = tcli.build_model("vit_quantized", _fp8_qc(), torch.device("cpu"),
                                torch.Generator().manual_seed(0), spec=TINY_VIT)
    state = tporting.seeded_source_state("vit_quantized", torch.Generator().manual_seed(3),
                                         spec=TINY_VIT)
    ported = tporting.port_architecture("vit_quantized_approx", state, model)
    merged = tporting.merge_ported(model.state_dict(), ported)
    model.load_state_dict(merged)
    now = model.state_dict()
    assert all(torch.equal(now[k], v) for k, v in ported.items())
    assert torch.equal(now["layer_1.output.kernel"],
                       state["vit.encoder.layer.1.output.dense.weight"].t())
    with pytest.raises(ValueError, match="shape mismatch"):
        tporting.merge_ported(model.state_dict(), {"classifier.bias": torch.zeros(3)})
    with pytest.raises(KeyError):
        tporting.merge_ported(model.state_dict(), {"nope": torch.zeros(3)})
    with pytest.raises(ValueError, match="no torch porting rule"):
        tporting.port_architecture("demo_quantized", state)


def _fp8_qc():
    from fp8_quantization_tpu_torch import config as tc

    return tc.QuantConfig(
        method=tc.QMethod.fp_quantizer, per_channel_weights=True, quantize_input=True,
        weight_range=tc.EstimatorConfig(tc.RangeMethod.current_minmax),
        act_range=tc.EstimatorConfig(tc.RangeMethod.allminmax),
        fp8=tc.FP8Config(set_maxval=True, mse_include_mantissa_bits=False),
        run_method=tc.RunMethodConfig(res_quantizer_flag=True, original_quantize_res=True))


PUBLISHED = ["--no-cuda", "--synthetic-data", "--batch-size", "2", "--max-eval-batches", "1",
             "--qmethod", "fp_quantizer", "--per-channel", "--weight-quant-method",
             "current_minmax", "--act-quant-method", "allminmax", "--quantize-input",
             "--res-quantizer-flag", "--original-quantize-res", "--fp8-set-maxval",
             "--no-fp8-mse-include-mantissa-bits", "--seed", "4"]


def test_model_dir_round_trip(tmp_path, monkeypatch):
    """``--model-dir file.pth`` (HF names, a depth-cut ViT), then
    ``--save-checkpoint-dir``, then ``--model-dir <checkpoint dir>`` under
    ``--fast-mode --packed-weights``: the ported entries equal the file's
    tensors after their layout change, the logits differ from a seeded-init
    run's, and the restored run's state and metrics equal the first's."""
    monkeypatch.setattr(tcli, "build_model", functools.partial(tcli.build_model, spec=TINY_VIT))
    models, at_setup = [], []
    real_setup = tcli.setup

    def setup(args):
        out = real_setup(args)
        models.append(out[0])
        at_setup.append({k: v.clone() for k, v in out[0].state_dict().items()})
        return out

    monkeypatch.setattr(tcli, "setup", setup)
    state = tporting.seeded_source_state("vit_quantized", torch.Generator().manual_seed(5),
                                         spec=TINY_VIT)
    torch.save(state, tmp_path / "vit.pth")
    argv = ["validate-quantized", "--architecture", "vit_quantized", *PUBLISHED,
            "--approx-output-dir", str(tmp_path / "out"), "--fast-mode", "--packed-weights"]
    seeded = tcli.main(argv)
    loaded = tcli.main(argv + ["--model-dir", str(tmp_path / "vit.pth"),
                               "--save-checkpoint-dir", str(tmp_path / "ckpt")])
    restored = tcli.main(argv + ["--model-dir", str(tmp_path / "ckpt")])
    assert torch.equal(at_setup[1]["patch_projection.kernel"],
                       state["vit.embeddings.patch_embeddings.projection.weight"]
                       .permute(2, 3, 1, 0))
    for key, value in tporting.port_vit(state, num_layers=2).items():
        assert torch.equal(at_setup[1][key], value), key
    assert seeded["metrics"] != loaded["metrics"]
    assert loaded["checkpoint"] == str(tmp_path / "ckpt" / "checkpoint.ckpt")
    # the second run's model, restored, is the first's after its run
    saved, got = models[1].state_dict(), at_setup[2]
    assert set(saved) == set(got) and any(k.endswith("w_codes") for k in got)
    for key, value in saved.items():
        assert value.dtype == got[key].dtype and torch.equal(value, got[key]), key
    assert restored["metrics"] == loaded["metrics"]


def test_checkpoint_round_trip(tmp_path):
    """Save -> load into a fresh model: every buffer bit-equal (the act
    sites' MSE search grids and elected ``mantissa_bits``, the bf16 weight
    cache, the packed codes), and equal PACKED logits."""
    import dataclasses

    from fp8_quantization_tpu_torch import config as tc
    from fp8_quantization_tpu_torch.eval.driver import validate_quantized
    from fp8_quantization_tpu_torch.models.demo import QuantizedDemoModel
    from fp8_quantization_tpu_torch.quant.sites import ESTIMATE, PACKED
    from fp8_quantization_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    qc = dataclasses.replace(
        _fp8_qc(), act_range=tc.EstimatorConfig(tc.RangeMethod.MSE),
        fp8=tc.FP8Config(set_maxval=True, mse_include_mantissa_bits=True))
    rng = np.random.default_rng(6)
    x = rng.normal(size=(8, 10)).astype(np.float32)
    model = QuantizedDemoModel(qc, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        model(torch.zeros(1, 10), ESTIMATE)
    validate_quantized(model, [x], [(x, np.zeros(8, np.int64))], fast=True, packed=True,
                       qc=qc, calib_example=torch.zeros(1, 10))
    path = save_checkpoint(str(tmp_path / "c"), model)
    fresh = load_checkpoint(str(tmp_path / "c"), QuantizedDemoModel(qc))
    saved, got = model.state_dict(), fresh.state_dict()
    assert set(saved) == set(got)
    assert {"fc.activation_quantizer.mantissa_bits", "fc.activation_quantizer.search_grid",
            "fc.w_q", "fc.w_codes"} <= set(got)
    assert got["fc.w_q"].dtype == torch.bfloat16
    for key, value in saved.items():
        assert value.dtype == got[key].dtype and torch.equal(value, got[key]), key
    with torch.no_grad():
        assert torch.equal(model(torch.from_numpy(x), PACKED), fresh(torch.from_numpy(x), PACKED))
    assert load_checkpoint(path, QuantizedDemoModel(qc)) is not None


def test_misc_matches_jax():
    """``seed_all`` seeds Python's ``random`` and numpy as the JAX package's
    does, and returns a torch generator on the seed; ``Stopwatch``
    accumulates over start/stop spans and resets."""
    import random
    import time

    from fp8_quantization_tpu.utils import misc as jmisc
    from fp8_quantization_tpu_torch.utils import misc as tmisc

    gen = tmisc.seed_all(5)
    ours = (random.random(), np.random.rand(), torch.randn(2, generator=gen))
    jmisc.seed_all(5)
    assert (random.random(), np.random.rand()) == ours[:2]
    assert torch.equal(ours[2], torch.randn(2, generator=torch.Generator().manual_seed(5)))
    watch = tmisc.Stopwatch()
    with watch:
        time.sleep(0.01)
    first = watch.get_total_duration()
    watch.start()
    assert watch.get_total_duration() >= first >= 0.01
    watch.stop().reset()
    assert watch.get_total_duration() == 0.0
