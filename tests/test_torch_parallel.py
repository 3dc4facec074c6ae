"""The port's mesh layer (``parallel/``) on a virtual mesh of eight CPU
devices, against the same port paths without a mesh and against the JAX
package's single-device outputs: the cases of ``tests/test_parallel.py``
that need no Llama (those are in ``test_torch_parallel_serving.py``), the
placement rules, the partitioned K4/K5 plain versions over a (2, 4) mesh,
the CLI's ``--mesh-data/--mesh-model`` and the dry run.

JAX's ``tests/test_parallel.py`` holds each of its mesh programs equal (or
within its tolerance) to the single-device program, so the JAX side here is
single-device only and compiles no mesh program. Each mesh path of the port
must equal the same path without a mesh (the partitioned products sum each
output over the whole K, and the plain versions do not depend on the rows
or columns beside an output). Against JAX, the port is held at the JAX
test's own tolerance where the frameworks agree to it (calibration, FIXED
outputs and metrics: ``rtol = 1e-6``; the packed dense and int4 layers:
bit for bit); the int8 CNN, whose BN and sums the frameworks round
differently, at ``tests/test_conv_serving.py``'s cross-framework
``5e-4`` with the same top-1 (``test_torch_cnn_serving_models.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cnn_mobilenet import FULL_SETTING, MODELS, SIZE, _cut_mobilenet  # noqa: F401
from test_torch_cnn_serving import exact_bn, tree, uniform_qc
from test_torch_cnn_serving_models import INT8_TOL, port_caches
from test_torch_llama import numpy_tree
from test_torch_llama import qc as _qc  # tests/test_parallel.py's FP8 configuration
from test_torch_packed import _values

from fp8_quantization_tpu import config as jc
from fp8_quantization_tpu.eval import MetricState as JMetricState
from fp8_quantization_tpu.eval import update_metrics as j_update_metrics
from fp8_quantization_tpu.models.demo import QuantizedDemoModel as JDemo
from fp8_quantization_tpu.ops.fastpath import pack_dense_caches as j_pack
from fp8_quantization_tpu.ops.fastpath import strip_packed_params as j_strip
from fp8_quantization_tpu.ops.layers import QuantDense as JDense
from fp8_quantization_tpu.parallel import param_spec as j_param_spec
from fp8_quantization_tpu.quant import sites as jsites
from fp8_quantization_tpu_torch import config as tc
from fp8_quantization_tpu_torch.eval.driver import cache_quantized_weights as t_cache
from fp8_quantization_tpu_torch.eval.metrics import MetricState, update_metrics
from fp8_quantization_tpu_torch.models.bridge import from_jax_variables
from fp8_quantization_tpu_torch.models.demo import QuantizedDemoModel
from fp8_quantization_tpu_torch.ops import fastpath
from fp8_quantization_tpu_torch.ops.cuda import dequant_matmul as k4
from fp8_quantization_tpu_torch.ops.layers import QuantDense
from fp8_quantization_tpu_torch.parallel import (make_mesh, param_spec, partitioned_kernels,
                                                 replicate, reshard, shard_batch,
                                                 shard_kernels, shard_variables, sharding)
from fp8_quantization_tpu_torch.quant import sites as tsites

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

CPU8 = [torch.device("cpu")] * 8


def mesh(data, model):
    return make_mesh(data=data, model=model, devices=CPU8[:data * model])


# -- placement rules ---------------------------------------------------------

@pytest.mark.parametrize("shape,model_size", [
    ((16, 32), 4), ((16, 30), 4), ((3, 3, 8, 16), 4), ((16,), 4), ((2,), 4), ((), 4),
    ((16, 32), 1), ((4096, 1024), 8)])
def test_param_spec_matches_jax(shape, model_size):
    """The last axis shards over ``model`` when it divides, else the leaf
    replicates: JAX's rule, entry for entry."""
    value = np.zeros(shape, np.float32)
    assert param_spec(("w",), value, model_size) == tuple(j_param_spec(("w",), value, model_size))


def test_make_mesh_and_placement(rng):
    """A (2, 4) mesh of one repeated device; too few devices raise JAX's
    message; ``shard_variables`` places only what the partitioned products
    read (packed codes and their bias), as contiguous slices on their
    cells' devices, each stored once per distinct device; ``reshard`` drops
    the placement on another mesh; a write in place lapses a placement."""
    m = mesh(2, 4)
    assert m.shape == {"data": 2, "model": 4} and m.devices.shape == (2, 4)
    assert m.first == torch.device("cpu") and m.size == 8 and m == mesh(2, 4)
    with pytest.raises(ValueError, match=r"needs 8 devices but only 1 are available"):
        make_mesh(data=2, model=4, devices="cpu")

    layer = QuantDense(tc.QuantConfig(), 6, 8)
    shard_variables(layer, m)
    assert sharding.shards_of(layer.kernel, m) is None     # read whole, not placed
    assert sharding.shards_of(layer.bias, m) is None
    codes = torch.from_numpy(rng.integers(0, 256, size=(6, 8)).astype(np.uint8))
    bias = torch.from_numpy(rng.integers(3, 6, size=(8,)).astype(np.int32))
    shard_variables({"layer": {"w_codes": codes, "w_pack_bias": bias}}, m)
    sh = sharding.shards_of(codes, m)
    assert sh.spec == (None, "model")
    for d in range(2):
        for j in range(4):
            piece = sh.grid[d][j]
            assert piece.is_contiguous() and piece.device == m.devices[d, j]
            assert torch.equal(piece, codes[:, 2 * j:2 * j + 2])
            assert piece is sh.grid[0][j]                  # once per distinct device
    assert sharding.shards_of(bias, m).spec == ("model",)

    x = shard_batch(np.arange(24, dtype=np.float32).reshape(4, 6), m)
    xs = sharding.shards_of(x, m)
    assert xs.spec == ("data", None) and torch.equal(xs.grid[1][3], x[2:])
    odd = shard_batch(np.zeros((3, 2), np.float32), m)     # 3 rows do not divide
    assert sharding.shards_of(odd, m).spec == ()
    r = replicate(torch.ones(5), m)
    assert sharding.shards_of(r, m).grid[1][2].data_ptr() == r.data_ptr()   # no copy

    other = mesh(1, 2)
    reshard({"w_codes": codes}, other)
    assert sharding.shards_of(codes, m) is None
    assert sharding.shards_of(codes, other).spec == (None, "model")
    codes.add_(1)
    assert sharding.shards_of(codes, other) is None


def test_initialize_multihost():
    """One process without a coordinator or the launcher's environment
    starts nothing and is rank 0; with a coordinator it joins a gloo group
    of one process (the CPU's backend) as rank 0."""
    import socket

    import torch.distributed as dist

    assert sharding.initialize_multihost() == 0 and not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    try:
        assert sharding.initialize_multihost(f"localhost:{port}", 1, 0) == 0
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# -- calibration and metrics (tests/test_parallel.py) -------------------------

def test_sharded_calibration_matches_single_device(rng):
    """Calibration and the FIXED output over a (2, 4) mesh equal the port's
    single-device run, and JAX's single-device run (``rtol = 1e-6``)."""
    x = rng.normal(size=(8, 16)).astype(np.float32)
    jm = JDemo(qc=_qc(jc), features=16)
    variables = jm.init(jax.random.key(0), jnp.asarray(x), jsites.ESTIMATE)
    _, ups = jm.apply(variables, jnp.asarray(x), jsites.ESTIMATE, mutable=["quant", "quant_est"])
    y_ref = np.asarray(jm.apply({**variables, **ups}, jnp.asarray(x), jsites.FIXED))

    outs, maxvals = [], []
    for m in (None, mesh(2, 4)):
        tm = QuantizedDemoModel(_qc(tc), features=16)
        tm.load_state_dict(from_jax_variables(numpy_tree(variables)), strict=True)
        xt = torch.from_numpy(x)
        if m is not None:
            shard_variables(tm, m)
            xt = shard_batch(x, m)
        with torch.no_grad():
            tm(xt, tsites.ESTIMATE)
            outs.append(tm(xt, tsites.FIXED).numpy())
        maxvals.append(tm.fc.weight_quantizer.maxval.detach().numpy())
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(maxvals[1], maxvals[0])
    np.testing.assert_allclose(outs[1], y_ref, rtol=1e-6)
    np.testing.assert_allclose(
        maxvals[1], np.asarray(ups["quant"]["fc"]["weight_quantizer"]["q"]["maxval"]), rtol=1e-6)


def test_sharded_metrics_match(rng):
    """Metrics of a batch placed over ``data`` = 8 by ``shard_batch`` equal
    the unsharded counts and JAX's (``rtol = 1e-6``)."""
    logits = rng.normal(size=(8, 32)).astype(np.float32)
    labels = rng.integers(0, 32, size=(8,))
    ref = np.asarray(j_update_metrics(JMetricState.zero(), jnp.asarray(logits),
                                      jnp.asarray(labels)))
    m = mesh(8, 1)
    ls, ys = shard_batch((logits, labels), m)
    assert sharding.shards_of(ys, m).spec == ("data",)
    out = np.asarray([float(v) for v in update_metrics(MetricState.zero(), ls, ys)])
    plain = np.asarray([float(v) for v in update_metrics(
        MetricState.zero(), torch.from_numpy(logits), torch.from_numpy(labels))])
    np.testing.assert_allclose(out, plain, rtol=1e-6)
    np.testing.assert_allclose(out, ref, rtol=1e-6)


# -- the partitioned K4/K5 products -----------------------------------------

@pytest.mark.parametrize("m_rows,n,calls", [
    (8, 16, "partitioned"),      # rows over data, columns over model
    (7, 16, "partitioned"),      # rows do not divide: the columns alone
    (8, 18, "unsharded"),        # columns do not divide: the unsharded call
])
@pytest.mark.parametrize("coded", [False, True], ids=["bf16_x", "coded_x"])
def test_sharded_dequant_matmul_plain(rng, m_rows, n, calls, coded):
    """``sharded_dequant_matmul`` over (2, 4) equals the unsharded K4 (plain
    version here) bit for bit, launches once per cell (none on the CPU),
    and counts its route; codes without a placement are split at the call
    and counted."""
    k = 24
    codes = torch.from_numpy(rng.integers(0, 256, size=(k, n)).astype(np.uint8))
    bias = torch.from_numpy(rng.integers(3, 6, size=(n,)).astype(np.int32))
    if coded:
        x = torch.from_numpy(rng.integers(0, 256, size=(m_rows, k)).astype(np.uint8))
        kw = dict(x_bias=torch.tensor(4, dtype=torch.int32), x_expo=3, x_mant=4)
    else:
        x = torch.from_numpy(rng.normal(size=(m_rows, k)).astype(np.float32)).to(torch.bfloat16)
        kw = {}
    ref = k4.dequant_matmul(x, codes, bias, expo_width=3, mant_width=4, **kw)
    m = mesh(2, 4)
    shard_kernels.reset_calls()
    with partitioned_kernels(m):
        got = shard_kernels.sharded_dequant_matmul(x, codes, bias, expo_width=3, mant_width=4,
                                                   **kw)
    assert torch.equal(got, ref)
    split = int(calls == "partitioned")
    # the codes and the bias, unplaced, are split at the call
    assert shard_kernels.CALLS == {"partitioned": split, "unsharded": 1 - split,
                                   "split_on_call": 2 * split}
    shard_variables({"w_codes": codes, "w_pack_bias": bias}, m)
    shard_kernels.reset_calls()
    with partitioned_kernels(m):
        again = shard_kernels.sharded_dequant_matmul(x, codes, bias, expo_width=3,
                                                     mant_width=4, **kw)
    assert torch.equal(again, ref) and shard_kernels.CALLS["split_on_call"] == 0
    assert k4.dequant_matmul.launches == 0
    # outside a context the call is the unsharded one, uncounted
    shard_kernels.reset_calls()
    assert torch.equal(shard_kernels.sharded_dequant_matmul(
        x, codes, bias, expo_width=3, mant_width=4, **kw), ref)
    assert shard_kernels.CALLS == {"partitioned": 0, "unsharded": 0, "split_on_call": 0}


def test_partitioned_kernel_reads_the_placed_shards(rng, monkeypatch):
    """The counterpart of ``tests/test_parallel.py::
    test_partitioned_kernel_hlo_has_no_code_gather``: under
    ``partitioned_kernels`` each K4 launch gets the very code and bias
    shards ``shard_variables`` placed (no gather, copy or concatenation of
    the byte codes at the call), and rows of x that are views of x."""
    codes = torch.from_numpy(rng.integers(0, 256, size=(16, 32)).astype(np.uint8))
    bias = torch.from_numpy(rng.integers(3, 6, size=(32,)).astype(np.int32))
    x = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32)).to(torch.bfloat16)
    m = mesh(2, 4)
    shard_variables({"w_codes": codes, "w_pack_bias": bias}, m)
    placed_codes = sharding.shards_of(codes, m).grid
    placed_bias = sharding.shards_of(bias, m).grid
    seen = []
    real = k4.dequant_matmul
    monkeypatch.setattr(k4, "dequant_matmul",
                        lambda xs, c, b, **kw: seen.append((xs, c, b)) or real(xs, c, b, **kw))
    with partitioned_kernels(m):
        shard_kernels.sharded_dequant_matmul(x, codes, bias, expo_width=3, mant_width=4)
    assert len(seen) == 8
    for i, (xs, c, b) in enumerate(seen):
        d, j = divmod(i, 4)
        assert c is placed_codes[d][j] and b is placed_bias[d][j]
        assert xs.data_ptr() == x[4 * d:].data_ptr() and xs.shape == (4, 16)


@pytest.mark.parametrize("m_rows,k", [(8, 33), (20, 64), (2, 17)])
def test_sharded_int4_matmul_plain(rng, m_rows, k):
    """``sharded_int4_matmul`` over (2, 4) equals the unsharded K5 plain
    version bit for bit, odd K and rows that do not divide included."""
    n = 32
    x = torch.from_numpy(rng.integers(-128, 128, size=(m_rows, k)).astype(np.int8))
    w4 = torch.from_numpy(rng.integers(0, 256, size=(-(-k // 2), n)).astype(np.uint8))
    m = mesh(2, 4)
    shard_variables({"w_i4": w4}, m)
    shard_kernels.reset_calls()
    with partitioned_kernels(m):
        got = shard_kernels.sharded_int4_matmul(x, w4, k=k)
    assert torch.equal(got, k4.int4_matmul(x, w4, k=k))
    assert shard_kernels.CALLS == {"partitioned": 1, "unsharded": 0, "split_on_call": 0}


def _calibrated_dense(rng, jqc, tqc, k=16, n=16, n_bits_w=None):
    """``tests/test_parallel.py::_calibrated_dense`` on both sides: JAX
    calibrates, caches, packs and strips; the port loads JAX's calibrated
    state, caches and packs its own."""
    x = rng.normal(size=(8, k)).astype(np.float32)
    jl = JDense(qc=jqc, features=n, n_bits_w=n_bits_w)
    v = jl.init(jax.random.key(0), jnp.asarray(x), jsites.ESTIMATE)
    _, ups = jl.apply(v, jnp.asarray(x), jsites.ESTIMATE, mutable=["quant", "quant_est"])
    v = {**v, **ups}
    warm = jsites.QuantPhase(phase="fixed", fast=True, cache_weights=True)
    _, ups = jl.apply(v, jnp.asarray(x), warm, mutable=["quant_cache"])
    vp = j_strip(j_pack({**v, **ups}, jqc)[0])

    tl = QuantDense(tqc, k, n, n_bits_w=n_bits_w)
    tl.load_state_dict(from_jax_variables(numpy_tree(
        {key: v[key] for key in ("params", "quant", "quant_est")})), strict=True)
    with torch.no_grad():
        tl(torch.from_numpy(x), tsites.QuantPhase(phase="fixed", fast=True, cache_weights=True))
    fastpath.pack_dense_caches(tl, tqc)
    fastpath.strip_packed_params(tl)
    return jl, vp, tl, x


def _serve_on_mesh(tl, x, m, qp):
    shard_variables(tl, m)
    shard_kernels.reset_calls()
    with torch.no_grad(), partitioned_kernels(m):
        out = tl(shard_batch(x, m), qp)
    assert shard_kernels.CALLS == {"partitioned": 1, "unsharded": 0, "split_on_call": 0}
    return out


def test_partitioned_dequant_matmul_matches_single_device(rng):
    """A packed-FP8 dense under ``partitioned_kernels`` over (2, 4): each
    cell runs K4 on its (K, N/model) code shard; PACKED and CHAINED (uint8
    x codes) outputs equal the port's single-device ones and JAX's, bit
    for bit."""
    jl, vp, tl, x = _calibrated_dense(rng, _qc(jc), _qc(tc))
    for name in ("PACKED", "CHAINED"):
        ref = _values(tl(torch.from_numpy(x), getattr(tsites, name)))
        got = _values(_serve_on_mesh(tl, x, mesh(2, 4), getattr(tsites, name)))
        np.testing.assert_array_equal(got, ref, err_msg=name)
        np.testing.assert_array_equal(
            got, _values(jl.apply(vp, jnp.asarray(x), getattr(jsites, name))), err_msg=name)


def test_partitioned_int4_matmul_matches_single_device(rng):
    """An int4 nibble-packed dense under ``partitioned_kernels`` over
    (2, 4): the exact int32 sums of each shard give the single-device
    output, the port's and JAX's, bit for bit."""
    jl, vp, tl, x = _calibrated_dense(rng, uniform_qc(jc), uniform_qc(tc), n_bits_w=4)
    assert tl.w_i4 is not None
    ref = _values(tl(torch.from_numpy(x), tsites.PACKED))
    got = _values(_serve_on_mesh(tl, x, mesh(2, 4), tsites.PACKED))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, _values(jl.apply(vp, jnp.asarray(x), jsites.PACKED)))


# -- a whole CNN, the CLI and the dry run -------------------------------------

def test_sharded_chained_cnn_matches_single_device(rng):
    """The int8 fused-boundary (``Affine``) MobileNetV2 under CHAINED over a
    (2, 4) mesh equals the single-device port run, and JAX's single-device
    run on the same calibrated state and packed codes (module docstring)."""
    calib = rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    x = rng.normal(size=(8, SIZE, SIZE, 3)).astype(np.float32)
    jm = MODELS["mobilenet_v2"][0](uniform_qc(jc))
    variables = exact_bn(tree(jax.jit(lambda key, c: jm.init(key, c, jsites.ESTIMATE))(
        jax.random.key(0), jnp.asarray(calib))))
    tm = MODELS["mobilenet_v2"][1](uniform_qc(tc))
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    t_cache(tm, calib, fast=True)
    fastpath.pack_dense_caches(tm, uniform_qc(tc))
    jv = {**variables, "quant_cache": port_caches(tm)}
    fastpath.strip_packed_params(tm)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x), tsites.CHAINED).float().numpy()
        m = mesh(2, 4)
        shard_variables(tm, m)
        out = tm(shard_batch(x, m), tsites.CHAINED).float().numpy()
    np.testing.assert_array_equal(out, ref)
    theirs = np.asarray(jax.jit(lambda v, x: jsites.decoded(jm.apply(v, x, jsites.CHAINED)))(
        jv, jnp.asarray(x)), np.float32)
    np.testing.assert_allclose(out, theirs, **INT8_TOL)
    np.testing.assert_array_equal(out.argmax(-1), theirs.argmax(-1))


def test_cli_mesh_flags_on_the_demo(monkeypatch, tmp_path):
    """``validate-quantized-demo --mesh-data 2 --mesh-model 4 --no-cuda``,
    with the CPU's device list patched to eight devices, places the model
    on that mesh and gives the metrics of the run without a mesh; with the
    one real CPU device it raises."""
    from fp8_quantization_tpu_torch import cli

    base = ["validate-quantized-demo", "--architecture", "demo_quantized", "--no-cuda",
            "--batch-size", "8", "--max-eval-batches", "2", "--num-est-batches", "1",
            "--approx-output-dir", str(tmp_path)]
    flags = ["--mesh-data", "2", "--mesh-model", "4"]
    with pytest.raises(ValueError, match="needs 8 devices"):
        cli.main(base + flags)
    placed = []
    real_place = sharding.shard_variables
    monkeypatch.setattr(sharding, "available_devices", lambda kind="cuda": CPU8)
    monkeypatch.setattr("fp8_quantization_tpu_torch.parallel.shard_variables",
                        lambda v, m: placed.append((v, m.shape)) or real_place(v, m))
    with_mesh = cli.main(base + flags)
    assert len(placed) == 1 and isinstance(placed[0][0], torch.nn.Module)
    assert placed[0][1] == {"data": 2, "model": 4}
    assert with_mesh["metrics"] == cli.main(base)["metrics"]


def test_dryrun_multichip(monkeypatch):
    """The port's dry run over eight virtual CPU devices: every mesh path
    runs, and the packed K4 and w4a8 K5 decode steps partition every
    product (no unsharded call, no weight split at a call). Its MobileNetV2
    has the whole table."""
    from fp8_quantization_tpu_torch.models import mobilenet_v2 as t_mobilenet
    from fp8_quantization_tpu_torch.parallel.dryrun import dryrun_multichip

    monkeypatch.setattr(t_mobilenet, "INVERTED_RESIDUAL_SETTING", FULL_SETTING)

    out = dryrun_multichip(8, CPU8)
    assert out["ring prefill"] == (2, 16, 128)
    for name in ("packed decode", "w4a8 decode"):
        assert out[name]["partitioned"] == 15 and out[name]["unsharded"] == 0
