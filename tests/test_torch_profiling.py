"""The port's ``utils/profiling.py`` against the JAX package's, on the CPU:
``device_peaks`` gives NaN for a device it does not know (the CPU, as JAX's
does for its CPU device), ``roofline``'s arithmetic equals JAX's on the same
peaks, and ``benchmark`` and ``trace`` run a CPU function. The card's peaks
are written once: ``chip_smoke.py``'s bound constants are ``PEAKS``'."""

import json
import math
import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from fp8_quantization_tpu.utils import profiling as jprof
from fp8_quantization_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

H100 = "H100 80GB HBM3"


def test_device_peaks_on_the_cpu_are_nan():
    theirs = jprof.device_peaks(jax.devices("cpu")[0])
    for peaks in (tprof.device_peaks("cpu"), tprof.device_peaks(torch.device("cpu"))):
        assert set(peaks) == set(theirs)
        assert all(math.isnan(v) for v in peaks.values())
        assert all(math.isnan(v) for v in theirs.values())
    if not torch.cuda.is_available():
        assert all(math.isnan(v) for v in tprof.device_peaks().values())


def test_peaks_are_the_h100s_and_the_smokes():
    """One entry, the H100's data-sheet peaks, which ``chip_smoke.py``'s
    bounds read."""
    assert tprof.PEAKS == {H100: {"bf16_tflops": 989.0, "hbm_gbps": 3350.0}}
    assert chip_smoke.HBM_BYTES_PER_S == tprof.PEAKS[H100]["hbm_gbps"] * 1e9
    assert chip_smoke.BF16_TC_OPS_PER_S == tprof.PEAKS[H100]["bf16_tflops"] * 1e12


@pytest.mark.parametrize("seconds,flops,nbytes", [(1e-3, 2e12, 0.0), (2.5e-4, 0.0, 8e8),
                                                  (3e-5, 7.5e9, 1.25e7)])
def test_roofline_matches_jax(monkeypatch, seconds, flops, nbytes):
    """On the same peaks (the H100's, patched into both), the same numbers;
    on the CPU's NaN peaks, the same rates and NaN fractions."""
    peaks = dict(tprof.PEAKS[H100])
    monkeypatch.setattr(tprof, "device_peaks", lambda device=None: peaks)
    monkeypatch.setattr(jprof, "device_peaks", lambda device=None: peaks)
    ours = tprof.roofline(seconds, flops, nbytes)
    assert ours == jprof.roofline(seconds, flops, nbytes)
    assert ours["bw_fraction_of_peak"] == nbytes / seconds / 1e9 / 3350.0
    monkeypatch.undo()
    ours = tprof.roofline(seconds, flops, nbytes, device="cpu")
    theirs = jprof.roofline(seconds, flops, nbytes, device=jax.devices("cpu")[0])
    assert {k: v for k, v in ours.items() if "fraction" not in k} == \
        {k: v for k, v in theirs.items() if "fraction" not in k}
    assert all(math.isnan(ours[k]) and math.isnan(theirs[k])
               for k in ("flops_fraction_of_peak", "bw_fraction_of_peak"))


def test_benchmark_on_a_cpu_function():
    calls = []
    x = torch.ones(64, 64)

    def fn(a):
        calls.append(1)
        return a @ a

    best = tprof.benchmark(fn, x, iters=5, repeats=2)
    assert len(calls) == 1 + 5 * 2
    assert 0.0 < best < 1.0


def test_trace_writes_a_chrome_trace(tmp_path):
    """The block's ops land in ``log_dir/trace.json`` and in the profiler
    the context yields; the trace is written when the block raises too."""
    x = torch.ones(32, 32)
    with tprof.trace(str(tmp_path / "a")) as prof:
        torch.mm(x, x)
    with open(os.path.join(tmp_path, "a", tprof.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    with pytest.raises(ValueError):
        with tprof.trace(str(tmp_path / "b")):
            torch.mm(x, x)
            raise ValueError("inside the block")
    assert os.path.exists(os.path.join(tmp_path, "b", tprof.TRACE_FILE))
    assert np.isfinite(float(torch.mm(x, x).sum()))
