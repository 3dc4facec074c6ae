"""The port stands alone: no module of ``fp8_quantization_tpu_torch`` and no
line of ``chip_smoke.py`` imports JAX, flax, optax, tensorflow or the JAX
package, not even a module of it that is free of JAX. Checked on the parsed source, so an import
inside a function counts as well."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "fp8_quantization_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tensorflow", "fp8_quantization_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
                and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_has_modules_and_chip_smoke():
    files = _port_files()
    assert os.path.exists(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 20


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def _csrc(name):
    with open(os.path.join(PORT, "csrc", name)) as f:
        return f.read()


def _sources():
    from fp8_quantization_tpu_torch.ops.cuda import build

    return build.SOURCES


@pytest.mark.parametrize("name", ["approx_matmul", "fused_matmul", "dequant_matmul",
                                  "int4_matmul", "attention", "decode_attention"])
def test_cuda_source_is_built_with_a_plain_c_interface(name):
    """Every kernel source is in ``build.SOURCES`` (compiled for sm_90a at
    first use), exports ``extern "C"`` entry points for ctypes and includes
    no PyTorch header (which would cost minutes of nvcc per build)."""
    assert name in _sources()
    text = _csrc(f"{name}.cu")
    assert 'extern "C" int fp8q_' in text
    includes = [ln for ln in text.splitlines() if ln.startswith("#include")]
    assert not [ln for ln in includes if "torch/" in ln or "ATen" in ln or "c10" in ln]


def test_every_csrc_file_is_a_source_or_an_included_header():
    names = sorted(os.listdir(os.path.join(PORT, "csrc")))
    sources = {f"{s}.cu" for s in _sources()}
    included = {n for n in names if n.endswith(".cuh")
                and any(f'#include "{n}"' in _csrc(m) for m in names if m != n)}
    assert {n for n in names if n.endswith((".cu", ".cuh"))} == sources | included
    assert {"exmy.cuh", "tile_gemm.cuh"} <= included


def test_importing_the_port_builds_nothing():
    """Every module imports without nvcc, triton or a GPU, and importing
    loads no kernel library: kernels build at first launch."""
    import importlib

    from fp8_quantization_tpu_torch.ops.cuda import build

    for path in _port_files():
        rel = os.path.relpath(path, ROOT)
        if rel == "chip_smoke.py":
            continue
        importlib.import_module(rel[:-3].replace(os.sep, ".").replace(".__init__", ""))
    assert build._LOADED == {}


# the pieces of the JAX package still to port: the mesh (``parallel/``) and
# what runs on it, each refused with ``NotImplementedError(... LATER)``
MESH_LATER = {
    ("cli.py", "--mesh-data / --mesh-model"),
    ("models/llama.py", "ring-attention prefill (ring_spec)"),
    ("models/serving.py", "mesh-sharded continuous batching"),
    ("models/paged_kv.py", "the mesh-sharded paged batcher"),
    ("models/speculative.py", "mesh-sharded speculative decoding"),
}


def test_only_the_mesh_is_left_to_port():
    """Every ``NotImplementedError`` that names ``LATER`` in the port's
    source is a mesh piece (``models/llama.py`` has two, one a path)."""
    found = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Raise) and isinstance(node.exc, ast.Call)
                    and isinstance(node.exc.args[0] if node.exc.args else None, ast.JoinedStr)
                    and any(isinstance(v, ast.FormattedValue) and getattr(v.value, "id", None)
                            == "_LATER" for v in node.exc.args[0].values)):
                text = "".join(v.value for v in node.exc.args[0].values
                               if isinstance(v, ast.Constant)).strip()
                found.append((os.path.relpath(path, PORT), text))
    assert set(found) == MESH_LATER
    assert len(found) == len(MESH_LATER) + 1
