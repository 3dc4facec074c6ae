"""Instruction mix of K3's main loop, and the tensor-core instructions of
the GEMMs K2, K4 and K5 and of the fused SDPA K7, read from the compiled
SASS.

    python -m fp8_quantization_tpu_torch.ops.cuda.sass_mix

Builds ``csrc/approx_matmul.cu`` (as :mod:`.build` does), disassembles it
with the toolkit's ``cuobjdump -sass``, takes the flagship instantiation
(``with_approx`` and ``quant_btw_mult_accu`` on, no clip, no s2nn2s), finds
its K-slice loop (the widest backward branch) and counts the instructions in
it by class, leaving out any loop nested in it (the per-product path of
off-grid slices, which the main path never takes). One pass of that loop
does ``BK * RM * RN`` products per thread, so the count per product,
staging included, is the loop's length over that: a diagnostic beside the
kernel's bound, which counts one table read a product. Prints one JSON
object. :func:`tensor_core_mix` counts the tensor-core instructions
(``HMMA`` of bf16 ``mma.sync``, ``IMMA`` of its int8 form, ``HGMMA`` of
``wgmma``) in each route of K2, K4 and K5 and in the fused SDPA K7: route B
of K2/K4 (``mma_gemm_kernel``), both routes of K5 (``int4_stream_kernel``,
``int4_mma_kernel``) and K7 (``sdpa_kernel``) must have them, route A of
K2/K4 (``stream_gemm_kernel``) sums on the CUDA cores. Needs the CUDA
toolkit, so it runs on the GPU machine only.
"""

from __future__ import annotations

import collections
import json
import os
import re
import subprocess

from . import build

# the kernel's tile: BK K-steps of an RM x RN block of products per thread
# and pass (csrc/approx_matmul.cu)
PRODUCTS_PER_PASS = 8 * 4 * 4
FLAGSHIP = "approx_matmul_kernelILb1ELb1ELb0ELb0E"

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_CLASSES = {
    "fp32": ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FRND", "FSET"),
    "int": ("IADD3", "IMAD", "IMNMX", "ISETP", "LOP3", "SHF", "LEA", "SEL", "IABS",
            "VIMNMX", "SGXT", "BMSK", "PRMT", "FLO", "POPC", "MOV", "I2F", "F2I"),
    "shared_load": ("LDS",),
    "shared_store": ("STS",),
    "global": ("LDG", "STG", "LDC", "ULDC"),
    "control": ("BRA", "BAR", "EXIT", "NOP", "BSYNC", "BSSY", "PLOP3", "P2R", "R2P"),
}


def _class(op: str) -> str:
    for name, ops in _CLASSES.items():
        if op in ops:
            return name
    return "other"


def _functions(sass: str):
    """{mangled name: [(address, opcode, text)]} of a ``cuobjdump -sass`` dump."""
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name] = []
            continue
        m = _LINE.search(line)
        if name is None or not m:
            continue
        text = m.group(2).strip()
        toks = [t for t in text.split() if not t.startswith("@")]
        if toks:
            funcs[name].append((int(m.group(1), 16), toks[0].split(".")[0], text))
    return funcs


def loop_mix(instrs):
    """Instructions of the widest backward branch's loop, counted by class,
    without those of the loops nested in it."""
    loops = []
    for addr, op, text in instrs:
        target = re.search(r"0x([0-9a-f]+)", text) if op == "BRA" else None
        if target and int(target.group(1), 16) < addr:
            loops.append((int(target.group(1), 16), addr))
    if not loops:
        raise RuntimeError("no backward branch: the K-slice loop was not found")
    lo, hi = max(loops, key=lambda span: span[1] - span[0])
    inner = [(a, b) for a, b in loops if lo <= a and b <= hi and (a, b) != (lo, hi)]
    body = [op for addr, op, _ in instrs
            if lo <= addr <= hi and not any(a <= addr <= b for a, b in inner)]
    return len(body), collections.Counter(_class(op) for op in body)


def instruction_mix(path: str | None = None) -> dict:
    """The flagship loop's instructions per product, in all and by class, of
    the built library at ``path`` (built first when not given)."""
    path = path or build.build_all(["approx_matmul"])["approx_matmul"]["path"]
    sass = _sass(path)
    funcs = {k: v for k, v in _functions(sass).items() if FLAGSHIP in k}
    if len(funcs) != 1:
        raise RuntimeError(f"expected one flagship instantiation, found {list(funcs)}")
    (name, instrs), = funcs.items()
    n, mix = loop_mix(instrs)
    return {
        "function": name, "instructions_in_function": len(instrs),
        "loop_instructions": n, "products_per_pass": PRODUCTS_PER_PASS,
        "instructions_per_product": n / PRODUCTS_PER_PASS,
        "per_product_by_class": {k: v / PRODUCTS_PER_PASS for k, v in sorted(mix.items())},
    }


def _sass(path: str) -> str:
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                          check=True).stdout


TENSOR_CORE_OPS = ("HMMA", "IMMA", "HGMMA")
# the sources whose tensor-core instructions are counted, and the name every
# counted kernel function of each holds: both routes of K2 and K4 (route A
# ``stream_gemm_kernel``, route B ``mma_gemm_kernel``), both of K5 and K7's
# ``sdpa_kernel``
TENSOR_CORE_KERNELS = {"fused_matmul": "gemm_kernel", "dequant_matmul": "gemm_kernel",
                       "int4_matmul": "int4_", "attention": "sdpa_kernel"}


def tensor_core_mix(paths: dict | None = None) -> dict:
    """``{source: {kernel function: tensor-core instruction count}}`` for the
    kernel functions of :data:`TENSOR_CORE_KERNELS` in the built libraries
    (``paths``: ``{source: library path}``, built first when not given)."""
    paths = paths or {n: v["path"] for n, v in build.build_all(TENSOR_CORE_KERNELS).items()}
    out = {}
    for name, kernel in TENSOR_CORE_KERNELS.items():
        funcs = _functions(_sass(paths[name]))
        out[name] = {fn: sum(op in TENSOR_CORE_OPS for _, op, _ in instrs)
                     for fn, instrs in funcs.items() if kernel in fn}
    return out


def uses_tensor_cores(mix: dict, kernel: str) -> bool:
    """Every counted function whose name holds ``kernel`` (``"mma_gemm"``:
    route B of K2 and K4; ``"int4_"``: both routes of K5; ``"sdpa_kernel"``:
    K7) has tensor-core instructions."""
    counts = [c for funcs in mix.values() for fn, c in funcs.items() if kernel in fn]
    return bool(counts) and min(counts) > 0


def main():
    print(json.dumps(instruction_mix()))
    print(json.dumps(tensor_core_mix()))


if __name__ == "__main__":
    main()
