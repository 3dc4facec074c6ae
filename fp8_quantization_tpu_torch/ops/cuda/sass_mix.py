"""Instruction mix of K3's main loop, read from the compiled SASS.

    python -m fp8_quantization_tpu_torch.ops.cuda.sass_mix

Builds ``csrc/approx_matmul.cu`` (as :mod:`.build` does), disassembles it
with the toolkit's ``cuobjdump -sass``, takes the flagship instantiation
(``with_approx`` and ``quant_btw_mult_accu`` on, no clip, no s2nn2s), finds
its K-slice loop (the widest backward branch) and counts the instructions in
it by class. One pass of that loop does ``BK * RM * RN`` products per
thread, so the count per product, staging included, is the loop's length
over that; it feeds the kernel's operation bound. Prints one JSON object.
Needs the CUDA toolkit, so it runs on the GPU machine only.
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
PRODUCTS_PER_PASS = 16 * 4 * 4
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
    """Instructions of the widest backward branch's loop, counted by class."""
    loops = []
    for addr, op, text in instrs:
        target = re.search(r"0x([0-9a-f]+)", text) if op == "BRA" else None
        if target and int(target.group(1), 16) < addr:
            loops.append((int(target.group(1), 16), addr))
    if not loops:
        raise RuntimeError("no backward branch: the K-slice loop was not found")
    lo, hi = max(loops, key=lambda span: span[1] - span[0])
    body = [op for addr, op, _ in instrs if lo <= addr <= hi]
    return len(body), collections.Counter(_class(op) for op in body)


def instruction_mix(path: str | None = None) -> dict:
    """The flagship loop's instructions per product, in all and by class, of
    the built library at ``path`` (built first when not given)."""
    path = path or build.build_all(["approx_matmul"])["approx_matmul"]["path"]
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
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


def main():
    print(json.dumps(instruction_mix()))


if __name__ == "__main__":
    main()
