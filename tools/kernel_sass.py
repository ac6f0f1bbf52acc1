"""What nvcc makes of the port's CUDA kernels on sm_90a.

    python3 tools/kernel_sass.py [kernel ...]

Needs the CUDA toolkit (nvcc, cuobjdump); no card.  Prints:

1. ``-Xptxas -v`` for each named kernel source (default: intra_decision,
   me_refine, inter_select, cdef_filter, subpel_refine, compound_joint,
   me_coarse, deblock, cdef_direction and block_var16): registers,
   spills and shared memory per entry, and then one line per entry with
   its demangled name (each template instantiation apart: K4's
   frame-level search and apply beside its per-fb forms);
2. the SASS opcode histogram of each of their entries, and apart the
   packed-integer opcodes the redesigns rest on (every opcode that
   starts with VABSDIFF, IDP (dp4a and dp2a) or PRMT) and the branches
   and shared-memory atomics (BRA, BSSY, BSYNC, WARPSYNC, ATOMS); the
   kernels with a 16-bit form (K1, K4's search, K5-K10) list the entries
   of both template instantiations (uint8_t and uint16_t; K6's 16-bit
   form is a kernel of its own, me_refine16_kernel);
3. the SASS of five exact forms of "accumulate the sum of the four
   absolute byte differences of two words" (K6's inner operation):
   ``__vsadu4``, PTX ``vabsdiff4.u32.u32.u32.add`` with the accumulator
   as its third operand, ``__vabsdiffu4`` + ``__dp4a``, ``__vmaxu4 - __vminu4``
   + ``__dp4a``, and four ``__sad`` on single bytes, with the opcode
   count of each; and of three forms of the 16-bit forms' "two absolute
   differences of 16-bit halves": ``__vabsdiffu2`` added as packed halves,
   PTX ``vabsdiff2.u32.u32.u32.add``, two ``__sad`` on the halves, PTX
   ``vabsdiff.u32.u32.u32.add`` with the ``.h0`` and ``.h1`` selectors,
   and ``__vmaxu2 - __vminu2`` added as packed halves (no half borrows,
   since the maximum is at least the minimum in each); and of K9's
   rounded-up averages, ``__vavgu4`` (its 8-bit form) and two 16-bit
   ones, ``__vavgu2`` and ``(a | b) - (((a ^ b) >> 1) & 0x7fff7fff)``.

The objects go to the build directory (build/torch_kernels/sass/).
"""
from __future__ import annotations

import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from svt_av1_tpu_torch.kernels import build  # noqa: E402

ARCH = "-gencode=arch=compute_90a,code=sm_90a"
PACKED_OPCODES = ("VABSDIFF", "IDP", "PRMT")
CONTROL_OPCODES = ("BRA", "BSSY", "BSYNC", "WARPSYNC", "ATOMS")

SAD_PROBE = r"""
#include <stdint.h>
#define PROBE(name, expr)                                                  \
  extern "C" __global__ void name(const uint32_t* a, const uint32_t* b,    \
                                  uint32_t* o) {                           \
    const int i = threadIdx.x;                                             \
    const uint32_t x = a[i], y = b[i];                                     \
    uint32_t acc = o[i];                                                   \
    acc = expr;                                                            \
    o[i] = acc;                                                            \
  }
PROBE(sad_vsadu4, __vsadu4(x, y) + acc)
__device__ __forceinline__ uint32_t vabsdiff4_add(uint32_t a, uint32_t b,
                                                  uint32_t c) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(d)
      : "r"(a), "r"(b), "r"(c));
  return d;
}
PROBE(sad_ptx_vabsdiff4_add, vabsdiff4_add(x, y, acc))
PROBE(sad_vabsdiff_dp4a, (uint32_t)__dp4a(__vabsdiffu4(x, y), 0x01010101u,
                                          acc))
PROBE(sad_maxmin_dp4a, (uint32_t)__dp4a(__vmaxu4(x, y) - __vminu4(x, y),
                                        0x01010101u, acc))
PROBE(sad_bytes, __sad(x & 255, y & 255,
                       __sad((x >> 8) & 255, (y >> 8) & 255,
                             __sad((x >> 16) & 255, (y >> 16) & 255,
                                   __sad(x >> 24, y >> 24, acc)))))
__device__ __forceinline__ uint32_t vabsdiff2_add(uint32_t a, uint32_t b,
                                                  uint32_t c) {
  uint32_t d;
  asm("vabsdiff2.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(d)
      : "r"(a), "r"(b), "r"(c));
  return d;
}
PROBE(sad16_vabsdiffu2_packed, acc + __vabsdiffu2(x, y))
PROBE(sad16_ptx_vabsdiff2_add, vabsdiff2_add(x, y, acc))
PROBE(sad16_halves, __sad(x & 0xffff, y & 0xffff, __sad(x >> 16, y >> 16,
                                                        acc)))
__device__ __forceinline__ uint32_t vabsdiff_h(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d, e;
  asm("vabsdiff.u32.u32.u32.add %0, %1.h0, %2.h0, %3;" : "=r"(d)
      : "r"(a), "r"(b), "r"(c));
  asm("vabsdiff.u32.u32.u32.add %0, %1.h1, %2.h1, %3;" : "=r"(e)
      : "r"(a), "r"(b), "r"(d));
  return e;
}
PROBE(sad16_ptx_vabsdiff_h0_h1, vabsdiff_h(x, y, acc))
PROBE(sad16_vmaxu2_vminu2_packed, acc + (__vmaxu2(x, y) - __vminu2(x, y)))
PROBE(avg8_vavgu4, acc + __vavgu4(x, y))
PROBE(avg16_vavgu2, acc + __vavgu2(x, y))
PROBE(avg16_or_minus_half_xor,
      acc + ((x | y) - (((x ^ y) >> 1) & 0x7fff7fffu)))
"""


def run(cmd):
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)}\n{r.stderr[-4000:]}")
    return r.stdout + r.stderr


def sass_by_function(cubin: Path) -> dict:
    """{function name: [SASS instruction lines]} of a cubin."""
    cuobjdump = str(Path(build._nvcc()).with_name("cuobjdump"))
    out = run([cuobjdump, "-sass", str(cubin)])
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            funcs[name].append(line.split("*/", 1)[1].strip().rstrip(" ;"))
    return funcs


def ptxas_entries(report: str) -> list:
    """[(registers, spill store bytes, spill load bytes, demangled entry)]
    from ptxas's -v report."""
    rows, name, spills = [], None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((int(m.group(1)), *spills, name))
            name = None
    cufilt = Path(build._nvcc()).with_name("cu++filt")
    demangle = str(cufilt) if cufilt.exists() else shutil.which("c++filt")
    if not rows or not demangle:
        return rows
    names = run([demangle, *(r[3] for r in rows)]).splitlines()
    return [(*r[:3], n) for r, n in zip(rows, names)]


def opcode(ins: str) -> str:
    ins = re.sub(r"^@!?U?P\w+\s+", "", ins)
    return ins.split()[0] if ins else ""


def main() -> int:
    nvcc = build._nvcc()
    names = sys.argv[1:] or ["intra_decision", "me_refine", "inter_select",
                             "cdef_filter", "subpel_refine",
                             "compound_joint", "me_coarse", "deblock",
                             "cdef_direction", "block_var16"]
    out_dir = build.BUILD_DIR / "sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in names:
        src = build.CSRC_DIR / build.CUDA_SOURCES[name]
        cubin = out_dir / f"{name}.cubin"
        print(f"== {name}: ptxas")
        report = run([nvcc, "-O3", "-std=c++17", ARCH, "-cubin", "-Xptxas",
                      "-v", "-I", str(build.CSRC_DIR), str(src), "-o",
                      str(cubin)])
        print(report)
        for regs, st, ld, entry in ptxas_entries(report):
            print(f"== {name}: {regs} registers, {st} B spill stores, {ld} "
                  f"B spill loads: {entry}")
        for fn, lines in sass_by_function(cubin).items():
            hist = collections.Counter(opcode(x) for x in lines)
            print(f"== {name}: {fn}: {len(lines)} instructions")
            print("   " + ", ".join(f"{k} {v}" for k, v in hist.most_common()))
            packed = {k: v for k, v in hist.items()
                      if k.startswith(PACKED_OPCODES)}
            print(f"   packed-integer opcodes: {packed}")
            control = {k: v for k, v in hist.items()
                       if k.startswith(CONTROL_OPCODES)}
            print(f"   branches and shared atomics: {control}")
    probe = out_dir / "sad_probe.cu"
    probe.write_text(SAD_PROBE)
    cubin = out_dir / "sad_probe.cubin"
    run([nvcc, "-O3", ARCH, "-cubin", str(probe), "-o", str(cubin)])
    for fn, lines in sass_by_function(cubin).items():
        body = [x for x in lines if not opcode(x).startswith(
            ("S2R", "LDG", "STG", "EXIT", "BRA", "NOP", "MOV", "LDC",
             "ULDC", "IMAD.WIDE"))]
        print(f"== probe {fn}: {len(body)} instructions besides loads, "
              f"stores and addressing")
        for x in body:
            print("   " + x)
    return 0


if __name__ == "__main__":
    sys.exit(main())
