"""What nvcc makes of the port's CUDA kernels on sm_90a.

    python3 tools/kernel_sass.py [kernel ...]

Needs the CUDA toolkit (nvcc, cuobjdump); no card.  Prints:

1. ``-Xptxas -v`` for each named kernel source (default: intra_decision,
   me_refine, inter_select and cdef_filter): registers, spills and
   shared memory per entry;
2. the SASS opcode histogram of each of their entries;
3. the SASS of five exact forms of "accumulate the sum of the four
   absolute byte differences of two words" (K6's inner operation):
   ``__vsadu4``, PTX ``vabsdiff4.u32.u32.u32.add`` with the accumulator
   as its third operand, ``__vabsdiffu4`` + ``__dp4a``, ``__vmaxu4 - __vminu4``
   + ``__dp4a``, and four ``__sad`` on single bytes, with the opcode
   count of each.

The objects go to the build directory (build/torch_kernels/sass/).
"""
from __future__ import annotations

import collections
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from svt_av1_tpu_torch.kernels import build  # noqa: E402

ARCH = "-gencode=arch=compute_90a,code=sm_90a"

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


def opcode(ins: str) -> str:
    ins = re.sub(r"^@!?U?P\w+\s+", "", ins)
    return ins.split()[0] if ins else ""


def main() -> int:
    nvcc = build._nvcc()
    names = sys.argv[1:] or ["intra_decision", "me_refine", "inter_select",
                             "cdef_filter"]
    out_dir = build.BUILD_DIR / "sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in names:
        src = build.CSRC_DIR / build.CUDA_SOURCES[name]
        cubin = out_dir / f"{name}.cubin"
        print(f"== {name}: ptxas")
        print(run([nvcc, "-O3", "-std=c++17", ARCH, "-cubin", "-Xptxas", "-v",
                   "-I", str(build.CSRC_DIR), str(src), "-o", str(cubin)]))
        for fn, lines in sass_by_function(cubin).items():
            hist = collections.Counter(opcode(x) for x in lines)
            print(f"== {name}: {fn}: {len(lines)} instructions")
            print("   " + ", ".join(f"{k} {v}" for k, v in hist.most_common()))
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
