"""The card's integer issue rates: lanes of one opcode per SM per clock.

    python3 tools/int_pipes.py [--iters N]

Builds tools/int_pipes.cu with nvcc for sm_90a into the build directory
(build/torch_kernels/, as the kernels are built), runs each probe on one
block of 1024 threads per SM and prints one JSON line: the card's name
and power limit, the SM count, the SM clock the probes ran at (clock64
cycles over event time), and per probe the lanes per SM and clock of each
of its opcodes, with the opcode counts of its SASS (cuobjdump) beside.
The probes: VIMNMX.U16x2 (``__vminu2``), IADD3, VABSDIFF4 with
accumulate, PRMT, LOP3, SHF, IDP.2A, IMAD alone, and three mixes: two
VIMNMX.U16x2 and one IADD3 (K6's sum of two words' minima), one
VIMNMX.U16x2 and one IDP.2A, one VIMNMX.U16x2 and one VABSDIFF4.
``per_s_at_1.98GHz`` is each rate over the 132 SMs at the clock the
repo's bounds assume (chip_smoke.PEAK_LANE_INSTR_S: 128 lanes per SM and
clock, 33.45e12/s).  Needs a CUDA card.
"""
from __future__ import annotations

import collections
import ctypes
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

from svt_av1_tpu_torch.kernels import build  # noqa: E402

# (name, {SASS opcode prefix: instances per round of 8 chains})
OPS = (
    ("VIMNMX.U16x2", {"VIMNMX": 8}),
    ("IADD3", {"IADD3": 8}),
    ("VABSDIFF4", {"VABSDIFF4": 8}),
    ("PRMT", {"PRMT": 8}),
    ("LOP3", {"LOP3": 8}),
    ("SHF", {"SHF": 8}),
    ("IDP.2A", {"IDP": 8}),
    ("IMAD", {"IMAD": 8}),
    ("2 VIMNMX.U16x2 + IADD3", {"VIMNMX": 8, "IADD3": 4}),
    ("VIMNMX.U16x2 + IDP.2A", {"VIMNMX": 8, "IDP": 8}),
    ("VIMNMX.U16x2 + VABSDIFF4", {"VIMNMX": 4, "VABSDIFF4": 4}),
)
THREADS, ROUNDS = 1024, 4
CLOCK_GHZ, N_SM_H100 = 1.98, 132


def build_lib() -> Path:
    src = HERE / "int_pipes.cu"
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    out = build.BUILD_DIR / f"int_pipes-{build._digest([src], flags)}.so"
    nvcc = build._nvcc()
    return build._build_locked(out, lambda tmp: [nvcc, *flags, str(src),
                                                 "-o", str(tmp)])


def sass_counts(lib: Path) -> list:
    """Per probe (OPS order), its SASS opcode counts (the loop body's
    opcodes are 4 rounds' worth)."""
    from kernel_sass import opcode, sass_by_function

    funcs = sass_by_function(lib)
    out = []
    for op in range(len(OPS)):
        body = next(v for k, v in funcs.items()
                    if "int_pipe_probe" in k and f"ILi{op}E" in k)
        out.append(dict(collections.Counter(opcode(x) for x in body)))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("int_pipes: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    iters = int(args[args.index("--iters") + 1]) if "--iters" in args \
        else 4096
    lib_path = build_lib()
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.int_pipes_run
    fn.restype = ctypes.c_int
    fn.argtypes = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.POINTER(ctypes.c_float))
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator().manual_seed(1)
    x = torch.randint(0, 1 << 31, (4096 + 32,), generator=gen,
                      dtype=torch.int64).to(torch.int32).to(dev)
    out = torch.empty(n_sm * THREADS, dtype=torch.int32, device=dev)
    cycles = torch.empty(n_sm, dtype=torch.int64, device=dev)
    smem = 160 * 1024           # one block per SM
    counts = sass_counts(lib_path)
    rates, clocks = {}, []
    for op, (name, per_round) in enumerate(OPS):
        ms = ctypes.c_float()
        for _ in range(2):      # the first launch warms up
            err = fn(op, x.data_ptr(), out.data_ptr(), cycles.data_ptr(),
                     iters, n_sm, smem, ctypes.byref(ms))
            if err:
                raise RuntimeError(f"probe {name}: CUDA error {err}")
        cyc = int(cycles.max().item())
        clocks.append(cyc / (ms.value * 1e-3) / 1e9)
        rounds = THREADS * iters * ROUNDS
        rates[name] = {
            "lanes_per_sm_clock": {k: rounds * v / cyc
                                   for k, v in per_round.items()},
            "per_s_at_1.98GHz": {k: rounds * v / cyc * N_SM_H100
                                 * CLOCK_GHZ * 1e9
                                 for k, v in per_round.items()},
            "sass": {k: v for k, v in counts[op].items()
                     if k.split(".")[0] in ("VIMNMX", "IADD3", "VABSDIFF4",
                                            "PRMT", "LOP3", "SHF", "IDP",
                                            "IMAD")},
            "cycles": cyc, "ms": ms.value}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "sm_count": n_sm,
                      "clock_ghz": sorted(clocks)[len(clocks) // 2],
                      "iters": iters, "rates": rates}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
