"""The port stands alone: it imports neither jax nor the JAX package, and
its entry points run on CUDA unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "svt_av1_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "svt_av1_tpu")

_ENCODE = r"""
import sys
import numpy as np
from svt_av1_tpu_torch.api import Encoder
from svt_av1_tpu_torch.config import EncoderConfig, PredStructure
rng = np.random.default_rng(0)
y = rng.integers(0, 256, (144, 224)).astype(np.uint8)
u = np.full((64, 96), 120, np.uint8)
v = np.full((64, 96), 130, np.uint8)
# low-delay P at the smallest size the batched inter plan takes: one key
# frame, then P frames of a moving picture
enc = Encoder(EncoderConfig(source_width=192, source_height=128, qp=40,
                            enc_mode=8, intra_period_length=-1,
                            pred_structure=PredStructure.LOW_DELAY_P),
              device="cpu")
out = []
for i in range(3):
    out += enc.send_picture((np.ascontiguousarray(y[i:i + 128, i:i + 192]),
                             u, v))
out += enc.flush()
assert len(out) == 3 and all(len(p) > 20 for p in out)
# random access: MCTF, TPL, compound and show_existing frames
enc = Encoder(EncoderConfig(source_width=192, source_height=128, qp=40,
                            enc_mode=8, intra_period_length=-1,
                            hierarchical_levels=2), device="cpu")
out = []
for i in range(5):
    out += enc.send_picture((np.ascontiguousarray(y[i:i + 128, i:i + 192]),
                             u, v))
out += enc.flush()
assert len(out) == 7 and enc.frame_count == 5
# the port's decoder on the random-access stream, and the stripe step
from svt_av1_tpu_torch.api import Decoder
dec = Decoder(device="cpu")
shown = [g for g in (dec.decode_frame(p) for p in out) if g is not None]
assert len(shown) == 5
for d, g in enumerate(shown):
    assert all(np.array_equal(g[k], enc.recon_by_display[d][k])
               for k in range(3))
# preset 6: the RD walk, per-64x64 CDEF presets, loop restoration with its
# second entropy pass and the global-motion fit
enc6 = Encoder(EncoderConfig(source_width=192, source_height=128, qp=40,
                             enc_mode=6, intra_period_length=-1,
                             pred_structure=PredStructure.LOW_DELAY_P),
               device="cpu")
p6 = []
for i in range(2):
    p6 += enc6.send_picture((np.ascontiguousarray(y[i:i + 128, i:i + 192]),
                             u, v))
p6 += enc6.flush()
assert len(p6) == 2
from svt_av1_tpu_torch.parallel import stripes
assert stripes.LocalStripes(2).from_above([1, 2]) == [None, 1]
# the command-line app and the host modules of film grain, two-pass and
# the metrics
from svt_av1_tpu_torch import app
from svt_av1_tpu_torch.pipeline import first_pass, noise_model
from svt_av1_tpu_torch.utils import metrics
assert app.main and first_pass.analyze_frame and metrics.frame_psnr
assert noise_model.fit_film_grain(y[:128, :192], seed=1) is not None
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "svt_av1_tpu"))
print("BAD", bad)
"""


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _sources():
    files = sorted(PORT.rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_the_scan_covers_every_package_of_the_port():
    scanned = {p.relative_to(PORT).parts[0] for p in _sources()
               if p.is_relative_to(PORT)}
    assert {"parallel", "pipeline", "ops", "kernels"} <= scanned
    assert PORT / "parallel" / "stripes.py" in _sources()
    assert PORT / "pipeline" / "global_motion.py" in _sources()
    assert {PORT / "app.py", PORT / "pipeline" / "noise_model.py",
            PORT / "pipeline" / "first_pass.py",
            PORT / "utils" / "metrics.py"} <= set(_sources())


# past its subprocess's own 300-s timeout, which names the hang
@pytest.mark.time_limit(360)
def test_port_encode_loads_no_jax_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", _ENCODE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "BAD []"


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), \
            f"{path.name}:{node.lineno} imports {names}"


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from svt_av1_tpu_torch.api import Encoder
    from svt_av1_tpu_torch.config import EncoderConfig, PredStructure
    from svt_av1_tpu_torch.ops import omd

    cfg = EncoderConfig(source_width=64, source_height=64, qp=40,
                        enc_mode=8, intra_period_length=0,
                        pred_structure=PredStructure.LOW_DELAY_P)
    with pytest.raises(RuntimeError, match="CUDA"):
        Encoder(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        omd.intra_decision_frame(torch.zeros(64, 64).numpy(), 64, 64, 100,
                                 1.0, (0.0,) * 13)
    from svt_av1_tpu_torch.api import Decoder, decode_ivf
    from svt_av1_tpu_torch.parallel.dryrun import dryrun_stripes

    with pytest.raises(RuntimeError, match="CUDA"):
        Decoder()
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_ivf("no-such-file.ivf")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_stripes(2, width=256)


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card the script fails before any result; alone in a
    directory (no package beside it) it fails too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd in (ROOT, tmp_path):
        script = ROOT / "chip_smoke.py"
        if cwd == tmp_path:
            (tmp_path / "chip_smoke.py").write_text(script.read_text())
            script = tmp_path / "chip_smoke.py"
        r = subprocess.run([sys.executable, str(script)], cwd=cwd,
                           capture_output=True, text=True, timeout=120,
                           env=dict(os.environ, PYTHONPATH=""))
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
