"""A store of the JAX package's outputs for the port's comparison tests.

The JAX package (svt_av1_tpu/) is frozen: on fixed inputs, with fixed
jax, jaxlib and numpy versions, the streams and arrays it computes are
constants.  The tests of svt_av1_tpu_torch hold the port against them
exactly as before, but read them from ``tests/jax_refs/`` where the
stored entry's key matches:

* the key is the sha256 of the entry's inputs (everything that decides
  the output: the frames' sha256, the configuration's fields, the
  SVT_TPU_DEVICE value the producer runs under), of the test code that
  drives the producer (the module that registers the entry and every
  module of tests/ it imports, transitively) and of the fingerprint;
* the fingerprint is the sha256 of every file under svt_av1_tpu/ (but
  ``__pycache__``) and of the jax, jaxlib and numpy versions.

Anywhere else (no entry, another key, a file whose sha256 is not the
manifest's) ``jax_reference`` runs the producer live: a stale store
costs time, never correctness.  The port's side of every comparison
always runs live.

Each test module registers its entries (``register``) at import, so that
``tools/refresh_jax_refs.py`` and the cross-check tests in
tests/test_jax_refs.py can run every producer without the tests.  A test
reads an entry with ``reference(name, frames=..., ...)``, handing over
the inputs its port side uses: they must be the entry's own.
"""
import ast
import dataclasses
import enum
import fractions
import functools
import hashlib
import importlib
import importlib.metadata
import io
import json
import os
import pathlib
import re
import sys
import tempfile

import numpy as np
import pytest

TESTS = pathlib.Path(__file__).resolve().parent
STORE = TESTS / "jax_refs"
PACKAGE = TESTS.parent / "svt_av1_tpu"
MANIFEST = "manifest.json"
VERSIONS = ("jax", "jaxlib", "numpy")

# name -> function of no arguments returning (inputs, produce)
CASES = {}
# name -> the file of the test module that registered it
MODULES = {}


@functools.lru_cache(maxsize=None)
def fingerprint(package=PACKAGE):
    """sha256 over every file of the JAX package (its path and bytes) and
    the jax, jaxlib and numpy versions."""
    h = hashlib.sha256()
    for path in sorted(package.rglob("*")):
        if path.is_file() and "__pycache__" not in path.parts:
            h.update(path.relative_to(package).as_posix().encode() + b"\0")
            h.update(hashlib.sha256(path.read_bytes()).digest())
    for mod in VERSIONS:
        h.update(f"{mod}={importlib.metadata.version(mod)}\0".encode())
    return h.hexdigest()


def _imports(path, tests):
    """The modules of ``tests`` that the module at ``path`` imports (at
    its top level or inside a function)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_bytes())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return {tests / f"{n}.py" for n in names} & set(tests.glob("*.py"))


def code_modules(path, tests=TESTS):
    """The module at ``path`` and every module of ``tests`` it imports,
    transitively."""
    seen, todo = set(), [pathlib.Path(path)]
    while todo:
        p = todo.pop()
        if p not in seen:
            seen.add(p)
            todo.extend(_imports(p, tests))
    return seen


@functools.lru_cache(maxsize=None)
def code_digest(path, tests=TESTS):
    """sha256 over ``code_modules(path)`` (each one's name and bytes)."""
    h = hashlib.sha256()
    for p in sorted(code_modules(path, tests)):
        h.update(p.name.encode() + b"\0")
        h.update(hashlib.sha256(p.read_bytes()).digest())
    return h.hexdigest()


def _plain(x):
    """``x`` as JSON: arrays as (dtype, shape, sha256), dataclasses as
    their fields, enums by name."""
    if isinstance(x, enum.Enum):
        return f"{type(x).__name__}.{x.name}"
    if isinstance(x, (np.ndarray, np.generic)):
        a = np.ascontiguousarray(x)
        return {"array": [a.dtype.str, list(a.shape),
                          hashlib.sha256(a.tobytes()).hexdigest()]}
    if isinstance(x, (bool, int, str, type(None))):
        return x
    if isinstance(x, float):
        return repr(x)
    if isinstance(x, fractions.Fraction):
        return f"{x.numerator}/{x.denominator}"
    if isinstance(x, bytes):
        return {"bytes": hashlib.sha256(x).hexdigest()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {type(x).__name__: {f.name: _plain(getattr(x, f.name))
                                   for f in dataclasses.fields(x)}}
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    raise TypeError(f"no stored form for {type(x).__name__}")


def entry_key(inputs, fp=None):
    """The key of an entry: sha256 of its inputs and the fingerprint."""
    blob = json.dumps({"inputs": _plain(inputs),
                       "fingerprint": fp or fingerprint()}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def read_manifest(store=STORE):
    try:
        return json.loads((store / MANIFEST).read_text())
    except (OSError, ValueError):
        return {"fingerprint": None, "entries": {}}


def read_entry(entry, store=STORE):
    """The output a manifest record names, if its bytes are the record's;
    else None."""
    path = store / entry["file"]
    try:
        data = path.read_bytes()
    except OSError:
        return None
    if hashlib.sha256(data).hexdigest() != entry["sha256"]:
        return None
    if path.suffix == ".npz":
        with np.load(io.BytesIO(data), allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    return data


def live(produce):
    """Run ``produce``: bytes, or a dict of arrays."""
    out = produce()
    if isinstance(out, bytes):
        return out
    if isinstance(out, dict):
        return {str(k): np.asarray(v) for k, v in out.items()}
    raise TypeError(f"a producer returns bytes or a dict of arrays, "
                    f"not {type(out).__name__}")


def jax_reference(name, inputs, produce, store=STORE):
    """The JAX package's output ``name``: the stored entry where its key
    (``inputs`` and the fingerprint) and its bytes match the manifest,
    else ``produce()`` run live."""
    entry = read_manifest(store)["entries"].get(name)
    got = None
    if entry is not None and entry["key"] == entry_key(inputs):
        got = read_entry(entry, store)
    return live(produce) if got is None else got


def register(name, case):
    """Register ``case`` (no arguments -> ``(inputs, produce)``) as the
    entry ``name`` of the test module whose import calls this; returns
    ``name``."""
    if not re.fullmatch(r"[A-Za-z0-9_.-]+", name):
        raise ValueError(f"entry name {name!r}: letters, digits, _ . -")
    frame = sys._getframe(1)
    while frame.f_code.co_name != "<module>":
        frame = frame.f_back
    CASES.setdefault(name, case)
    MODULES.setdefault(name,
                       pathlib.Path(frame.f_code.co_filename).resolve())
    return name


def load_cases():
    """Import every tests/test_torch_*.py module, each of which registers
    its entries; returns CASES."""
    for path in sorted(STORE.parent.glob("test_torch_*.py")):
        importlib.import_module(path.stem)
    return CASES


def keyed_case(name):
    """(inputs, produce) of the registered entry ``name``, its inputs with
    the digest of the test code that drives it (``code_digest``)."""
    inputs, produce = CASES[name]()
    return dict(inputs, test_code=code_digest(MODULES[name])), produce


def reference(name, **same):
    """``jax_reference`` of the registered entry ``name``.  Each keyword
    is an input the test's port side uses, which must be the entry's
    input of that name (``inputs[key]``), or the test fails."""
    inputs, produce = keyed_case(name)
    for key, value in same.items():
        if _plain(value) != _plain(inputs[key]):
            raise AssertionError(f"{name}: the port side's {key} is not "
                                 f"the JAX entry's")
    return jax_reference(name, inputs, produce)


def write_entry(name, inputs, output, seconds, store=STORE, fp=None):
    """Store ``output`` as ``name``; returns its manifest record."""
    if isinstance(output, bytes):
        path, data = store / f"{name}.bin", output
    else:
        buf = io.BytesIO()
        np.savez_compressed(buf, **output)
        path, data = store / f"{name}.npz", buf.getvalue()
    path.write_bytes(data)
    return {"key": entry_key(inputs, fp), "file": path.name,
            "sha256": hashlib.sha256(data).hexdigest(),
            "seconds": round(seconds, 1)}


def write_manifest(entries, store=STORE, fp=None):
    manifest = {"fingerprint": fp or fingerprint(),
                "versions": {m: importlib.metadata.version(m)
                             for m in VERSIONS},
                "entries": dict(sorted(entries.items()))}
    (store / MANIFEST).write_text(json.dumps(manifest, indent=1) + "\n")


# --------------------------------------------------------------------------
# the producers most tests share
# --------------------------------------------------------------------------

def encode_case(frames, ref_cfg, device="1"):
    """(inputs, produce) of the JAX package's stream of ``frames`` under
    ``ref_cfg``: ``api.encode_ivf`` with SVT_TPU_DEVICE=``device``."""
    def produce():
        from svt_av1_tpu import api as ref_api

        with tempfile.TemporaryDirectory() as tmp, \
                pytest.MonkeyPatch.context() as mp:
            mp.setenv("SVT_TPU_DEVICE", device)
            path = os.path.join(tmp, "ref.ivf")
            ref_api.encode_ivf(frames, ref_cfg, path)
            return pathlib.Path(path).read_bytes()

    return dict(frames=frames, cfg=ref_cfg, device=device), produce


def on_device(device, fn, *args, **kw):
    """``fn(*args, **kw)`` with SVT_TPU_DEVICE=``device``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SVT_TPU_DEVICE", device)
        return fn(*args, **kw)


def pack_list(arrays):
    """A list of arrays as a dict (``unpack_list`` inverts it)."""
    return {str(i): np.asarray(a) for i, a in enumerate(arrays)}


def unpack_list(got):
    return [got[str(i)] for i in range(len(got))]


def pack_dict(d, prefix):
    """A dict of numbers as two arrays named ``prefix``_keys and _values
    (``unpack_dict`` inverts it, to Python numbers)."""
    return {f"{prefix}_keys": np.array(list(d)),
            f"{prefix}_values": np.array(list(d.values()))}


def unpack_dict(got, prefix):
    return dict(zip(got[f"{prefix}_keys"].tolist(),
                    got[f"{prefix}_values"].tolist()))


def pack_packets(pkts):
    """A list of packets as arrays (``unpack_packets`` inverts it)."""
    return dict(packets=np.frombuffer(b"".join(pkts), np.uint8),
                sizes=np.array([len(p) for p in pkts], np.int64))


def unpack_packets(got):
    data, ends = got["packets"].tobytes(), np.cumsum(got["sizes"])
    return [data[e - n:e] for e, n in zip(ends.tolist(),
                                          got["sizes"].tolist())]
