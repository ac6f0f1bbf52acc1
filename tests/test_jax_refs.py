"""The store of the JAX package's outputs (tests/jax_refs.py).

Unit tests of ``jax_reference`` and ``reference`` with fake producers on
a store of their own; the reach of the fingerprint and of the test code
in a key; the committed store against the JAX package and the tests as
they are now: its fingerprint current, every registered entry stored
under its current key, and the cheapest entry equal to a live run of its
producer (every entry under ``slow``).
"""
import shutil

import numpy as np
import pytest

import jax_refs


def _never():
    raise AssertionError("the producer ran where the entry matched")


def _store(tmp_path, name, inputs, output, fp=None):
    rec = jax_refs.write_entry(name, inputs, output, 0.5, tmp_path, fp)
    jax_refs.write_manifest({name: rec}, tmp_path)
    return tmp_path / rec["file"]


def _live(out):
    calls = []

    def produce():
        calls.append(1)
        return out

    return produce, calls


FRAMES = [tuple(np.full((4, 4), v + p, np.uint8) for p in range(3))
          for v in (10, 20)]
INPUTS = dict(frames=FRAMES, cfg={"qp": 40, "enc_mode": 8}, device="1")


def _same(got, want):
    if isinstance(want, bytes):
        return got == want
    return got.keys() == want.keys() and all(
        got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
        for k in want)


@pytest.mark.parametrize("output", [
    b"\x12\x00\x0a\x0bstream",
    {"plane0": np.arange(12, dtype=np.uint16).reshape(3, 4),
     "mv": np.array([-3, 5], np.int32)}], ids=["bytes", "arrays"])
def test_matching_key_and_fingerprint_serve_the_entry(tmp_path, output):
    _store(tmp_path, "fake.case", INPUTS, output)
    got = jax_refs.jax_reference("fake.case", INPUTS, _never, tmp_path)
    assert type(got) is type(output) and _same(got, output)


def _changed_frames():
    frames = [tuple(p.copy() for p in f) for f in FRAMES]
    frames[1][0][3, 3] += 1
    return dict(INPUTS, frames=frames)


@pytest.mark.parametrize("change", [
    "frames", "frames_dtype", "config", "device", "fingerprint", "missing",
    "other_name", "no_manifest"])
def test_changed_input_fingerprint_or_missing_entry_runs_live(tmp_path,
                                                              change):
    inputs, fp, name = INPUTS, None, "fake.case"
    if change == "frames":
        inputs = _changed_frames()
    elif change == "frames_dtype":
        inputs = dict(INPUTS, frames=[tuple(p.astype(np.uint16) for p in f)
                                      for f in FRAMES])
    elif change == "config":
        inputs = dict(INPUTS, cfg={"qp": 41, "enc_mode": 8})
    elif change == "device":
        inputs = dict(INPUTS, device="0")
    elif change == "fingerprint":
        fp = "0" * 64
    elif change == "other_name":
        name = "fake.other"
    path = _store(tmp_path, "fake.case", INPUTS, b"stored", fp)
    if change == "missing":
        path.unlink()
    elif change == "no_manifest":
        (tmp_path / jax_refs.MANIFEST).unlink()
    produce, calls = _live(b"live")
    assert jax_refs.jax_reference(name, inputs, produce, tmp_path) == b"live"
    assert calls == [1]


@pytest.mark.parametrize("output", [b"0123456789abcdef" * 4, {
    "a": np.arange(64, dtype=np.int64)}], ids=["bytes", "arrays"])
def test_corrupted_entry_is_not_served(tmp_path, output):
    path = _store(tmp_path, "fake.case", INPUTS, output)
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xff
    path.write_bytes(bytes(data))
    produce, calls = _live(output)
    got = jax_refs.jax_reference("fake.case", INPUTS, produce, tmp_path)
    assert calls == [1] and _same(got, output)


def test_inputs_take_dataclasses_enums_and_fractions():
    """Two configurations that differ in one field, an enum or a frame
    rate key differently; equal ones key alike."""
    from fractions import Fraction

    from svt_av1_tpu.config import EncoderConfig, PredStructure

    def cfg(**kw):
        return EncoderConfig(source_width=64, source_height=64, **kw)

    keys = {jax_refs.entry_key(dict(cfg=c), "f") for c in (
        cfg(), cfg(qp=41), cfg(pred_structure=PredStructure.LOW_DELAY_P),
        cfg(frame_rate=Fraction(25)))}
    assert len(keys) == 4
    assert jax_refs.entry_key(dict(cfg=cfg()), "f") == \
        jax_refs.entry_key(dict(cfg=cfg()), "f")


def test_fingerprint_covers_every_file_of_the_jax_package(tmp_path):
    """A copy of svt_av1_tpu/ has the package's fingerprint; a changed byte
    in any file changes it, a new file too; __pycache__ does not."""
    copy = tmp_path / "svt_av1_tpu"
    shutil.copytree(jax_refs.PACKAGE, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    fp = jax_refs.fingerprint(copy)
    assert fp == jax_refs.fingerprint()
    (copy / "__pycache__").mkdir()
    (copy / "__pycache__" / "api.cpython-312.pyc").write_bytes(b"x")
    assert jax_refs.fingerprint.__wrapped__(copy) == fp
    files = sorted(p for p in copy.rglob("*") if p.is_file()
                   and "__pycache__" not in p.parts)
    for path in (files[0], files[len(files) // 2], files[-1]):
        data = path.read_bytes()
        path.write_bytes(data[:-1] + bytes([data[-1] ^ 1]))
        assert jax_refs.fingerprint.__wrapped__(copy) != fp, path
        path.write_bytes(data)
    (copy / "ops" / "new.py").write_text("")
    assert jax_refs.fingerprint.__wrapped__(copy) != fp


def test_test_code_covers_the_module_and_what_it_imports(tmp_path):
    """An entry's test code is its module and every module of tests/ it
    imports, at the top or in a function, transitively: a changed byte
    in any of them changes it; another module and a package outside
    tests/ do not."""
    files = {"test_a.py": "import numpy\nimport helper_b\n",
             "helper_b.py": "def f():\n    from helper_c import g\n",
             "helper_c.py": "import os.path\nG = 1\n",
             "helper_d.py": "D = 1\n"}
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    top = tmp_path / "test_a.py"
    assert {p.name for p in jax_refs.code_modules(top, tmp_path)} == {
        "test_a.py", "helper_b.py", "helper_c.py"}
    code = jax_refs.code_digest.__wrapped__(top, tmp_path)
    (tmp_path / "helper_d.py").write_text("D = 2\n")
    assert jax_refs.code_digest.__wrapped__(top, tmp_path) == code
    for name in ("test_a.py", "helper_b.py", "helper_c.py"):
        text = files[name]
        (tmp_path / name).write_text(text + "# edited\n")
        assert jax_refs.code_digest.__wrapped__(top, tmp_path) != code, name
        (tmp_path / name).write_text(text)
    assert jax_refs.code_digest.__wrapped__(top, tmp_path) == code


def test_an_entry_keys_on_the_module_that_registers_it():
    """An entry registered through a helper of another module belongs to
    the module whose import registered it, and its test code takes in
    the helper's module."""
    jax_refs.load_cases()
    path = jax_refs.MODULES["film_grain.low-delay-p"]
    assert path == jax_refs.TESTS / "test_torch_film_grain.py"
    assert {"test_torch_presets_7.py", "jax_refs.py", "test_e2e.py"} <= {
        p.name for p in jax_refs.code_modules(path)}
    inputs, _ = jax_refs.keyed_case("film_grain.low-delay-p")
    assert inputs["test_code"] == jax_refs.code_digest(path)


def test_reference_holds_the_port_side_s_inputs_to_the_entry_s(
        monkeypatch):
    """``reference(name, frames=...)`` serves the entry only for the
    frames its producer takes; other frames fail before it runs."""
    produce, calls = _live(b"live")
    monkeypatch.setitem(jax_refs.CASES, "fake.same",
                        lambda: (INPUTS, produce))
    monkeypatch.setitem(jax_refs.MODULES, "fake.same",
                        jax_refs.TESTS / "test_jax_refs.py")
    assert jax_refs.reference("fake.same", frames=FRAMES,
                              device="1") == b"live"
    assert calls == [1]
    with pytest.raises(AssertionError, match="port side's frames"):
        jax_refs.reference("fake.same", frames=_changed_frames()["frames"])
    assert calls == [1]


def test_stored_fingerprint_is_the_jax_package_s():
    """The store was made from this JAX package and these jax, jaxlib and
    numpy versions; else run tools/refresh_jax_refs.py."""
    assert jax_refs.read_manifest()["fingerprint"] == jax_refs.fingerprint()


def test_every_registered_entry_is_stored_with_its_inputs():
    """Each test's JAX inputs and test code are the ones stored (keyed
    with the stored fingerprint); else its JAX side runs live, slowly,
    until tools/refresh_jax_refs.py is run."""
    cases = jax_refs.load_cases()
    manifest = jax_refs.read_manifest()
    entries = manifest["entries"]
    assert sorted(entries) == sorted(cases)
    stale = [n for n in cases if entries[n]["key"] != jax_refs.entry_key(
        jax_refs.keyed_case(n)[0], manifest["fingerprint"])]
    assert not stale, f"tools/refresh_jax_refs.py --stale: {stale}"


def _check_live(name):
    """The stored output of ``name`` equals its producer's, run now."""
    want = jax_refs.read_entry(jax_refs.read_manifest()["entries"][name])
    assert want is not None, name
    got = jax_refs.live(jax_refs.load_cases()[name]()[1])
    assert type(got) is type(want) and _same(got, want), name


def test_cheapest_entry_equals_the_live_jax_package():
    """The device-path entry whose producer took the least time (its
    jitted programs compiled on the CPU), run live now."""
    entries = jax_refs.read_manifest()["entries"]
    cases = jax_refs.load_cases()

    def device_path(name):
        inputs = cases[name]()[0]
        return inputs.get("device") == "1" or inputs.get("use_jax") is True

    name = min(filter(device_path, entries),
               key=lambda n: (entries[n]["seconds"], n))
    assert entries[name]["seconds"] <= 30
    _check_live(name)


# every producer live: 5,645 s of producer time, four at a time on 8 cores
@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(
    jax_refs.read_manifest()["entries"]))
def test_every_entry_equals_the_live_jax_package(name):
    _check_live(name)
