"""Rebuild tests/jax_refs/, the store of the JAX package's outputs that the
port's comparison tests read (tests/jax_refs.py).

Every tests/test_torch_*.py module registers its entries when it is
imported.  This tool runs each entry's producer live in a process of its
own with the test suite's environment (tests/conftest.py: JAX on the CPU
backend with 8 virtual devices), writes the entry files and rewrites the
manifest with the current fingerprint after each entry.  Run it after any
change to svt_av1_tpu/, to the jax, jaxlib or numpy versions, to a test's
JAX inputs or to a test module that registers entries (or one it
imports); tests/test_jax_refs.py fails until then.

    python tools/refresh_jax_refs.py [-j JOBS] [--stale] [NAME ...]

NAMEs rebuild only those entries, ``--stale`` only the entries whose key
no longer matches (an interrupted run resumes so); the other entries stay
where their key still matches.  ``-j`` runs JOBS producers at a time;
one takes up to about 10 GiB while XLA compiles a 33-frame stream.
"""
import argparse
import concurrent.futures
import importlib
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"


def load():
    """Import conftest (the suite's environment) and every port test
    module; returns the jax_refs module with its registry filled."""
    for p in (str(ROOT), str(TESTS)):
        if p not in sys.path:
            sys.path.insert(0, p)
    # tests/ comes first: its conftest.py sets JAX's environment
    importlib.import_module("conftest")
    refs = importlib.import_module("jax_refs")
    refs.load_cases()
    return refs


def current(refs, name, record):
    """Whether ``record`` is still the entry of ``name``."""
    return (record is not None
            and record["key"] == refs.entry_key(refs.keyed_case(name)[0])
            and (refs.STORE / record["file"]).is_file())


def build(name):
    """Run the producer of ``name`` live and store its output; prints its
    manifest record as the last line."""
    refs = load()
    inputs, produce = refs.keyed_case(name)
    t0 = time.perf_counter()
    out = refs.live(produce)
    rec = refs.write_entry(name, inputs, out, time.perf_counter() - t0)
    print(json.dumps(rec))


def build_in_child(name):
    r = subprocess.run([sys.executable, __file__, "--entry", name],
                       capture_output=True, text=True)
    if r.returncode:
        return None, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1]), None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", help="entries to rebuild")
    ap.add_argument("-j", "--jobs", type=int, default=1)
    ap.add_argument("--stale", action="store_true",
                    help="rebuild only the entries whose key changed")
    ap.add_argument("--entry", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.entry:
        build(args.entry)
        sys.stdout.flush()
        # a random-access encoder's lookahead threads can abort the
        # interpreter's shutdown (SIGABRT) after the entry is written
        os._exit(0)
    refs = load()
    unknown = sorted(set(args.names) - set(refs.CASES))
    if unknown:
        ap.error(f"no such entries: {unknown}")
    refs.STORE.mkdir(exist_ok=True)
    old = refs.read_manifest()["entries"]
    entries = {n: r for n, r in old.items()
               if n in refs.CASES and current(refs, n, r)}
    if args.names:
        todo = list(args.names)
    elif args.stale:
        todo = [n for n in refs.CASES if n not in entries]
    else:
        todo = list(refs.CASES)
    # the longest first, by the last refresh's times
    todo.sort(key=lambda n: -old.get(n, {}).get("seconds", 1e9))
    failed = []
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        runs = {pool.submit(build_in_child, n): n for n in todo}
        for run in concurrent.futures.as_completed(runs):
            name = runs[run]
            rec, err = run.result()
            if rec is None:
                failed.append(name)
                entries.pop(name, None)
                print(f"{name}: FAILED\n{err}", flush=True)
                continue
            entries[name] = rec
            refs.write_manifest(entries)
            print(f"{name}: {rec['file']} {rec['seconds']} s", flush=True)
    keep = {r["file"] for r in entries.values()} | {refs.MANIFEST}
    for path in refs.STORE.iterdir():
        if path.name not in keep:
            path.unlink()
    refs.write_manifest(entries)
    size = sum(p.stat().st_size for p in refs.STORE.iterdir())
    print(f"{len(entries)} entries, {size} bytes, fingerprint "
          f"{refs.fingerprint()}")
    if failed:
        sys.exit(f"failed: {failed}")


if __name__ == "__main__":
    main()
