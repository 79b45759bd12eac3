"""The store of built kernel libraries (``tpuprof_torch/runtime/aot.py``).

The CPU test runs have no nvcc, so the store is driven with stand-in library
files through the mapping of library name to path it takes: a round trip
into an empty build directory; truncation at every offset and bit flips in
the header, the table and each library (``CorruptAotCacheError``, the entry
unlinked by the acquire seam, nothing written to the build directory); a
forged fingerprint, a wrong key and a foreign library table never load;
the ``aot_load`` fault demotes and counts; a writer killed with SIGKILL in
the middle of saves leaves no torn entry; a corrupt manifest reads as
empty; which libraries a runner key needs; the prewarmer acquiring the
manifest's hot keys on ``device="cpu"``; and the ``--compile-cache`` /
``--no-compile-cache`` precedence.  The test that needs the card carries
the ``cuda`` marker and skips inside the test.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time
import zlib
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import tpuprof_torch
from tpuprof_torch import _build, cli
from tpuprof_torch.config import ProfilerConfig
from tpuprof_torch.errors import CorruptAotCacheError, TYPED_ERRORS, \
    exit_code
from tpuprof_torch.obs import blackbox
from tpuprof_torch.runtime import aot
from tpuprof_torch.serve import cache
from tpuprof_torch.testing import faults

REPO = str(Path(__file__).resolve().parents[1])
CPU = (("cpu", None),)
KEY = (200, 4, (("cuda", 0),), 65536, None, 11, 10, "cumulative",
       "two_pass")


@pytest.fixture(autouse=True)
def clean():
    faults.reset()
    yield
    faults.reset()
    _build.set_build_dir(None)


def _libs(root, names=("fused_a", "hist_b"), size=300):
    """Stand-in library files: {name: path}, distinct bytes each."""
    os.makedirs(root, exist_ok=True)
    out = {}
    for i, name in enumerate(names):
        path = os.path.join(root, f"lib{name}-{i:012x}.so")
        with open(path, "wb") as fh:
            fh.write(bytes((i * 37 + j) % 251 for j in range(size + i)))
        out[name] = path
    return out


def _targets(build, libs):
    return {n: os.path.join(build, os.path.basename(p))
            for n, p in libs.items()}


@pytest.fixture
def store(tmp_path):
    """(store, key, the built stand-ins, the entry's path)."""
    st = aot.AotStore(str(tmp_path / "store"), CPU)
    libs = _libs(str(tmp_path / "built"))
    st.save(KEY, libs)
    return st, libs, st.entry_path(KEY, libs)


def _read(st, libs, path):
    return aot.read_entry(path, st.fingerprint, repr(KEY),
                          {n: os.path.basename(p) for n, p in libs.items()})


def test_round_trip_into_an_empty_build_directory(store, tmp_path):
    st, libs, path = store
    assert st.entries() == [os.path.basename(path)[:-4]]
    build = str(tmp_path / "empty_build")
    targets = _targets(build, libs)
    assert st.load_into(KEY, targets) == 2
    for name, src in libs.items():
        with open(src, "rb") as a, open(targets[name], "rb") as b:
            assert a.read() == b.read()
    assert not [f for f in os.listdir(build) if f.startswith(".")]
    # a library already in place is not rewritten
    mtime = os.stat(targets["hist_b"]).st_mtime_ns
    assert st.load_into(KEY, targets) == 2
    assert os.stat(targets["hist_b"]).st_mtime_ns == mtime
    # another key, or other library names, is a clean miss
    other = KEY[:6] + (20,) + KEY[7:]
    assert st.load_into(other, targets) == 0
    assert st.load_into(KEY, {"fused_a": targets["fused_a"]}) == 0


def test_truncation_at_every_offset(store):
    st, libs, path = store
    with open(path, "rb") as fh:
        data = fh.read()
    assert set(_read(st, libs, path)) == {"fused_a", "hist_b"}
    for offset in range(len(data)):
        with open(path, "wb") as fh:
            fh.write(data[:offset])
        with pytest.raises(CorruptAotCacheError):
            _read(st, libs, path)
    with open(path, "wb") as fh:
        fh.write(data)
    assert set(_read(st, libs, path)) == {"fused_a", "hist_b"}


def test_bit_flips_anywhere(store):
    st, libs, path = store
    with open(path, "rb") as fh:
        data = fh.read()
    nl = data.index(b"\n", len(aot._MAGIC))
    for offset in (3, len(aot._MAGIC) + 5, nl - 20, nl + 1, nl + 150,
                   len(data) - 1):
        flipped = bytearray(data)
        flipped[offset] ^= 0x40
        with open(path, "wb") as fh:
            fh.write(bytes(flipped))
        with pytest.raises(CorruptAotCacheError):
            _read(st, libs, path)


def test_a_table_that_does_not_add_up(store):
    """A sealed payload whose per-library table lies (a valid overall
    CRC, a rewritten header) is refused too."""
    st, libs, path = store
    with open(path, "rb") as fh:
        data = fh.read()
    nl = data.index(b"\n", len(aot._MAGIC))
    header = json.loads(data[len(aot._MAGIC):nl])
    header["libraries"][0]["len"] += 1
    with open(path, "wb") as fh:
        fh.write(aot._MAGIC + json.dumps(header).encode() + b"\n"
                 + data[nl + 1:])
    with pytest.raises(CorruptAotCacheError, match="does not add up"):
        _read(st, libs, path)


def test_forged_fingerprint_never_loads(store, tmp_path):
    """An entry whose fingerprint inside was doctored (another nvcc, CRC
    valid) raises under the right name; honest skew is another name."""
    st, libs, path = store
    forged = dict(st.fingerprint, nvcc="Cuda compilation tools, release "
                  "99.9, forged")
    aot.write_entry(path, repr(KEY), forged, libs)
    with pytest.raises(CorruptAotCacheError, match="fingerprint"):
        _read(st, libs, path)
    files = [os.path.basename(p) for p in libs.values()]
    assert aot.entry_digest(KEY, st.fingerprint, files) \
        != aot.entry_digest(KEY, forged, files)
    build = str(tmp_path / "b")
    with pytest.raises(CorruptAotCacheError):
        st.load_into(KEY, _targets(build, libs))
    assert not os.path.exists(build)


def test_wrong_key_or_libraries_never_load(store):
    st, libs, path = store
    with pytest.raises(CorruptAotCacheError, match="different runner key"):
        aot.read_entry(path, st.fingerprint, "other-key")
    with pytest.raises(CorruptAotCacheError, match="other libraries"):
        aot.read_entry(path, st.fingerprint, repr(KEY),
                       {"fused_a": "libfused_a-other.so",
                        "hist_b": os.path.basename(libs["hist_b"])})


def test_taxonomy():
    exc = CorruptAotCacheError("x")
    assert exit_code(exc) == 6 and isinstance(exc, TYPED_ERRORS)


def _seam(monkeypatch, tmp_path, libs):
    """Point the acquire seam at stand-ins: the key needs ``libs`` and
    builds into ``tmp_path/build``; a save packs the stand-ins."""
    build = str(tmp_path / "build")
    monkeypatch.setattr(aot, "libraries_for", lambda key: sorted(libs))
    monkeypatch.setattr(aot, "library_targets",
                        lambda names: _targets(build, libs))
    return build


def test_corrupt_entry_demotes_loudly_and_is_unlinked(store, tmp_path,
                                                      monkeypatch):
    st, libs, path = store
    build = _seam(monkeypatch, tmp_path, libs)
    with open(path, "rb") as fh:
        data = fh.read()
    with open(path, "wb") as fh:
        fh.write(data[: len(data) * 2 // 3])
    saved = []
    monkeypatch.setattr(aot, "schedule_save",
                        lambda store, key, names: saved.append(key))
    before = dict(aot.counts)
    cfg = ProfilerConfig(aot_cache_dir=st.root)
    monkeypatch.setattr(aot, "env_fingerprint", lambda devices:
                        st.fingerprint)
    assert aot.on_runner_miss(None, cfg, KEY, 200, 4) is False
    assert not os.path.exists(path)             # not haunting a restart
    assert not os.path.exists(build)            # no unverified byte
    assert aot.counts["corrupt"] == before["corrupt"] + 1
    assert saved == [KEY]                       # rebuilt, then re-saved
    kinds = [e["kind"] for e in blackbox.box().entries()]
    assert "aot_load_corrupt" in kinds
    # the key still counts as hot for the next restart's prewarm
    assert aot.entry_digest(KEY, st.fingerprint) \
        in st.read_manifest()["entries"]


def test_seam_adopts_a_sound_entry(store, tmp_path, monkeypatch):
    st, libs, path = store
    build = _seam(monkeypatch, tmp_path, libs)
    monkeypatch.setattr(aot, "env_fingerprint", lambda devices:
                        st.fingerprint)
    monkeypatch.setattr(aot, "schedule_save", lambda *a: pytest.fail(
        "a hit must not save"))
    before = aot.counts["loaded"]
    cfg = ProfilerConfig(aot_cache_dir=st.root)
    assert aot.on_runner_miss(None, cfg, KEY, 200, 4) is True
    assert sorted(os.listdir(build)) == sorted(
        os.path.basename(p) for p in libs.values())
    assert aot.counts["loaded"] == before + 1
    # the switch off: no store at all
    assert aot.on_runner_miss(None, ProfilerConfig(
        aot_cache_dir=st.root, aot_cache="off"), KEY, 200, 4) is False


def test_aot_load_fault_demotes_and_counts(store, tmp_path, monkeypatch):
    st, libs, path = store
    build = _seam(monkeypatch, tmp_path, libs)
    monkeypatch.setattr(aot, "env_fingerprint", lambda devices:
                        st.fingerprint)
    monkeypatch.setattr(aot, "schedule_save", lambda *a: None)
    faults.configure("aot_load:1@1")
    before = aot.counts["missed"]
    cfg = ProfilerConfig(aot_cache_dir=st.root)
    assert aot.on_runner_miss(None, cfg, KEY, 200, 4) is False
    assert faults.injected("aot_load") == 1
    assert aot.counts["missed"] == before + 1
    assert not os.path.exists(build) and os.path.exists(path)
    # the next load is not injected and adopts
    assert aot.on_runner_miss(None, cfg, KEY, 200, 4) is True


def test_save_in_the_background_after_a_miss(tmp_path, monkeypatch):
    """A miss schedules the save: the key's libraries are built (here:
    already there) and packed off the caller's thread."""
    from tpuprof_torch import kernels
    libs = _libs(str(tmp_path / "build"))
    monkeypatch.setattr(aot, "libraries_for", lambda key: sorted(libs))
    monkeypatch.setattr(aot, "library_targets", lambda names: libs)
    monkeypatch.setattr(kernels, "build", lambda names: {})
    root = str(tmp_path / "store")
    cfg = ProfilerConfig(aot_cache_dir=root)
    monkeypatch.setattr(aot, "env_fingerprint",
                        lambda devices: {"schema": aot.AOT_SCHEMA})
    assert aot.on_runner_miss(None, cfg, KEY, 200, 4) is False
    aot.wait_pending_saves(60)
    st = aot.AotStore(root, CPU)
    assert len(st.entries()) == 1
    assert st.load_into(KEY, _targets(str(tmp_path / "b2"), libs)) == 2
    # the prewarmer never saves
    with aot.no_save():
        aot.on_runner_miss(None, cfg, KEY[:1] + (5,) + KEY[2:], 200, 5)
    aot.wait_pending_saves(60)
    assert len(st.entries()) == 1


_KILL_WRITER = textwrap.dedent("""
    import os, sys
    from tpuprof_torch.runtime import aot
    root, lib = sys.argv[1], sys.argv[2]
    with open(lib, "wb") as fh:
        fh.write(os.urandom(1 << 20))
    fp = {"schema": aot.AOT_SCHEMA}
    i = 0
    while True:
        aot.write_entry(os.path.join(root, f"{i:032x}.aot"), "key", fp,
                        {"k": lib})
        if i == 0:
            print("GO", flush=True)
        i += 1
""")


@pytest.mark.parametrize("delay", [0.0, 0.05])
def test_sigkill_mid_save_leaves_no_torn_entry(tmp_path, delay):
    root = str(tmp_path / "store")
    os.makedirs(root)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-c", _KILL_WRITER, root,
         str(tmp_path / "lib.so")], stdout=subprocess.PIPE, env=env,
        text=True)
    try:
        assert proc.stdout.readline().strip() == "GO"
        time.sleep(delay)
    finally:
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
    sealed = [n for n in os.listdir(root)
              if n.endswith(".aot") and not n.startswith(".")]
    assert sealed
    for name in sealed:
        blobs = aot.read_entry(os.path.join(root, name),
                               {"schema": aot.AOT_SCHEMA}, "key")
        assert len(blobs["k"]) == 1 << 20
    assert sorted(aot.AotStore(root, CPU).entries()) \
        == sorted(n[:-4] for n in sealed)


@pytest.mark.parametrize("garbage", [
    b"", b"{not json", b'{"schema": "other"}', b"[1, 2]",
    "truncated", "crc"])
def test_corrupt_manifest_reads_as_empty(tmp_path, garbage):
    st = aot.AotStore(str(tmp_path / "store"), CPU)
    st.touch_manifest(KEY, ProfilerConfig(), 200, 4)
    assert len(st.read_manifest()["entries"]) == 1
    with open(st.manifest_path, "rb") as fh:
        data = fh.read()
    if garbage == "truncated":
        garbage = data[: len(data) // 2]
    elif garbage == "crc":
        garbage = data.replace(b'"n_num": 200', b'"n_num": 201')
    with open(st.manifest_path, "wb") as fh:
        fh.write(garbage)
    assert st.read_manifest() == {"entries": {}}
    # the next touch rewrites a sound one
    st.touch_manifest(KEY, ProfilerConfig(), 200, 4)
    assert len(st.read_manifest()["entries"]) == 1


@pytest.mark.parametrize("key,want", [
    (KEY, ["fused_a", "hist_b", "spear"]),
    (KEY[:8] + ("fused",), ["fused_a", "fused_ab", "hist_b", "spear"]),
    (KEY[:6] + (9000,) + KEY[7:8] + ("fused",),
     ["fused_a", "hist_b", "spear"]),
    ((600,) + KEY[1:], ["fused_wide", "hist_b", "rank"]),
    ((3000,) + KEY[1:], ["hist_b"]),
    ((0,) + KEY[1:], []),
    (KEY[:2] + (CPU,) + KEY[3:], []),
])
def test_libraries_a_key_needs(key, want):
    assert aot.libraries_for(key) == want


def test_env_fingerprint_on_the_cpu():
    fp = aot.env_fingerprint(CPU)
    assert fp["schema"] == aot.AOT_SCHEMA and fp["torch"] == torch.__version__
    assert fp["devices"] == [["cpu", None, "cpu", None]]
    assert json.loads(json.dumps(fp)) == fp      # survives the header
    assert set(fp) == {"schema", "torch", "cuda", "nvcc", "devices",
                       "device_count"}


def test_describe_with_a_store_on_the_cpu(tmp_path):
    """A profile with a store on the CPU (no kernel libraries) records its
    key in the manifest, saves nothing, and its stats are unchanged."""
    df = pd.DataFrame({"x": np.arange(300.0), "y": np.sqrt(np.arange(300.0))})
    cache.process_cache().clear()
    root = str(tmp_path / "store")
    with_store = tpuprof_torch.describe(df, device="cpu", batch_rows=64,
                                        aot_cache_dir=root)
    cache.process_cache().clear()
    plain = tpuprof_torch.describe(df, device="cpu", batch_rows=64)
    from tpuprof_torch.report.export import stats_to_json
    assert json.dumps(stats_to_json(with_store), sort_keys=True) \
        == json.dumps(stats_to_json(plain), sort_keys=True)
    st = aot.AotStore(root, CPU)
    rows = list(st.read_manifest()["entries"].values())
    assert len(rows) == 1 and rows[0]["n_num"] == 2
    assert rows[0]["config"]["batch_rows"] == 64 and st.entries() == []


def test_prewarmer_acquires_the_manifest_hot_keys(tmp_path):
    root = str(tmp_path / "store")
    st = aot.AotStore(root, CPU)
    for bins, used in ((5, 1.0), (6, 3.0), (7, 2.0)):
        cfg = ProfilerConfig(bins=bins, batch_rows=128)
        key = cache.runner_key(cfg, 3, 1, ["cpu"])
        st.touch_manifest(key, cfg, 3, 1)
        doc = st.read_manifest()
    # make the LRU order explicit
    with open(st.manifest_path) as fh:
        raw = json.load(fh)
    for row in raw["entries"].values():
        row["last_used"] = {5: 1.0, 6: 3.0, 7: 2.0}[row["config"]["bins"]]
    raw.pop("integrity")
    raw["integrity"] = {"algorithm": "crc32/canonical-json",
                        "crc32": zlib.crc32(json.dumps(
                            raw, sort_keys=True,
                            separators=(",", ":")).encode()) & 0xFFFFFFFF}
    with open(st.manifest_path, "w") as fh:
        json.dump(raw, fh)
    assert len(doc["entries"]) == 3
    cache.process_cache().clear()
    pw = aot.Prewarmer(root, 2, device="cpu").start()
    assert pw.wait(60)
    s = pw.status()
    assert s["done"] and (s["loaded"], s["failed"], s["pending"]) \
        == (2, 0, 0)
    for bins, hot in ((6, True), (7, True), (5, False)):
        key = cache.runner_key(ProfilerConfig(bins=bins, batch_rows=128),
                               3, 1, ["cpu"])
        assert (key in cache.process_cache()) is hot
    off = aot.Prewarmer(root, 0, device="cpu").start()
    assert off.wait(60) and off.status()["loaded"] == 0


def test_compile_cache_precedence(tmp_path, monkeypatch):
    """An explicit directory, else ``TPUPROF_TORCH_BUILD_DIR``, else
    ``build/tpuprof_torch/`` beside the package."""
    monkeypatch.delenv("TPUPROF_TORCH_BUILD_DIR", raising=False)
    assert _build.default_build_dir() \
        == os.path.join(REPO, "build", "tpuprof_torch")
    monkeypatch.setenv("TPUPROF_TORCH_BUILD_DIR", str(tmp_path / "env"))
    assert _build.build_dir() == str(tmp_path / "env")
    _build.set_build_dir(str(tmp_path / "explicit"))
    assert _build.build_dir() == str(tmp_path / "explicit")
    assert os.path.isdir(tmp_path / "explicit")
    assert _build.library_path(
        os.path.join(REPO, "tpuprof_torch", "kernels", "csrc", "rank.cu"),
        ["nvcc"]).startswith(str(tmp_path / "explicit"))
    _build.set_build_dir(None)
    assert _build.build_dir() == str(tmp_path / "env")


def test_compile_cache_flags_of_the_verbs(tmp_path, monkeypatch, capsys):
    df = pd.DataFrame({"x": np.arange(200.0)})
    src = str(tmp_path / "t.parquet")
    df.to_parquet(src)
    out = str(tmp_path / "r.html")
    built = str(tmp_path / "cc")
    assert cli.main(["profile", src, "-o", out, "--device", "cpu",
                     "--compile-cache", built, "--aot-cache-dir",
                     str(tmp_path / "store"), "--aot-cache", "on"]) == 0
    assert _build.build_dir() == built
    assert os.path.exists(tmp_path / "store" / "manifest.json")
    with pytest.raises(SystemExit):
        cli.main(["profile", src, "--compile-cache", built,
                  "--no-compile-cache"])
    capsys.readouterr()
    monkeypatch.setattr(_build, "_override", None)
    assert cli.main(["profile", src, "-o", out, "--device", "cpu",
                     "--no-compile-cache"]) == 0
    private = _build.build_dir()
    assert os.path.basename(private).startswith("tpuprof-torch-build-")


def test_private_build_dir_is_removed_at_exit(tmp_path):
    code = ("from tpuprof_torch import _build\n"
            "print(_build.use_private_build_dir(), flush=True)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    path = out.stdout.strip()
    assert path and not os.path.exists(path)


def test_a_missing_compiler_raises_at_the_build(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// nothing\n")
    _build.set_build_dir(str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="not found"):
        _build.start_build(str(src), [str(tmp_path / "no-nvcc")])
    # an existing library loads with no compiler at all
    path = _build.library_path(str(src), [str(tmp_path / "no-nvcc")])
    Path(path).write_bytes(b"\x7fELF")
    assert _build.start_build(str(src), [str(tmp_path / "no-nvcc")]) \
        == (path, None)


@pytest.mark.cuda
def test_store_round_trip_of_real_libraries_on_the_card(tmp_path):
    """On a card: build K1 and K2, save, adopt into an empty build
    directory, and load the adopted libraries with no nvcc run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpuprof_torch import kernels
    cfg = ProfilerConfig(batch_rows=1024)
    key = cache.runner_key(cfg, 8, 0, ["cuda:0"])
    names = aot.libraries_for(key)
    _build.set_build_dir(str(tmp_path / "a"))
    kernels.build(names)
    st = aot.AotStore(str(tmp_path / "store"), key[2])
    st.save(key, aot.library_targets(names))
    _build.set_build_dir(str(tmp_path / "b"))
    before = _build.builds.get("nvcc", 0)
    assert st.load_into(key, aot.library_targets(names)) == len(names)
    kernels.build(names)
    assert _build.builds.get("nvcc", 0) == before
