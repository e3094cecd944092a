"""The port's compile cache against the JAX package's contract.

``harness.setup_compile_cache`` reads ``VTPU_COMPILE_CACHE_DIR`` and, where
JAX points its persistent compilation cache there, points the kernel builds
(``_build``) at ``<dir>/kernels``; ``record_compile_cache_key`` keeps the
host manifest the monitor ships: the same file, lock, cap and aging as the
JAX writer, so a manifest either package writes reads back through the
other's writer unchanged.
"""

import json
import os
import threading
import time

import pytest

from k8s_device_plugin_torch import _build
from k8s_device_plugin_torch import api as tapi
from k8s_device_plugin_torch.workloads import harness as th
from k8s_device_plugin_torch.workloads import run as trun
from k8s_device_plugin_tpu import api as japi
from k8s_device_plugin_tpu.workloads import harness as jh


@pytest.fixture(autouse=True)
def _default_build_dir():
    yield
    _build.set_build_dir()  # setup_compile_cache moves it process-wide


def _keys(cache_dir):
    with open(os.path.join(cache_dir, tapi.COMPILE_CACHE_MANIFEST)) as f:
        return json.load(f)["keys"]


def test_contract_constants_match_jax():
    for const in ("TPU_COMPILE_CACHE_KEY", "TPU_COMPILE_CACHE_DIR",
                  "COMPILE_CACHE_MANIFEST", "COMPILE_CACHE_MANIFEST_MAX_KEYS",
                  "COMPILE_CACHE_MANIFEST_MAX_AGE_S"):
        assert getattr(tapi, const) == getattr(japi, const), const
    assert th.CACHE_MANIFEST == jh.CACHE_MANIFEST == "vtpu_cache_keys.json"


def test_compile_cache_manifest_roundtrip(tmp_path):
    th.record_compile_cache_key("key-a", str(tmp_path))
    th.record_compile_cache_key("key-b", str(tmp_path))
    th.record_compile_cache_key("key-a", str(tmp_path))  # refresh
    assert set(_keys(tmp_path)) == {"key-a", "key-b"}
    assert (tmp_path / f"{th.CACHE_MANIFEST}.lock").exists()
    # unset key / unset dir are silent no-ops (never fail a workload)
    th.record_compile_cache_key("", str(tmp_path))
    th.record_compile_cache_key("k", "")
    assert set(_keys(tmp_path)) == {"key-a", "key-b"}


def test_setup_compile_cache_env_contract(tmp_path, monkeypatch):
    monkeypatch.delenv(tapi.TPU_COMPILE_CACHE_DIR, raising=False)
    assert th.setup_compile_cache() == ""
    assert th.active_compile_cache_dir() == ""
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR
    assert _build.BUILD_DIR.endswith(os.path.join("build", "kernels"))
    cache = str(tmp_path / "cc")
    monkeypatch.setenv(tapi.TPU_COMPILE_CACHE_DIR, cache)
    monkeypatch.setenv(tapi.TPU_COMPILE_CACHE_KEY, "k-gang")
    assert th.setup_compile_cache() == cache
    assert th.active_compile_cache_dir() == cache
    # the kernel libraries move into the cache, hash names unchanged
    assert _build.BUILD_DIR == os.path.join(cache, "kernels")
    assert os.path.isdir(_build.BUILD_DIR)
    target = _build._target("lstm_cell")
    assert os.path.dirname(target) == _build.BUILD_DIR
    assert os.path.basename(target).startswith("liblstm_cell-")
    # no premature vouch: the manifest is written after the first call
    assert not os.path.exists(os.path.join(cache, th.CACHE_MANIFEST))
    # unset again: back to build/kernels
    monkeypatch.delenv(tapi.TPU_COMPILE_CACHE_DIR)
    assert th.setup_compile_cache() == ""
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR


def test_an_unwritable_cache_runs_cold(tmp_path, monkeypatch):
    """A cache dir that cannot be made leaves the builds in build/kernels
    and the vouch a no-op; nothing raises."""
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    monkeypatch.setenv(tapi.TPU_COMPILE_CACHE_DIR, str(blocker / "cc"))
    assert th.setup_compile_cache() == ""
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR
    th.record_compile_cache_key("k", str(blocker / "cc"))


@pytest.mark.parametrize("writer,reader", [(th, jh), (jh, th)])
def test_a_manifest_reads_back_through_the_other_writer(tmp_path, writer,
                                                        reader):
    for key in ("a", "b", "c"):
        writer.record_compile_cache_key(key, str(tmp_path))
    first = _keys(tmp_path)
    reader.record_compile_cache_key("d", str(tmp_path))
    second = _keys(tmp_path)
    assert {k: second[k] for k in first} == first  # unchanged, timestamps too
    assert set(second) == {"a", "b", "c", "d"}


def test_cap_aging_and_foreign_entries(tmp_path):
    """At most 256 keys, the oldest dropped first; keys older than 7 days
    and entries without a numeric timestamp dropped on rewrite, as the JAX
    writer does on the same file."""
    now, cap = time.time(), tapi.COMPILE_CACHE_MANIFEST_MAX_KEYS
    keys = {f"k{i}": now - 100 - i for i in range(cap)}
    keys.update({"stale": now - tapi.COMPILE_CACHE_MANIFEST_MAX_AGE_S - 60,
                 "text": "yesterday", "none": None, "flag": True})
    path = tmp_path / th.CACHE_MANIFEST
    results = []
    for writer in (th, jh):
        path.write_text(json.dumps({"keys": keys}))
        writer.record_compile_cache_key("new", str(tmp_path))
        results.append(_keys(tmp_path))
    got, want = results
    assert len(got) == cap
    assert "new" in got and "k255" not in got and "k254" in got
    assert not {"stale", "text", "none", "flag"} & set(got)
    assert set(got) == set(want)
    for doc in ("{corrupt", json.dumps(["a", "list"]),
                json.dumps({"keys": [1, 2]})):
        path.write_text(doc)
        th.record_compile_cache_key("fresh", str(tmp_path))
        assert set(_keys(tmp_path)) == {"fresh"}


def test_concurrent_writers_keep_every_key(tmp_path):
    """The read-modify-write holds an flock on <manifest>.lock: writers in
    threads (each its own open file, as two pods would be) lose nothing."""
    def vouch(t):
        for i in range(10):
            th.record_compile_cache_key(f"t{t}-{i}", str(tmp_path))
    threads = [threading.Thread(target=vouch, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(_keys(tmp_path)) == 80


def test_runner_vouches_for_its_key_after_the_first_call(tmp_path,
                                                         monkeypatch):
    """The runner sets the cache up in main and records the pod's key
    after its warm-up, as the JAX runner's _bench_loop does."""
    monkeypatch.delenv("VTPU_DEVICE_MEMORY_SHARED_CACHE", raising=False)
    monkeypatch.setenv(tapi.TPU_COMPILE_CACHE_DIR, str(tmp_path))
    monkeypatch.setenv(tapi.TPU_COMPILE_CACHE_KEY, "k-pod")
    assert trun.main(["--model", "lstm", "--batch", "2", "--size", "8",
                      "--steps", "1", "--device", "cpu"]) == 0
    assert set(_keys(tmp_path)) == {"k-pod"}
    assert _build.BUILD_DIR == str(tmp_path / "kernels")
