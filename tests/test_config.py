"""Compilation cache placement and the host memory sampler."""

import logging
import os
import subprocess
import sys

import jax

from tpufem import config, memprof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert config.enable_compilation_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cache_default_is_fixed_checkout_path(tmp_path):
    """Without the variable the cache is <checkout>/.jax_cache, the same
    from any working directory and in any process."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    code = ("from tpufem.config import enable_compilation_cache as e; "
            "print(e())")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    want = os.path.join(REPO, ".jax_cache")
    assert out.stdout.strip() == want == config.DEFAULT_CACHE_DIR


def test_memory_profiler_reads_statm(caplog):
    vsize, rss = memprof.read_statm()
    with open("/proc/self/statm") as f:
        pages = [int(v) for v in f.read().split()[:2]]
    page = os.sysconf("SC_PAGE_SIZE")
    assert 0 < rss <= vsize
    assert abs(vsize - pages[0] * page) < (256 << 20)
    with caplog.at_level(logging.INFO, logger="tpufem"):
        prof = memprof.MemoryProfiler(interval_s=0.01).start()
        prof.stop()
    assert any("[MEM] VSIZE" in r.getMessage() for r in caplog.records)
