"""Where the persistent compilation cache lives: JAX_COMPILATION_CACHE_DIR
when set, else one fixed directory inside the checkout."""
import os

import pytest

from ygz_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "jax-cache-from-env"])
def test_cache_dir(monkeypatch, tmp_path, env_dir):
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        d = compile_cache.cache_dir()
        assert d == compile_cache.cache_dir()   # fixed, not per call
        assert os.path.commonpath([d, ROOT]) == ROOT
        assert os.path.dirname(d) == os.path.join(ROOT, ".jax_cache")
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
        assert compile_cache.cache_dir() == want
