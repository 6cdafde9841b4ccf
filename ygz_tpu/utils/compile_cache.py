"""Persistent XLA compilation cache, shared by bench/tests/tools.

One call makes every jit compile on the accelerator land in (and load from)
a persistent cache directory, so a second process — the bench's timed run
after its warmup child, a rerun of `chip_smoke.py` — loads its programs
instead of compiling them. The directory is JAX_COMPILATION_CACHE_DIR when
that is set; otherwise a fixed path inside the checkout
(`.jax_cache/<host fingerprint>`, git-ignored). The path is part of what
makes a later run hit, so it never depends on a temp name, a process id or
the time.
"""
from __future__ import annotations

import os


def _host_fingerprint() -> str:
    """Hash of the CPU feature set + jaxlib version. XLA:CPU AOT
    executables cached by a DIFFERENT machine generation LOAD here with
    only a warning ('Machine type ... doesn't match ...') and then produce
    silently wrong numerics — measured in r4 as a 280 m ATE on a VI run
    that computes 0.006 m without the stale cache. Scoping the directory
    by host fingerprint makes foreign entries unreachable."""
    import hashlib

    try:
        with open("/proc/cpuinfo") as f:
            flags = next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        flags = ""
    try:
        import jaxlib
        ver = getattr(jaxlib, "__version__", "?")
    except Exception:
        ver = "?"
    return hashlib.sha1(f"{ver}|{flags}".encode()).hexdigest()[:12]


def cache_dir() -> str:
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, ".jax_cache", _host_fingerprint())


def enable():
    """Point jax's persistent compilation cache at cache_dir(). Returns the
    directory, or None on the CPU backend.

    CPU runs get NO persistent cache: this jaxlib's XLA:CPU AOT reload
    path mis-targets the host ('Target machine feature +prefer-no-scatter
    is not supported', cpu_aot_loader.cc) and the reloaded executables
    compute DIFFERENT numerics than the in-process JIT path — measured in
    r4 as a deterministic wrong VINS-init scale (5.14 vs 5.32) and up to
    280 m ATE on runs that compute 0.006 m without the cache, even for
    entries compiled on this same machine minutes earlier. JAX turns the
    cache on by itself when JAX_COMPILATION_CACHE_DIR is set, so the CPU
    opt-out switches it off explicitly."""
    import jax

    # decide by the ACTUAL backend, not env-var string matching: on a
    # CPU-default host with JAX_PLATFORMS unset the env var is empty but
    # the backend is still XLA:CPU and its AOT-reload numerics bug applies
    if jax.default_backend() == "cpu":
        jax.config.update("jax_enable_compilation_cache", False)
        return None
    d = cache_dir()
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return d
