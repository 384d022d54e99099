"""The persistent compile cache lives at one fixed place."""

import jax

from glimmer_mg_tpu.utils import compile_cache


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_dir_is_left_to_jax(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    helper sets nothing in code."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_updates(monkeypatch)
    assert compile_cache.setup_compile_cache() == str(tmp_path)
    assert calls == []


def test_default_dir_is_in_the_checkout(monkeypatch):
    """Without the variable the cache goes to <checkout>/.cache/jax, the
    same path in every process (no temporary or per-process directory)."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_updates(monkeypatch)
    path = compile_cache.setup_compile_cache()
    want = compile_cache.CHECKOUT / ".cache" / "jax"
    assert path == str(want)
    assert calls == [("jax_compilation_cache_dir", str(want))]
    assert (compile_cache.CHECKOUT / "glimmer_mg_tpu").is_dir()
    assert compile_cache.setup_compile_cache() == path
