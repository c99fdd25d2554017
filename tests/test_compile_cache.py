"""Where the persistent compilation cache goes."""

import pytest

from nerfacc_tpu import compile_cache


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config updates instead of applying them."""
    calls = {}
    monkeypatch.setattr(
        compile_cache.jax.config, "update",
        lambda name, value: calls.__setitem__(name, value),
    )
    return calls


def test_env_dir_is_used_and_no_other_is_set(monkeypatch, config_updates,
                                             tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS",
                       raising=False)
    assert compile_cache.setup_compile_cache(2.0) == str(tmp_path)
    assert "jax_compilation_cache_dir" not in config_updates
    assert config_updates == {
        "jax_persistent_cache_min_compile_time_secs": 2.0
    }


def test_unset_env_uses_the_checkout_dir(monkeypatch, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "5")
    got = compile_cache.setup_compile_cache()
    repo = compile_cache.Path(compile_cache.__file__).resolve().parent.parent
    assert got == str(repo / ".jax_cache")
    assert config_updates == {"jax_compilation_cache_dir": got}
    assert compile_cache.DEFAULT_DIR.is_dir()
