"""Entry points that must not fall back to the CPU, the compile-cache
helper they share, and the native library built from source."""

import jax
import pytest

from audio_raytracer_tpu.utils import compile_cache


def test_chip_smoke_fails_without_gpu(capsys):
    import chip_smoke

    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_bench_fails_without_gpu(capsys):
    import bench

    assert bench.main([]) != 0
    assert '"metric"' not in capsys.readouterr().out


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_defaults_to_repo_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == str(compile_cache.REPO_CACHE_DIR)
    assert compile_cache.REPO_CACHE_DIR.name == ".jax_cache"
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_env_var_sets_nothing(monkeypatch, tmp_path,
                                            restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_native_library_builds_when_build_dir_absent(monkeypatch, tmp_path):
    from audio_raytracer_tpu.runtime import native

    build = tmp_path / "_build"
    monkeypatch.setattr(native, "_BUILD_DIR", build)
    monkeypatch.setattr(native, "_lib", None)
    lib = native.load()
    assert native.library_path().parent == build
    assert native.library_path().exists()
    assert lib.art_registry_create() is not None
