"""Render-backend resolution, the removed compositor values, and the
compile-cache path rules."""

import os

import jax
import pytest

from edgegaussians_tpu.config import ModelConfig, config_from_dict
from edgegaussians_tpu.ops.rasterize import BACKENDS, resolve_backend
from edgegaussians_tpu.utils import cache


@pytest.mark.parametrize("name", ["interpret", "jax"])
def test_explicit_backend_is_kept(name):
    assert resolve_backend(name) == name


def test_auto_never_picks_interpret():
    # the suite runs on the CPU: 'auto' is the plain-XLA path, and the
    # interpreter is only ever used when asked for by name
    assert jax.default_backend() == "cpu"
    assert resolve_backend("auto") == "jax"
    assert resolve_backend() == "jax"


def test_gpu_backend_without_a_gpu_raises():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        resolve_backend("gpu")


@pytest.mark.parametrize("name", ["pallas", "pallas_v1", "tpu", "cuda"])
def test_unknown_backend_raises(name):
    with pytest.raises(ValueError, match="unknown render backend"):
        resolve_backend(name)


def test_backend_names():
    assert BACKENDS == ("gpu", "interpret", "jax")


@pytest.mark.parametrize("value", [True, 1, "1", "true", "block", "BLOCK"])
def test_removed_pair_kernel_values_raise(value):
    with pytest.raises(ValueError, match="block-window pair kernel was "
                                         "removed"):
        ModelConfig(tile_pair_kernel=value)


@pytest.mark.parametrize("value,want", [
    (False, False), (0, False), ("false", False), ("off", False),
    ("seg", "seg"), (2, "seg"), ("2", "seg"), ("SEG", "seg")])
def test_pair_kernel_values(value, want):
    assert ModelConfig(tile_pair_kernel=value).tile_pair_kernel == want


@pytest.mark.parametrize("value", ["pallas", "pallas_v1"])
def test_removed_rasterizer_backends_raise(value):
    with pytest.raises(ValueError, match="were removed"):
        config_from_dict({"model": {"rasterizer_backend": value}})


def test_shipped_configs_load():
    import glob
    from edgegaussians_tpu.config import load_config
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = glob.glob(os.path.join(repo, "configs", "*.json"))
    assert paths
    for p in paths:
        m = load_config(p).model
        assert m.tile_pair_kernel in (False, "seg")
        assert m.rasterizer_backend in ("auto",) + BACKENDS


def test_train_cli_rejects_removed_backend():
    from edgegaussians_tpu.cli import train
    with pytest.raises(SystemExit):
        train.main(["--config_file", "x.json", "--backend", "pallas"])


def test_cache_honours_environment(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path / "env_cache"))
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    assert cache.enable_compilation_cache() == str(tmp_path / "env_cache")
    # JAX reads the variable itself: no directory is set in code
    assert not any(k == "jax_compilation_cache_dir" for k, _ in calls)


def test_cache_default_is_fixed_inside_checkout(monkeypatch):
    calls = []
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = cache.enable_compilation_cache()
    assert path == os.path.join(repo, ".jax_cache") == cache.DEFAULT_DIR
    assert ("jax_compilation_cache_dir", path) in calls
    # no home directory, temp name, pid or time in the path
    assert cache.cache_dir() == path
    assert str(os.getpid()) not in path
    assert not path.startswith(os.path.expanduser("~") + os.sep + ".")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
