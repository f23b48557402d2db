"""Test configuration: the CPU with a virtual 8-device mesh.

Multi-device sharding is validated on a host-platform device mesh
(XLA_FLAGS=--xla_force_host_platform_device_count) as real multi-GPU
hardware is not assumed in CI. Tests marked ``gpu`` need an NVIDIA GPU;
whether one is present is decided by the ``gpu`` fixture at run time,
never while a module is imported. They run on the card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` (the render phase of
``chip_smoke.py`` makes the same comparisons at full size).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

import numpy as np
import pytest

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ensure_native_built():
    """Build the C++ KD-tree extension so tests/test_native.py parity runs
    for real instead of silently skipping (VERDICT r1 item 7). Skips only
    when no C++ toolchain exists; a toolchain present but failing build is
    a hard error."""
    try:
        from edgegaussians_tpu.native import kdtree  # noqa: F401
        return
    except Exception:
        pass
    import shutil
    import subprocess
    import sys
    if shutil.which("g++") is None and shutil.which("cc") is None:
        return
    r = subprocess.run(
        [sys.executable, "setup.py", "build_ext", "--inplace"],
        cwd=_REPO_ROOT, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(
            "native kdtree extension build failed (toolchain present):\n"
            + r.stderr[-2000:])


_ensure_native_built()


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables between test modules.

    A full-suite run accumulates hundreds of XLA:CPU executables; with the
    round-4 suite size the accumulated LLVM/compile state starts
    segfaulting inside backend_compile (observed 3x at the ~90% mark, at
    whichever module compiles a large program there — the crash point
    moves with suite content, so it is cumulative state, not a specific
    program). Clearing per module caps that state; cross-module program
    reuse is rare, so the recompile cost is small. The trainer program
    memo would otherwise keep executables alive through the clear."""
    yield
    try:
        from edgegaussians_tpu.train import trainer
        trainer._PROGRAM_MEMO.clear()
    except Exception:
        pass
    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere, decided by "
        "the gpu fixture at run time)")


@pytest.fixture
def gpu():
    """JAX's first device, when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX's first device is "
                    f"{dev.platform!r}")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def make_test_scene(rng, n=64, width=64, height=48, fov_deg=60.0):
    """A small synthetic scene: Gaussians in a box in front of a camera."""
    import math

    means = rng.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32)
    means[:, 2] += 2.0                       # push in front of the camera
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.uniform(np.log(0.01), np.log(0.08),
                                size=(n, 3))).astype(np.float32)
    opacities = rng.uniform(0.2, 0.95, size=(n,)).astype(np.float32)

    f = 0.5 * width / math.tan(math.radians(fov_deg) / 2)
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                 dtype=np.float32)
    viewmat = np.eye(4, dtype=np.float32)
    return means, quats, scales, opacities, viewmat, K


@pytest.fixture
def test_scene(rng):
    return make_test_scene(rng)
