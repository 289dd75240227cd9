"""Test harness: CPU backend with 8 virtual devices.

Multi-chip sharding is validated without a pod via XLA's virtual host
devices (the standard JAX trick; the driver separately dry-runs the
multi-chip path with `dryrun_multichip`).  Benchmarks run on real TPU
outside pytest.
"""
import os

# Force the CPU backend for unit tests (the session env may pre-set
# JAX_PLATFORMS to the TPU platform).  Set VKRESAMPLE_TEST_TPU=1 to run the
# suite against the real chip instead.
if not os.environ.get("VKRESAMPLE_TEST_TPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    # Some pytest plugins import jax before this conftest runs, making the
    # env vars too late — set through the config API as well (valid until
    # the first backend initialization).
    import jax

    jax.config.update("jax_platforms", "cpu")
    try:
        jax.config.update("jax_num_cpu_devices", 8)
    except Exception:
        pass  # older jax: XLA_FLAGS above covers it

# Keep unit tests hermetic: CLI entry points enable the persistent XLA
# executable cache under ~/.cache/vkresample by default — don't write
# there from the suite (test_bankcache scopes its own cache dir).
os.environ.setdefault("VKRESAMPLE_NO_COMPILE_CACHE", "1")

# fp64 plans scope x64 themselves via jax.enable_x64(); the suite stays on
# default 32-bit semantics.

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device; skips without one",
    )


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def make_test_image(h, w, c=3, seed=0):
    """Smooth-ish random test image (band-limited noise + gradients) —
    closer to natural images than white noise, which matters for CAS."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, c), np.float64)
    for ch in range(c):
        base = (
            0.5
            + 0.25 * np.sin(2 * np.pi * (3 + ch) * xx / w)
            + 0.2 * np.cos(2 * np.pi * (2 + ch) * yy / h)
        )
        noise = r.normal(0, 0.08, (h, w))
        # crude low-pass: box blur
        k = 5
        noise = np.cumsum(noise, axis=0)
        noise = (noise[k:] - noise[:-k]) / k
        noise = np.cumsum(noise, axis=1)
        noise = (noise[:, k:] - noise[:, :-k]) / k
        img[k : k + noise.shape[0], k : k + noise.shape[1], ch] = noise
        img[:, :, ch] += base
    return np.clip(img * 255, 0, 255).astype(np.uint8)
