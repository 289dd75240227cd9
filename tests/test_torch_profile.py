"""The port's -profile (vkresample_tpu_torch/utils/profiling.py and the
CLI), its exports beside the JAX package's, and the engine surface run
with JAX and the JAX package absent."""
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vkresample_tpu_torch import cli
from vkresample_tpu_torch.io import png
from vkresample_tpu_torch.utils.profiling import maybe_trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _traces(d):
    return sorted(glob.glob(os.path.join(str(d), "*.pt.trace.json")))


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


@pytest.mark.parametrize("trace_dir", [None, ""])
def test_maybe_trace_without_a_dir_does_nothing(tmp_path, monkeypatch, trace_dir):
    monkeypatch.chdir(tmp_path)
    with maybe_trace(trace_dir):
        assert not torch.autograd.profiler._is_profiler_enabled
        torch.ones(4).sum()
    assert os.listdir(tmp_path) == []


def test_maybe_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    d = tmp_path / "trace"
    with maybe_trace(d):
        assert torch.autograd.profiler._is_profiler_enabled
        a = torch.ones(32, 32)
        (a @ a).sum()
    (path,) = _traces(d)
    names = {e.get("name") for e in _events(path)}
    assert any(n and "mm" in n for n in names), sorted(n for n in names if n)[:20]


def _sample(tmp_path):
    img = np.random.default_rng(4).integers(0, 256, (48, 64, 3), np.uint8)
    src = str(tmp_path / "in.png")
    png.write_png(src, img)
    return src


def test_cli_profile_writes_the_trace(tmp_path, capsys):
    src, d = _sample(tmp_path), tmp_path / "prof"
    rc = cli.main(["-i", src, "-o", str(tmp_path / "out.png"), "-u", "2", "-p", "2", "-n", "2",
                   "-profile", str(d)], device="cpu")
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "upscale: 64x48 to 128x96 Time: " in out
    (path,) = _traces(d)
    names = {e.get("name") for e in _events(path)}
    # the timed region's ops: the GEMMs of the transform and K1's plain version
    assert any(n and "matmul" in n for n in names)
    # and the port's spans around them (utils/profiling.py::SPANS)
    assert {"vkr.call", "vkr.layout", "vkr.precas", "vkr.codec", "vkr.cas"} <= names
    assert (tmp_path / "out.png").exists()


def test_profile_flag_is_accepted_and_listed(tmp_path, capsys):
    """-profile is no longer refused; without a value it traces nothing, as
    the JAX CLI does; -h lists it."""
    src = _sample(tmp_path)
    rc = cli.main(["-i", src, "-o", str(tmp_path / "o.png"), "-u", "2", "-profile"],
                  device="cpu")
    out = capsys.readouterr().out
    assert rc == 0 and "not ported" not in out, out
    assert cli.main(["-h"]) == 0
    assert "-profile DIR" in capsys.readouterr().out


# every name of the JAX package's __init__ but the sp mode's build_sp_upscale*
JAX_EXPORTS = ["Engine", "Precision", "ResampleConfig", "UpscalePlan", "output_dims",
               "factorize_7smooth", "is_7smooth", "plan_factors", "fft_convolve2d",
               "fft_matrix_convolve2d", "build_batched_upscale", "upscale_batch",
               "build_upscale", "upscale"]


def test_exports_cover_the_jax_package():
    import vkresample_tpu as jax_pkg
    import vkresample_tpu_torch as port

    jax_names = {n for n in vars(jax_pkg) if not n.startswith("_")
                 and not n.startswith("build_sp_upscale")
                 and callable(getattr(jax_pkg, n))}
    assert jax_names == set(JAX_EXPORTS)
    for name in JAX_EXPORTS:
        assert callable(getattr(port, name)), name
    assert port.output_dims(1080, 1920, 2.0) == jax_pkg.output_dims(1080, 1920, 2.0)
    assert port.plan_factors(2048) == jax_pkg.plan_factors(2048)
    assert port.ResampleConfig().sharpen == jax_pkg.ResampleConfig().sharpen


def test_engine_surface_runs_without_jax():
    """fft/ndim.py, ops/convolve.py and utils/profiling.py import and run
    with jax and the JAX package blocked."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['vkresample_tpu'] = None\n"
        "import numpy as np\n"
        "from vkresample_tpu_torch.fft.ndim import irfftn, rfftn\n"
        "from vkresample_tpu_torch.ops.convolve import fft_convolve2d, gaussian_kernel\n"
        "from vkresample_tpu_torch.utils.profiling import maybe_trace\n"
        "x = np.random.default_rng(0).standard_normal((2, 32, 48)).astype(np.float32)\n"
        "k = gaussian_kernel(32, 48, 2.0)\n"
        "want = np.real(np.fft.ifft2(np.fft.fft2(x) * np.fft.fft2(k.astype(np.float64))))\n"
        "with maybe_trace(None):\n"
        "    for eng in ('auto', 'xla'):\n"
        "        got = fft_convolve2d(x, k, engine=eng, device='cpu').numpy()\n"
        "        assert np.abs(got - want).max() < 1e-5, eng\n"
        "F = rfftn(x, axes=(-3, -2, -1), device='cpu')\n"
        "back = irfftn(F, s=x.shape, axes=(-3, -2, -1), device='cpu').numpy()\n"
        "assert np.abs(back - x).max() < 1e-5\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'vkresample_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr


@pytest.mark.cuda
def test_cuda_cli_profile_trace_names_the_kernels(tmp_path, capsys):
    """On the card: the quad route's trace (a 128-aligned width) holds K1's
    CUDA kernel and the transform's GEMMs as device kernel events."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    img = np.random.default_rng(4).integers(0, 256, (64, 128, 3), np.uint8)
    src, d = str(tmp_path / "in.png"), tmp_path / "prof"
    png.write_png(src, img)
    rc = cli.main(["-i", src, "-o", str(tmp_path / "out.png"), "-u", "2", "-p", "2", "-n", "2",
                   "-profile", str(d)])
    assert rc == 0, capsys.readouterr().out
    (path,) = _traces(d)
    kernels = {e["name"] for e in _events(path) if e.get("cat") == "kernel"}
    assert any("cas_grid_kernel<2" in n for n in kernels), sorted(kernels)
    assert any("gemm" in n.lower() for n in kernels), sorted(kernels)
