"""The port's sp pencil mode (vkresample_tpu_torch/parallel/distributed.py)
on the CPU: S = 2 and S = 4 gloo ranks started by parallel/launch.py::spawn,
one spawn per S running every case, the kernels' plain versions on the
ranks.  The gathered frames are held against the JAX package's
build_sp_upscale* on the virtual 8-device CPU mesh (tests/conftest.py), run
as tests/test_distributed.py runs them, and against the port's
single-process upscale(..., device="cpu"); both within 1 uint8 LSB, the
JAX package's own bar for its sp mode (different fusion and summation
order across program structures flip quantization ties).  The 64x96
frames pad the half spectrum's 49 columns to 50 (S = 2) and 52 (S = 4),
the rows form's kpad.

Also here: the collectives' layouts against numpy models (S = 3), the JAX
error cases on check_sp with the same match strings (no spawn), and the
two shard CAS forms in one process: K6 with shard-edge halo rows, and K3
on the halo-padded columns, each equal on every pixel to the whole-image
plain CAS."""
import numpy as np
import pytest
import torch

from conftest import make_test_image
from vkresample_tpu_torch import Engine, Precision, UpscalePlan, upscale
from vkresample_tpu_torch.ops.cas_cuda import (
    blocked_halo_rows,
    cas_quantize,
    cas_quantize_blocked_halo,
    cas_quantize_blocked_reference,
    cas_quantize_reference,
)
from vkresample_tpu_torch.parallel import distributed as sp
from vkresample_tpu_torch.parallel.launch import spawn
from vkresample_tpu_torch.parallel.sp_run import sp_frames

SHARDS = (2, 4)
SPAWN_TIMEOUT_S = 120

# case -> (form, h, w, u, precision, r2c, seed, the JAX builder or None):
# JAX's test sizes (tests/test_distributed.py), then -p 2 and -p 1 forms,
# which are held against the port's single-process upscale only
CASES = {
    "rows u=1": ("rows", 64, 96, 1.0, "SINGLE", True, 50, "build_sp_upscale"),
    "rows u=2": ("rows", 64, 96, 2.0, "SINGLE", True, 50, "build_sp_upscale"),
    "dense u=2": ("dense", 64, 64, 2.0, "SINGLE", True, 51, "build_sp_upscale_dense"),
    "staged -p 2": ("staged", 64, 256, 2.0, "HALF", True, 53, "build_sp_upscale_staged"),
    "grid u=3 -p 2": ("grid", 64, 256, 3.0, "HALF", True, 55, "build_sp_upscale_grid"),
    "grid 1.5x -p 2": ("grid", 64, 256, 1.5, "HALF", True, 55, "build_sp_upscale_grid"),
    "c2c grid u=2 -p 2": ("c2c_grid", 64, 256, 2.0, "HALF", False, 56,
                          "build_sp_upscale_c2c_grid"),
    "c2c grid 1.5x -p 2": ("c2c_grid", 64, 256, 1.5, "HALF", False, 56,
                           "build_sp_upscale_c2c_grid"),
    "rows u=2 -p 2": ("rows", 64, 96, 2.0, "HALF", True, 57, None),
    "rows u=3 -p 1": ("rows", 32, 48, 3.0, "DOUBLE", True, 58, None),
    "dense u=3 -p 2": ("dense", 32, 48, 3.0, "HALF", True, 59, None),
    "dense u=2 -p 1": ("dense", 32, 48, 2.0, "DOUBLE", True, 60, None),
    "staged -p 0": ("staged", 64, 256, 2.0, "SINGLE", True, 61, None),
    "grid u=3 -p 0": ("grid", 32, 128, 3.0, "SINGLE", True, 62, None),
    "c2c grid u=3 -p 1": ("c2c_grid", 32, 128, 3.0, "DOUBLE", False, 63, None),
}
JAX_CASES = [c for c, v in CASES.items() if v[-1]]


def _plan(case):
    form, h, w, u, prec, r2c, _, _ = CASES[case]
    return UpscalePlan(h=h, w=w, upscale=u, precision=Precision[prec], r2c=r2c,
                       engine=Engine.MXU)


def _frame(case):
    _, h, w, _, _, _, seed, _ = CASES[case]
    return make_test_image(h, w, 3, seed=seed)


def _maxdiff(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


@pytest.fixture(scope="module")
def sp_runs():
    """S -> case -> (gathered frame, the ranks' records): one spawn of S
    gloo ranks per S, every case in it."""
    cases = [(CASES[c][0], _plan(c), _frame(c)) for c in CASES]
    runs = {}
    for S in SHARDS:
        ranks = spawn(S, sp_frames, (cases, "cpu"), backend="gloo", timeout_s=SPAWN_TIMEOUT_S)
        runs[S] = {
            c: (sp.gather_blocks([r[i]["block"] for r in ranks], sp.OUTPUT_AXIS[CASES[c][0]]),
                [r[i] for r in ranks])
            for i, c in enumerate(CASES)
        }
    return runs


def _jax_sp(case, S):
    import jax
    from jax.sharding import Mesh

    from vkresample_tpu.core.config import Engine as JEngine
    from vkresample_tpu.core.config import Precision as JPrecision
    from vkresample_tpu.core.plan import UpscalePlan as JPlan
    from vkresample_tpu.parallel import distributed as jsp

    _, h, w, u, prec, r2c, _, builder = CASES[case]
    plan = JPlan(h=h, w=w, upscale=u, precision=JPrecision[prec], r2c=r2c,
                 engine=JEngine.MXU)
    mesh = Mesh(np.array(jax.devices()[:S]), axis_names=("sp",))
    return np.asarray(getattr(jsp, builder)(plan, mesh)(_frame(case)))


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("case", JAX_CASES)
def test_sp_matches_jax_sp(sp_runs, case, S):
    """The gathered frame is within 1 LSB of the JAX package's pencil
    builder of the same form over S devices."""
    got, _ = sp_runs[S][case]
    assert _maxdiff(got, _jax_sp(case, S)) <= 1


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("case", list(CASES))
def test_sp_matches_single_process_upscale(sp_runs, case, S):
    """The gathered frame is within 1 LSB of the port's own one-process
    upscale() of the plan, and each rank's block has the JAX out_specs
    shape: (H/S, W, C) rows or (H, W/S, C) columns."""
    got, ranks = sp_runs[S][case]
    plan = _plan(case)
    want = upscale(_frame(case), plan.upscale, plan=plan, device="cpu").numpy()
    assert _maxdiff(got, want) <= 1
    rows = CASES[case][0] == "rows"
    shape = (plan.H // S, plan.W, 3) if rows else (plan.H, plan.W // S, 3)
    assert all(r["block"].shape == shape for r in ranks)
    # on the CPU the wrappers take their plain versions: no kernel launches
    assert all(r["launches"] == {"K3": 0, "K3h": 0, "K6": 0} for r in ranks)
    assert all(r["peak_bytes"] is None and "ms" not in r for r in ranks)


# ---------------------------------------------------------------------------
# the collectives (S = 3) against numpy models of jax.lax's semantics
# ---------------------------------------------------------------------------


def _probe_models(S):
    """rank -> the inputs every rank builds, as sp_run.collectives_probe
    does."""
    from vkresample_tpu_torch.parallel.sp_run import probe_input

    return [probe_input(r, S) for r in range(S)]


def test_collectives_follow_jax_semantics():
    from vkresample_tpu_torch.parallel.sp_run import collectives_probe

    S = 3
    ranks = spawn(S, collectives_probe, (), timeout_s=SPAWN_TIMEOUT_S)
    xs = [x.numpy() for x in _probe_models(S)]
    for rank, got in enumerate(ranks):
        for (split, concat, dtype), out in got["all_to_all"].items():
            pieces = [np.split(x.astype(dtype), S, axis=split)[rank] for x in xs]
            np.testing.assert_array_equal(out.numpy(), np.concatenate(pieces, axis=concat))
        np.testing.assert_array_equal(got["all_gather"].numpy(), np.concatenate(xs, axis=-2))
        np.testing.assert_array_equal(got["psum"].numpy(), sum(x.astype(np.int32) for x in xs))
        above, below = got["halo_rows"]
        np.testing.assert_array_equal(above.numpy(), xs[max(rank - 1, 0)][..., [-1 if rank else 0], :])
        np.testing.assert_array_equal(below.numpy(),
                                      xs[min(rank + 1, S - 1)][..., [0 if rank < S - 1 else -1], :])
        left, right = got["halo_cols"]
        np.testing.assert_array_equal(left.numpy(), xs[max(rank - 1, 0)][..., [-1 if rank else 0]])
        np.testing.assert_array_equal(right.numpy(),
                                      xs[min(rank + 1, S - 1)][..., [0 if rank < S - 1 else -1]])


def test_spawn_reports_a_failing_rank():
    """A rank that raises fails the spawn with its traceback (here the
    builders' first check, on a fractional factor)."""
    plan = UpscalePlan(h=64, w=96, upscale=1.5)
    case = ("rows", plan, make_test_image(64, 96, 3, seed=1))
    with pytest.raises(RuntimeError, match="integer upscale factor"):
        spawn(2, sp_frames, ([case], "cpu"), timeout_s=SPAWN_TIMEOUT_S)


def test_spawn_kills_ranks_past_its_timeout():
    """Ranks still running when the timeout expires are killed and the
    spawn raises TimeoutError (0.5 s is shorter than a child's start)."""
    case = ("rows", UpscalePlan(h=64, w=96, upscale=2.0), make_test_image(64, 96, 3, seed=1))
    with pytest.raises(TimeoutError, match="killed"):
        spawn(2, sp_frames, ([case], "cpu"), timeout_s=0.5)


# ---------------------------------------------------------------------------
# the JAX package's sp errors (tests/test_distributed.py), same match strings
# ---------------------------------------------------------------------------

ERRORS = [
    ("rows", dict(h=36, w=64, upscale=2.0), 8, "shards"),
    ("rows", dict(h=64, w=96, upscale=1.5), 2, "integer"),
    ("dense", dict(h=64, w=64, upscale=1.5), 2, "integer"),
    ("staged", dict(h=64, w=256, upscale=1.5, precision=Precision.HALF), 2, "u=2"),
    ("staged", dict(h=36, w=256, upscale=2.0, precision=Precision.HALF), 8, "shards"),
    ("grid", dict(h=64, w=256, upscale=2.0, r2c=False, precision=Precision.HALF), 2, "r2c"),
    ("grid", dict(h=36, w=256, upscale=3.0, precision=Precision.HALF), 8, "shards"),
    ("c2c_grid", dict(h=64, w=256, upscale=2.0, precision=Precision.HALF), 2, "c2c"),
]


@pytest.mark.parametrize("form,kw,S,match", ERRORS,
                         ids=[f"{f} {kw['h']}x{kw['w']} u={kw['upscale']} S={S}"
                              for f, kw, S, _ in ERRORS])
def test_sp_rejects_what_jax_rejects(form, kw, S, match):
    """check_sp, the first step of every builder, raises the JAX
    package's ValueError with the message tests/test_distributed.py
    matches; the JAX builder raises it on the same plan and mesh."""
    import jax
    from jax.sharding import Mesh

    from vkresample_tpu.core.config import Precision as JPrecision
    from vkresample_tpu.core.plan import UpscalePlan as JPlan
    from vkresample_tpu.parallel import distributed as jsp

    plan = UpscalePlan(engine=Engine.MXU, **kw)
    with pytest.raises(ValueError, match=match):
        sp.check_sp(form, plan, S)
    jkw = dict(kw, precision=JPrecision[kw.get("precision", Precision.SINGLE).name])
    jbuilder = {"rows": "build_sp_upscale"}.get(form, f"build_sp_upscale_{form}")
    with pytest.raises(ValueError, match=match):
        getattr(jsp, jbuilder)(JPlan(**jkw), Mesh(np.array(jax.devices()[:S]), ("sp",)))


def test_sp_builders_need_a_card_unless_told_cpu():
    """With no card and no device named, a builder raises before touching
    the process group (core/config.py::resolve_device)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    plan = UpscalePlan(h=64, w=96, upscale=2.0)
    for builder in sp.BUILDERS.values():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            builder(plan)


def test_port_exports_the_jax_sp_builders():
    import vkresample_tpu as jax_pkg
    import vkresample_tpu_torch as port

    names = [n for n in vars(jax_pkg) if n.startswith("build_sp_upscale")]
    assert len(names) == 5
    for name in names:
        assert getattr(port, name) is sp.BUILDERS[{"build_sp_upscale": "rows"}.get(
            name, name.removeprefix("build_sp_upscale_"))]


def test_shard_rows_and_gather_blocks():
    img = np.arange(8 * 6 * 3, dtype=np.uint8).reshape(8, 6, 3)
    blocks = [sp.shard_rows(img, r, 4) for r in range(4)]
    assert all(b.shape == (2, 6, 3) for b in blocks)
    np.testing.assert_array_equal(sp.gather_blocks(blocks, 0), img)
    cols = [torch.from_numpy(img[:, 2 * r:2 * r + 2]) for r in range(3)]
    assert torch.equal(sp.gather_blocks(cols, 1), torch.from_numpy(img))
    with pytest.raises(ValueError, match="split"):
        sp.shard_rows(img, 0, 3)


# ---------------------------------------------------------------------------
# the shard CAS forms, in one process
# ---------------------------------------------------------------------------


def _pre_cas(shape, seed):
    """Pre-CAS values over [-0.1, 1.2): both clip branches and |v|."""
    return torch.from_numpy(
        np.random.default_rng(seed).random(shape, np.float32) * 1.3 - 0.1)


@pytest.mark.parametrize("bh", [1, 5, 7, 64])
@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_k6_halo_wrapper_on_shards_equals_whole_image(S, bh):
    """K6's shard wrapper on each of S row blocks of a (2, 48, 37) image,
    with the neighbouring blocks' edge rows (the image's own edge rows at
    its top and bottom) as halos, gives the whole-image plain K6 rows on
    every pixel, at every block height (the ragged last block included)."""
    v = _pre_cas((2, 48, 37), seed=10 * S + bh)
    want = cas_quantize_blocked_reference(v, *blocked_halo_rows(v, 64), 64, 0.2)
    r = 48 // S
    for rank in range(S):
        a, b = rank * r, (rank + 1) * r
        top = v[..., max(a - 1, 0):max(a - 1, 0) + 1, :].contiguous()
        bot = v[..., min(b, 47):min(b, 47) + 1, :].contiguous()
        got = cas_quantize_blocked_halo(v[..., a:b, :].contiguous(), top, bot, 0.2, bh)
        assert torch.equal(got, want[..., a:b, :]), rank


def test_k6_halo_wrapper_checks_its_halo_rows():
    v = _pre_cas((2, 8, 5), seed=3)
    good = v[..., :1, :].contiguous()
    with pytest.raises(ValueError, match="halo"):
        cas_quantize_blocked_halo(v, v[..., :2, :].contiguous(), good, 0.2)
    with pytest.raises(ValueError, match="halo"):
        cas_quantize_blocked_halo(v, good.double(), good, 0.2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_k3_on_halo_padded_columns_equals_whole_image(S, dtype):
    """K3 on each of S column blocks of a (2, 37, 48) image padded with
    the neighbouring blocks' edge columns (its own at the image's sides),
    the two halo columns cropped from its output, gives the whole-image
    plain K3 columns on every pixel."""
    v = _pre_cas((2, 37, 48), seed=S)
    if dtype == torch.int16:
        v = torch.round(v * 16384).to(torch.int16)
    want = cas_quantize_reference(v, 0.2)
    c = 48 // S
    for rank in range(S):
        a, b = rank * c, (rank + 1) * c
        left = v[..., max(a - 1, 0):max(a - 1, 0) + 1]
        right = v[..., min(b, 47):min(b, 47) + 1]
        got = cas_quantize(torch.cat([left, v[..., a:b], right], dim=-1), 0.2)[..., 1:-1]
        assert torch.equal(got, want[..., a:b]), rank
