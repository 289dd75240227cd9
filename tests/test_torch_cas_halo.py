"""The shard CAS of the sp pencil mode with its halos read by pointer:
K6 on a row shard as one block (cas_quantize_blocked_halo, the rows form)
and K3's column-halo entry on a column shard (cas_quantize_cols_halo, the
dense, staged, grid and c2c grid forms), their plain versions on the CPU
against the whole image's plain CAS and against the forms they replace
(the gathered per-block halo arrays of 64-row blocks; [left | v | right]
through K3 and the crop), and parallel/distributed.py's _cas_rows and
_cas_cols on each rank of S = 1..4 with the halo exchange stubbed by the
neighbours' edge rows or columns.  All on every pixel: the same
arithmetic on the same values.  The tests marked cuda hold the kernels
against their plain versions with halos that are not the image's own
rows or columns, so a kernel that ignores its halos fails; they need a
card and do not import JAX (run with --noconftest)."""
import numpy as np
import pytest
import torch

from vkresample_tpu_torch.ops.cas_cuda import (
    blocked_halo_rows,
    cas_quantize,
    cas_quantize_blocked,
    cas_quantize_blocked_halo,
    cas_quantize_blocked_reference,
    cas_quantize_blocked_rows,
    cas_quantize_cols_halo,
    cas_quantize_cols_halo_reference,
    cas_quantize_reference,
)
from vkresample_tpu_torch.parallel import distributed as sp

SHARDS = (1, 2, 3, 4)
PARENT_BLOCK_ROWS = 64  # the rows form's K6 block height before the shard was one block


def _pre_cas(shape, seed, dtype=torch.float32):
    """Pre-CAS values over [-0.1, 1.2): both clip branches and |v|; int16
    as Q2.14."""
    v = torch.from_numpy(np.random.default_rng(seed).random(shape, np.float32) * 1.3 - 0.1)
    return torch.round(v * 16384).to(torch.int16) if dtype == torch.int16 else v


def _row_halos(whole, a, b):
    """The rows above and below whole[..., a:b, :], clamped at the edges."""
    H = whole.shape[-2]
    up, down = max(a - 1, 0), min(b, H - 1)
    return whole[..., up:up + 1, :].contiguous(), whole[..., down:down + 1, :].contiguous()


def _col_halos(whole, a, b):
    """The columns west and east of whole[..., a:b], clamped at the edges."""
    W = whole.shape[-1]
    west, east = max(a - 1, 0), min(b, W - 1)
    return whole[..., west:west + 1].contiguous(), whole[..., east:east + 1].contiguous()


# ---------------------------------------------------------------------------
# K3 on a column block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("S", SHARDS)
def test_cols_halo_on_column_blocks_equals_whole_image(S, dtype):
    """The column-halo plain version (and the wrapper on CPU tensors) on
    each of S column blocks of a (2, 37, 48) image, with the neighbouring
    blocks' edge columns (its own at the image's sides) as halos, gives
    the whole-image plain K3 columns on every pixel."""
    v = _pre_cas((2, 37, 48), seed=20 + S, dtype=dtype)
    want = cas_quantize_reference(v, 0.2)
    c = 48 // S
    for rank in range(S):
        a, b = rank * c, (rank + 1) * c
        left, right = _col_halos(v, a, b)
        block = v[..., a:b].contiguous()
        got = cas_quantize_cols_halo_reference(block, left, right, 0.2)
        assert got.dtype == torch.uint8 and got.is_contiguous()
        assert torch.equal(got, want[..., a:b]), rank
        assert torch.equal(cas_quantize_cols_halo(block, left, right, 0.2), got), rank


def test_cols_halo_reads_its_halo_columns():
    """A wrong halo column changes exactly the output column beside it."""
    v = _pre_cas((1, 24, 40), seed=7)
    left, right = v[..., :1].contiguous(), v[..., -1:].contiguous()
    want = cas_quantize_cols_halo_reference(v, left, right, 0.2)
    assert torch.equal(want, cas_quantize_reference(v, 0.2))
    got = cas_quantize_cols_halo_reference(v, torch.ones_like(left), torch.zeros_like(right), 0.2)
    changed = (got != want).any(dim=-2)[0].nonzero().flatten().tolist()
    assert changed == [0, 39]


def test_cols_halo_wrapper_on_cpu_launches_nothing():
    """On CPU tensors the wrapper returns its plain version's output
    (leading dims kept) and launches nothing."""
    v = _pre_cas((2, 3, 10, 20), seed=8)
    left, right = _pre_cas((2, 3, 10, 1), seed=9), _pre_cas((2, 3, 10, 1), seed=10)
    before = cas_quantize_cols_halo.launches
    got = cas_quantize_cols_halo(v, left, right, 0.2)
    assert got.shape == v.shape
    assert torch.equal(got, cas_quantize_cols_halo_reference(v, left, right, 0.2))
    assert cas_quantize_cols_halo.launches == before


@pytest.mark.parametrize("bad", ["two columns", "short column", "no column axis",
                                 "float64 halo", "int16 halo", "float32 halo"])
def test_cols_halo_checks_its_halo_columns(bad):
    """Halo columns must be (..., H, 1), contiguous, of v's dtype."""
    dtype = torch.int16 if bad == "float32 halo" else torch.float32
    v = _pre_cas((2, 8, 5), seed=3, dtype=dtype)
    good = v[..., :1].contiguous()
    halo = {"two columns": v[..., :2].contiguous(),
            "short column": v[..., :7, :1].contiguous(),
            "no column axis": v[..., 0].contiguous(),
            "float64 halo": good.double(),
            "int16 halo": good.to(torch.int16),
            "float32 halo": good.float()}[bad]
    for fn in (cas_quantize_cols_halo, cas_quantize_cols_halo_reference):
        with pytest.raises(ValueError, match="halo"):
            fn(v, halo, good, 0.2)
        with pytest.raises(ValueError, match="halo"):
            fn(v, good, halo, 0.2)


# ---------------------------------------------------------------------------
# K6 on a row shard as one block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", SHARDS)
def test_k6_shard_as_one_block_equals_gathered_blocks(S):
    """K6's shard wrapper with its default (the shard one block, the
    neighbours' edge rows its only halos) on each of S row blocks of a (2,
    144, 37) image equals the parent's form, 64-row blocks with their halo
    rows gathered and the outer two overwritten, and the whole image's
    plain K6 rows, on every pixel."""
    v = _pre_cas((2, 144, 37), seed=30 + S)
    want = cas_quantize_blocked(v, 0.2)
    r = 144 // S
    for rank in range(S):
        a, b = rank * r, (rank + 1) * r
        top, bot = _row_halos(v, a, b)
        shard = v[..., a:b, :].contiguous()
        got = cas_quantize_blocked_halo(shard, top, bot, 0.2)
        htop, hbot = blocked_halo_rows(shard, PARENT_BLOCK_ROWS)
        htop[..., :1, :], hbot[..., -1:, :] = top, bot
        parent = cas_quantize_blocked_reference(shard, htop, hbot, PARENT_BLOCK_ROWS, 0.2)
        assert torch.equal(got, parent), rank
        assert torch.equal(got, want[..., a:b, :]), rank
        assert torch.equal(got, cas_quantize_blocked_rows(shard, top, bot, r, 0.2)), rank


def test_k6_rows_entry_checks_its_halo_rows():
    """cas_quantize_blocked_rows takes the kernel's arguments: halo rows
    (..., ceil(H/bh), W) of float32, a block height >= 1."""
    v = _pre_cas((2, 8, 5), seed=4)
    top, bot = blocked_halo_rows(v, 3)
    with pytest.raises(ValueError, match="share device, dtype and shape"):
        cas_quantize_blocked_rows(v, top[:, :2].contiguous(), bot, 3, 0.2)
    with pytest.raises(ValueError, match="share device, dtype and shape"):
        cas_quantize_blocked_rows(v, top.double(), bot, 3, 0.2)
    with pytest.raises(ValueError, match="block_rows"):
        cas_quantize_blocked_rows(v, top, bot, 0, 0.2)
    with pytest.raises(TypeError, match="float32"):
        cas_quantize_blocked_rows(v.double(), top, bot, 3, 0.2)


# ---------------------------------------------------------------------------
# _cas_rows and _cas_cols against the forms they replace
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", SHARDS)
def test_cas_rows_equals_the_gathered_form(S, monkeypatch):
    """parallel/distributed.py::_cas_rows on each rank of S, its halo
    exchange stubbed by the neighbouring shards' edge rows, equals the
    parent's gathered form (64-row blocks, blocked_halo_rows with the outer
    halos overwritten, K6's plain version) on every pixel."""
    whole = _pre_cas((3, 96, 40), seed=40 + S)
    r = 96 // S
    for rank in range(S):
        a, b = rank * r, (rank + 1) * r
        above, below = _row_halos(whole, a, b)
        monkeypatch.setattr(sp, "_halo_rows", lambda x, group: (above, below))
        v = whole[..., a:b, :].contiguous()
        top, bot = blocked_halo_rows(v, PARENT_BLOCK_ROWS)
        top[..., :1, :], bot[..., -1:, :] = above, below
        want = cas_quantize_blocked_reference(v, top, bot, PARENT_BLOCK_ROWS, 0.2)
        assert torch.equal(sp._cas_rows(v, 0.2, None), want), rank


@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("S", SHARDS)
def test_cas_cols_equals_the_padded_form(S, dtype, monkeypatch):
    """parallel/distributed.py::_cas_cols on each rank of S, its halo
    exchange stubbed by the neighbouring blocks' edge columns, equals the
    parent's padded form (K3 on [left | v | right], the halo columns
    cropped) on every pixel."""
    whole = _pre_cas((3, 37, 48), seed=50 + S, dtype=dtype)
    c = 48 // S
    for rank in range(S):
        a, b = rank * c, (rank + 1) * c
        left, right = _col_halos(whole, a, b)
        monkeypatch.setattr(sp, "_halo_cols", lambda x, group: (left, right))
        v = whole[..., a:b].contiguous()
        want = cas_quantize(torch.cat([left, v, right], dim=-1), 0.2)[..., 1:-1]
        assert torch.equal(sp._cas_cols(v, 0.2, None), want), rank


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    return torch.Generator(device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 2160, 3840), (3, 1024, 4096), (2, 37, 201),
                                   (2, 130, 136), (1, 1, 1)])
def test_cuda_k6_reads_its_halo_rows(shape):
    """K6's block-local instance with random top and bot rows (not v's own
    rows) equals its plain version on every pixel at every block height:
    bh = 1, odd, the 64-row band, the whole image and more."""
    g = _card().manual_seed(sum(shape))
    v = torch.rand(shape, generator=g, device="cuda") * 1.3 - 0.1
    H, W = shape[-2:]
    for bh in sorted({1, 7, 64, 100, H, H + 5}):
        nb = -(-H // bh)
        top, bot = (torch.rand(shape[:-2] + (nb, W), generator=g, device="cuda") * 1.3 - 0.1
                    for _ in range(2))
        before = cas_quantize_blocked.launches
        got = cas_quantize_blocked_rows(v, top, bot, bh, 0.2)
        torch.cuda.synchronize()
        assert cas_quantize_blocked.launches == before + 1
        assert torch.equal(got, cas_quantize_blocked_reference(v, top, bot, bh, 0.2)), bh


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int16, torch.float32])
@pytest.mark.parametrize("shape", [(3, 2048, 1024), (3, 2160, 960), (2, 37, 201),
                                   (2, 37, 200), (2, 65, 131), (2, 40, 1), (1, 1, 1)])
def test_cuda_cols_halo_reads_its_halo_columns(shape, dtype):
    """K3's column-halo entry with random halo columns (not v's own
    columns) equals its plain version on every pixel, on the 16-byte and
    the per-element staging, at one column and at one row."""
    g = _card().manual_seed(sum(shape) + 1)
    v, left, right = (torch.rand(s, generator=g, device="cuda") * 1.3 - 0.1
                      for s in (shape, shape[:-1] + (1,), shape[:-1] + (1,)))
    if dtype == torch.int16:
        v, left, right = (torch.round(t * 16384).to(torch.int16) for t in (v, left, right))
    before = cas_quantize_cols_halo.launches
    got = cas_quantize_cols_halo(v, left, right, 0.2)
    torch.cuda.synchronize()
    assert cas_quantize_cols_halo.launches == before + 1
    assert torch.equal(got, cas_quantize_cols_halo_reference(v, left, right, 0.2))
