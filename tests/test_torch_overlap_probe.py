"""The overlap probes of the port (lbm_tpu_torch.ops.overlap_probe, kernel
B11) on the CPU, against the TPU kernels they replace: the builders of
experiments/d2q9-overlap/probe.py, loaded from that file by its path and run
through `pl.pallas_call(..., interpret=True)`.

Rounding: each round is x * 1.0001 + 0.0001. Eager PyTorch (the port's plain
versions, and its kernels through __fmul_rn / __fadd_rn) and eager `jnp`
round the product and the sum apart, but XLA on the CPU fuses each round into
one FMA, under `jax.jit` and inside an interpret-mode `pallas_call` alike. So
at R = 0 the port equals the interpret-mode kernel bit for bit; at R >= 1 it
equals eager `probe._work` bit for bit and the interpret-mode kernel within
rtol = 1e-6 (a few units in the last place after three rounds).
"""

import ast
import contextlib
import functools
import importlib.util
import io
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu_torch.ops import overlap_probe as op

REPO = Path(__file__).resolve().parent.parent
PROBE = REPO / "experiments" / "d2q9-overlap" / "probe.py"
INTERPRET_RTOL = 1e-6  # XLA fuses each round into one FMA (module doc)

# (ny, nx, band) of each engine's case: band 8 where the halo rows need it,
# six bands for the depth-4 and depth-6 rings
SHAPES = {"auto_halo": (64, 128, 8), "auto_full": (64, 128, 8), "manual4": (96, 128, 16),
          "manual6": (96, 128, 16)}
DEFAULT_SHAPE = (48, 128, 16)
ALIASED = ("manual_alias", "manual_alias_safe", "auto_alias")


@functools.lru_cache(maxsize=None)
def probe():
    spec = importlib.util.spec_from_file_location("d2q9_overlap_probe", PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def probe_builders():
    """probe.py's engine table (`main`), with `xla` under the port's name."""
    p = probe()
    return {
        "auto": p.build_auto,
        "auto_par": functools.partial(p.build_auto, features=frozenset({"par"})),
        "auto_smem": functools.partial(p.build_auto, features=frozenset({"smem"})),
        "auto_halo": functools.partial(p.build_auto, features=frozenset({"halo"})),
        "auto_full": functools.partial(p.build_auto, features=frozenset({"smem", "halo"})),
        "manual": p.build_manual,
        "manual_flat": p.build_manual_flat,
        "manual_alias": p.build_manual_alias,
        "manual_alias_safe": p.build_manual_alias_safe,
        "auto_alias": p.build_auto_alias,
        "auto_flat": p.build_auto_flat,
        "manual3": functools.partial(p.build_manual_depth, depth=3),
        "manual4": functools.partial(p.build_manual_depth, depth=4),
        "manual6": functools.partial(p.build_manual_depth, depth=6),
        "torch": p.build_xla,
    }


def case(name, seed=0):
    ny, nx, band = SHAPES.get(name, DEFAULT_SHAPE)
    f = np.random.default_rng(seed).random((9, ny, nx), dtype=np.float32)
    return f, ny, nx, band


def tpu_kernel(name, f, ny, nx, band, rounds):
    """The TPU kernel in interpret mode (`torch`: eager build_xla)."""
    call = probe_builders()[name](ny, nx, band, rounds, interpret=True)
    return np.asarray(call(jnp.asarray(f)))


def port(name, f, ny, nx, band, rounds):
    return op.ENGINES[name](ny, nx, band, rounds)(torch.from_numpy(f.copy())).numpy()


def eager_reference(name, f, band, rounds):
    """Eager `probe._work` (one round at least for `torch`), with the halo
    rows added in float32 for the halo engines."""
    x = np.array(probe()._work(jnp.asarray(f), max(rounds, 1) if name == "torch" else rounds))
    if name in ("auto_halo", "auto_full"):
        ny = f.shape[1]
        starts = np.arange(0, ny, band)
        ends = starts + band - 1
        x[:, starts] += f[:, (starts - 1) % ny]
        x[:, ends] += f[:, (ends + 1) % ny]
    return x


def test_engine_table_is_probe_py_s():
    """ENGINES holds the names of probe.py's --engines choices, `xla` as `torch`."""
    tree = ast.parse(PROBE.read_text())
    choices = next(kw.value for node in ast.walk(tree) if isinstance(node, ast.Call)
                   for kw in node.keywords
                   if kw.arg == "choices" and isinstance(kw.value, ast.List))
    names = [ast.literal_eval(e) for e in choices.elts]
    assert sorted(op.ENGINES) == sorted("torch" if n == "xla" else n for n in names)
    assert sorted(op.ENGINES) == sorted(probe_builders())


@pytest.mark.parametrize("name", sorted(op.ENGINES))
def test_r0_is_bit_equal_to_the_tpu_kernel(name):
    f, ny, nx, band = case(name)
    ref = tpu_kernel(name, f, ny, nx, band, 0)
    np.testing.assert_array_equal(port(name, f, ny, nx, band, 0), ref)


@pytest.mark.parametrize("rounds", [1, 3])
@pytest.mark.parametrize("name", sorted(op.ENGINES))
def test_rounds_are_bit_equal_to_eager_work(name, rounds):
    f, ny, nx, band = case(name, seed=rounds)
    got = port(name, f, ny, nx, band, rounds)
    np.testing.assert_array_equal(got, eager_reference(name, f, band, rounds))
    np.testing.assert_allclose(got, tpu_kernel(name, f, ny, nx, band, rounds),
                               rtol=INTERPRET_RTOL, atol=0)


@pytest.mark.parametrize("name", ["auto_smem", "auto_full"])
def test_smem_total_matches_a_float64_sum(name):
    f, ny, nx, band = case(name, seed=5)
    probe_ = op.ENGINES[name](ny, nx, band, 2)
    probe_(torch.from_numpy(f))
    ref = f[0, ::band, :op.SMEM_COLS].astype(np.float64).sum()
    assert probe_.total.dtype == torch.float32 and probe_.total.dim() == 0
    np.testing.assert_allclose(float(probe_.total), ref, rtol=1e-6)
    partials = op.smem_partials_plain(torch.from_numpy(f), band)
    np.testing.assert_allclose(partials.numpy(), f[0, ::band, :op.SMEM_COLS].sum(axis=1),
                               rtol=1e-6)


# (engine, ny, nx, band): probe.py raises too
PROBE_RAISES = [
    ("manual", 16, 128, 16),             # nb < 2
    ("manual_alias", 16, 128, 16),       # nb < 2
    ("manual3", 32, 128, 16),            # nb < depth
    ("manual6", 80, 128, 16),            # nb < depth
    ("manual_flat", 16, 128, 16),        # nb < depth (2)
    ("manual_alias_safe", 32, 128, 16),  # nb < 3
]
# the port's own: the TPU grid would drop rows or the card cannot copy
PORT_RAISES = [
    ("auto", 40, 128, 16, "multiple of the band"),
    ("manual", 40, 128, 16, "multiple of the band"),
    ("auto_halo", 48, 128, 12, "band % 8"),
    ("auto_smem", 48, 64, 16, "nx >= 128"),
    ("manual", 48, 130, 16, "nx % 4"),
]


@pytest.mark.parametrize("name, ny, nx, band", PROBE_RAISES)
def test_builders_refuse_what_probe_py_refuses(name, ny, nx, band):
    with pytest.raises(ValueError):
        probe_builders()[name](ny, nx, band, 0, interpret=True)
    with pytest.raises(ValueError, match="bands"):
        op.ENGINES[name](ny, nx, band, 0)
    # one more band and both build
    probe_builders()[name](ny + band, nx, band, 0, interpret=True)
    op.ENGINES[name](ny + band, nx, band, 0)


@pytest.mark.parametrize("name, ny, nx, band, match", PORT_RAISES)
def test_builders_refuse_what_the_card_cannot_run(name, ny, nx, band, match):
    with pytest.raises(ValueError, match=match):
        op.ENGINES[name](ny, nx, band, 0)


def test_strided_names_the_manual_engines_that_copy_tiles():
    manual = {name for name, build in op.ENGINES.items() if name != "torch"
              and build(96, 128, 16, 0).kind == "manual" and not build(96, 128, 16, 0).flat}
    assert manual == set(op.STRIDED)


@pytest.mark.parametrize("name", op.STRIDED)
def test_strided_engines_in_row_tiles_compute_the_same(name):
    """The tile is the card's unit of copies: (9, 1, 512) tiles change the
    copies a stage, not the result."""
    f, ny, nx, band = case(name, seed=9)
    probe_ = op.ENGINES[name](ny, nx, band, 3, tile=op.ROW_TILE)
    assert probe_.tile == op.ROW_TILE and probe_.tiles() == ny  # a tile a row at nx < 512
    got = probe_(torch.from_numpy(f.copy())).numpy()
    np.testing.assert_array_equal(got, eager_reference(name, f, band, 3))
    np.testing.assert_array_equal(got, port(name, f, ny, nx, band, 3))


@pytest.mark.parametrize("name, tile, match", [
    ("manual", (1, 510), "bx % 4"),
    ("manual6", (16, 64), "shared memory"),  # 2 x 6 x 9 x 16 x 64 x 4 B = 432 KB
    ("manual_alias_safe", (0, 32), "positive"),
])
def test_strided_engines_refuse_tiles_the_card_cannot_run(name, tile, match):
    ny, nx, band = SHAPES.get(name, DEFAULT_SHAPE)
    with pytest.raises(ValueError, match=match):
        op.ENGINES[name](ny, nx, band, 0, tile=tile)


@pytest.mark.parametrize("name", ALIASED)
def test_aliased_engines_update_their_input_in_place(name):
    f, ny, nx, band = case(name, seed=7)
    x = torch.from_numpy(f.copy())
    probe_ = op.ENGINES[name](ny, nx, band, 2)
    assert probe_(x) is x
    np.testing.assert_array_equal(x.numpy(), eager_reference(name, f, band, 2))
    with pytest.raises(ValueError, match="aliased"):
        probe_(x, out=torch.empty_like(x))


def test_two_stream_engines_leave_their_input_and_fill_out():
    f, ny, nx, band = case("manual", seed=8)
    x = torch.from_numpy(f.copy())
    out = torch.empty_like(x)
    before = op.launches
    assert op.build_manual(ny, nx, band, 2)(x, out=out) is out
    np.testing.assert_array_equal(x.numpy(), f)
    np.testing.assert_array_equal(out.numpy(), eager_reference("manual", f, band, 2))
    with pytest.raises(ValueError, match="apart from its input"):
        op.build_auto(ny, nx, band, 2)(x, out=x)
    assert op.launches == before  # the CPU runs the plain version


def test_probe_refuses_other_states():
    probe_ = op.build_auto(48, 128, 16, 1)
    with pytest.raises(ValueError, match="shape"):
        probe_(torch.zeros((9, 48, 64)))
    with pytest.raises(ValueError, match="float32"):
        probe_(torch.zeros((9, 48, 128), dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        probe_(torch.zeros((9, 128, 48)).transpose(1, 2))


def test_analyze_prints_what_probe_py_prints():
    csv_path = PROBE.with_name("probe.csv")
    want, got = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(want):
        probe().analyze(str(csv_path))
    with contextlib.redirect_stdout(got):
        op.analyze(str(csv_path))
    assert got.getvalue() == want.getvalue()
    assert "overlap_frac" in got.getvalue()


@pytest.mark.parametrize("nx, aligned, path", [
    (128, True, "tma"),      # rows of whole 16-byte pieces
    (4096, True, "tma"),     # the sweep's grid
    (130, True, "values"),   # nx % 4 == 2
    (250, True, "values"),
    (129, True, "values"),
    (128, False, "values"),  # a state or output off 16 bytes
])
def test_auto_path_by_width_and_alignment(nx, aligned, path):
    assert op.auto_path(nx, aligned) == path


AUTO = sorted(e for e in op.ENGINES if e.startswith("auto"))


@pytest.mark.parametrize("name", AUTO)
def test_auto_engines_at_a_width_tma_cannot_take_match_the_tpu_kernel(name):
    """nx = 250 (rows of 1,000 B): on the card the one-value path; on the
    CPU the plain version, bit-equal to the interpret-mode kernel at R = 0
    and to eager work at R = 2."""
    ny, nx, band = 64, 250, 16 if name not in ("auto_halo", "auto_full") else 8
    f = np.random.default_rng(13).random((9, ny, nx), dtype=np.float32)
    np.testing.assert_array_equal(port(name, f, ny, nx, band, 0),
                                  tpu_kernel(name, f, ny, nx, band, 0))
    np.testing.assert_array_equal(port(name, f, ny, nx, band, 2),
                                  eager_reference(name, f, band, 2))


@pytest.mark.parametrize("name", AUTO)
def test_auto_engines_take_a_state_off_16_bytes(name):
    """A contiguous state 4 bytes past its storage's start (on the card: the
    one-value path) gives what an aligned copy of it gives."""
    ny, nx, band = 48, 128, 16
    f = np.random.default_rng(17).random((9, ny, nx), dtype=np.float32)
    x = torch.zeros(f.size + 1)[1:].view(f.shape)
    x.copy_(torch.from_numpy(f))
    assert x.data_ptr() % 16 and x.is_contiguous()
    got = op.ENGINES[name](ny, nx, band, 2)(x)
    np.testing.assert_array_equal(got.numpy(), port(name, f, ny, nx, band, 2))
