"""The blur runner and CLI of the port (lbm_tpu_torch.models.blur,
lbm_tpu_torch.cli.blur) on the CPU, end to end against
lbm_tpu.models.blur.blur_image on the same numpy-seeded RGBA array.

Tolerance: uint8 outputs within one level per value. The float32 states of
the two packages agree to about 1e-6 (tests/test_torch_stencil.py), which
can move a value across a rounding boundary of `to_char_image`, never
further.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.models import blur as ref_blur
from lbm_tpu_torch.cli import blur as cli
from lbm_tpu_torch.models import blur
from lbm_tpu_torch.utils import image as img_lib


def rgba_case(seed=11, h=24, w=40):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, 4), dtype=np.uint8)


# the port's keywords beside the reference's
CASES = {
    "conv": (dict(engine="conv"), dict(engine="conv")),
    "cuda": (dict(engine="cuda"), dict(engine="pallas")),
    "cuda-k4": (dict(engine="cuda", k_passes=4), dict(engine="pallas", k_passes=4)),
    "resident": (dict(engine="resident"), dict(engine="resident")),
    "auto": (dict(engine="auto"), dict(engine="auto")),
    "conv-half": (dict(engine="conv", dtype=torch.bfloat16),
                  dict(engine="conv", dtype=jnp.bfloat16)),
    "auto-half": (dict(engine="auto", dtype=torch.bfloat16),
                  dict(engine="auto", dtype=jnp.bfloat16)),
    "cuda-blur-alpha": (dict(engine="cuda", blur_alpha=True),
                        dict(engine="pallas", blur_alpha=True)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_blur_image_matches_lbm_tpu_within_one_level(name):
    port_kw, ref_kw = CASES[name]
    rgba = rgba_case()
    out, seconds = blur.blur_image(rgba, num_iters=2, device="cpu", **port_kw)
    expected, _ = ref_blur.blur_image(rgba, num_iters=2, **ref_kw)
    assert out.shape == rgba.shape and out.dtype == np.uint8
    assert seconds > 0
    # bfloat16 through the conv engine: each library accumulates as it likes
    bar = 2 if name == "conv-half" else 1
    assert np.abs(out.astype(int) - expected.astype(int)).max() <= bar
    if "blur_alpha" not in port_kw:
        np.testing.assert_array_equal(out[..., 3], expected[..., 3])
    assert not np.array_equal(out[..., :3], rgba[..., :3])  # it did blur


def test_run_blur_reports_the_engine_and_the_state():
    rgba = rgba_case()
    run = blur.run_blur(rgba, num_iters=2, engine="auto", device="cpu")
    assert (run.engine, run.k_passes) == ("resident", None)
    assert run.state.shape == (4, 32, 128) and run.state.dtype == np.float32
    ring = np.ones((32, 128), bool)
    ring[1:25, 1:41] = False
    assert np.all(run.state[:, ring] == 0.0)  # the pad ring stays exactly zero
    explicit = blur.run_blur(rgba, num_iters=2, engine="resident", device="cpu")
    np.testing.assert_array_equal(run.rgba, explicit.rgba)


@pytest.mark.parametrize("num_iters,k_passes,expected", [
    (100, None, ("cuda", 4)), (3, None, ("cuda", 2)), (100, 8, ("cuda", 8))])
def test_auto_goes_to_the_k_pass_engine_beyond_resident(num_iters, k_passes, expected):
    big = torch.empty((4, 4128, 4224), device="meta")
    assert blur.choose_engine(big, num_iters, k_passes) == expected
    small = torch.empty((4, 320, 512), device="meta")
    assert blur.choose_engine(small, num_iters, k_passes) == ("resident", k_passes)


def test_blur_image_rejects_what_is_not_ported_or_unknown():
    rgba = rgba_case()
    with pytest.raises(ValueError, match="num_devices applies to engine 'conv-sharded' only"):
        blur.blur_image(rgba, engine="conv", num_devices=2, device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        blur.blur_image(rgba, engine="pallas", device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        blur.blur_image(rgba, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        blur.blur_image(rgba, num_iters=3, engine="cuda", k_passes=4, device="cpu")


def test_blur_file_and_cli_write_the_png(tmp_path, capsys):
    rgba = rgba_case(h=30, w=50)
    img_lib.save_png(tmp_path / "in.png", rgba)
    run = blur.blur_file(tmp_path / "in.png", tmp_path / "file.png", num_iters=3,
                         engine="cuda", k_passes=2, device="cpu")
    np.testing.assert_array_equal(img_lib.load_png(tmp_path / "file.png"), run.rgba)

    rc = cli.main(["-i", str(tmp_path / "in.png"), "-o", str(tmp_path / "cli.png"), "-n", "3",
                   "--engine", "cuda", "--k-passes", "2", "--band", "8", "--device", "cpu"])
    assert rc == 0
    np.testing.assert_array_equal(img_lib.load_png(tmp_path / "cli.png"), run.rgba)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "engine:\tcuda (k_passes 2)"
    assert lines[-1].startswith("3(x2) iterations took ") and lines[-1].endswith(" us)")

    # the same file through the reference's CLI path
    expected, _ = ref_blur.blur_image(rgba, num_iters=3, engine="pallas", k_passes=2)
    assert np.abs(run.rgba.astype(int) - expected.astype(int)).max() <= 1


@pytest.mark.parametrize("flags", [["--data-type", "half"], ["--engine", "auto"],
                                   ["--engine", "resident", "--blur-alpha"]])
def test_cli_flags_on_the_cpu(tmp_path, capsys, flags):
    img_lib.save_png(tmp_path / "in.png", rgba_case())
    rc = cli.main(["-i", str(tmp_path / "in.png"), "-o", str(tmp_path / "out.png"), "-n", "2",
                   "--device", "cpu", *flags])
    assert rc == 0
    out = img_lib.load_png(tmp_path / "out.png")
    assert out.shape == (24, 40, 4)
    text = capsys.readouterr().out
    assert "2(x2) iterations took" in text
    if "auto" in flags:
        assert "engine:\tresident" in text


@pytest.mark.parametrize("flags,item", [
    (["--engine", "conv", "--num-devices", "4"], "--num-devices applies to --engine conv-sharded"),
    (["--num-devices", "4"], "--num-devices applies to --engine conv-sharded")])
def test_cli_rejects_what_is_not_ported_and_names_the_roadmap_item(tmp_path, capsys, flags, item):
    # the multi-device blur is ported (conv-sharded); its --num-devices
    # belongs to that engine alone. --compile-only and --export are ported
    # (test_cli_compile_only_exports_the_conv_pass)
    img_lib.save_png(tmp_path / "in.png", rgba_case())
    with pytest.raises(SystemExit) as err:
        cli.main(["-i", str(tmp_path / "in.png"), "-o", str(tmp_path / "out.png"),
                  "--device", "cpu", *flags])
    assert err.value.code != 0
    assert item in capsys.readouterr().err
    assert not (tmp_path / "out.png").exists()


@pytest.mark.parametrize("flags,dtype", [([], "float32"), (["--export"], "float32"),
                                         (["--data-type", "half", "--export"], "bfloat16")])
def test_cli_compile_only_exports_the_conv_pass(tmp_path, capsys, flags, dtype):
    # no -o: nothing is blurred; the pass is exported at the padded shape of
    # the runtime path (4, 24 -> 32, 40 -> 128), as the reference's CLI does
    img_lib.save_png(tmp_path / "in.png", rgba_case())
    export = [str(tmp_path / "pass.pt2")] if "--export" in flags else []
    assert cli.main(["-i", str(tmp_path / "in.png"), "--device", "cpu", "--compile-only",
                     *flags, *export]) == 0
    text = capsys.readouterr().out
    assert f"ops.stencil.blur_step_conv on cpu, (4, 32, 128) {dtype}" in text
    assert (tmp_path / "pass.pt2").exists() == bool(export)
    if export:
        assert f"bytes to {export[0]}" in text
