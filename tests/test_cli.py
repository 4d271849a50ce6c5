"""CLI surface: the reference's flags/defaults (src/args.hpp:19-67) plus
framework extras (backend routing, --unbiased, grad-image artifact)."""

import json

import numpy as np
import pytest

from drt_tpu import cli
from drt_tpu.utils.image import read_exr


def test_render_writes_exr(tmp_path):
    out = str(tmp_path / "img.exr")
    rc = cli.main(["render", "-o", out, "-x", "16", "-y", "12", "-n", "4",
                   "--max-depth", "3"])
    assert rc == 0
    img = read_exr(out)
    assert img.shape == (12, 16, 4)
    assert np.isfinite(img).all() and img[:, :, :3].mean() > 0


def test_grad_uses_resolved_backend_and_unbiased_flag(tmp_path, capsys):
    out = str(tmp_path / "g.json")
    rc = cli.main(["grad", "-o", out, "-x", "8", "-y", "6", "-n", "4",
                   "--max-depth", "3", "--unbiased",
                   "--adjoint-samples", "2"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "gradient backend: xla" in err  # CPU resolution
    data = json.load(open(out))
    assert data["unbiased"] is True
    assert data["backend"] == "xla"
    assert np.isfinite(np.asarray(data["d_albedo"])).all()
    assert np.abs(np.asarray(data["d_albedo"])).max() > 0


def test_grad_image_artifact(tmp_path, capsys):
    out = str(tmp_path / "grad.exr")
    rc = cli.main(["grad-image", "-o", out, "-x", "8", "-y", "6", "-n", "4",
                   "--max-depth", "4", "--param", "albedo:0"])
    assert rc == 0
    g_bp = read_exr(out)[:, :, :3]
    g_fw = read_exr(str(tmp_path / "grad-gt.exr"))[:, :, :3]
    assert np.abs(g_fw).max() > 1e-4
    # Written via half-float EXR; compare at half precision.
    np.testing.assert_allclose(g_bp, g_fw, rtol=2e-3, atol=2e-4)
    assert "max |backprop - jvp|" in capsys.readouterr().err


def test_invalid_spp_chunks_errors(tmp_path):
    with pytest.raises(ValueError, match="spp_chunks"):
        cli.main(["render", "-o", str(tmp_path / "x.exr"), "-n", "5",
                  "--spp-chunks", "2"])


def test_invalid_absorb_prob_errors(tmp_path):
    with pytest.raises(ValueError, match="absorb_prob"):
        cli.main(["render", "-o", str(tmp_path / "x.exr"), "-p", "1.0"])


def test_invert_steps_per_call_smoke(tmp_path, capsys):
    """`invert --steps-per-call` (the blocked train loop) end to end:
    tiny run writes the recovery JSON."""
    out = str(tmp_path / "inv.json")
    rc = cli.main(["invert", "-o", out, "-x", "8", "-y", "6", "-n", "4",
                   "--max-depth", "3", "--steps", "6",
                   "--steps-per-call", "4", "--log-every", "0"])
    assert rc == 0
    data = json.load(open(out))
    assert "recovered_albedo" in data and "final_loss" in data
