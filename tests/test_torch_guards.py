"""Guards of the port: it never imports JAX, never guesses a device and
never falls back from the CUDA kernel to its plain version."""

import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from colormipsearch_torch.cds import kernels  # noqa: E402
from colormipsearch_torch.cds import multimask as mm  # noqa: E402
from colormipsearch_torch.cds.pixel_active import (  # noqa: E402
    ActiveTilePixelEngine, ActiveTiles)
from colormipsearch_torch.cmd.main import build_parser, main  # noqa: E402
from colormipsearch_torch.device import resolve_device  # noqa: E402


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import colormipsearch_torch, colormipsearch_torch.device\n"
        "import colormipsearch_torch.cmd.main as m\n"
        "import colormipsearch_torch.cmd.colordepthsearch_cmd\n"
        "import colormipsearch_torch.parallel.twophase_sweep\n"
        "import colormipsearch_torch.cds.kernels\n"
        "import colormipsearch_torch.cds.multimask\n"
        "import colormipsearch_torch.cds.pixel_active\n"
        "import colormipsearch_torch.cds.prescreen\n"
        "import colormipsearch_torch.cds.ratio_bounds\n"
        "m.build_parser()\n"
        "bad = sorted(k for k in sys.modules if k == 'jax'\n"
        "             or k.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print('no jax')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "no jax" in r.stdout


def test_cuda_device_without_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main(["colorDepthSearch", "-m", str(tmp_path / "m.json"),
              "-i", str(tmp_path / "t.json"), "--device", "cuda"])
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def _fake(device):
    return types.SimpleNamespace(device=torch.device(device))


def test_kernel_wrapper_never_falls_back(monkeypatch, tmp_path):
    """A CUDA-typed call with no buildable kernel raises; the plain
    version is never run in its place."""
    monkeypatch.setattr(kernels, "find_nvcc", lambda: None)
    monkeypatch.setattr(kernels, "_loaded", None)
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))

    def plain(*a, **k):
        raise AssertionError("plain version ran for CUDA tensors")

    monkeypatch.setattr(mm, "multimask_counts_plain", plain)
    args = [_fake("cuda:0") for _ in range(9)]
    before = mm.multimask_counts.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        mm.multimask_counts(*args, 2, True)
    with pytest.raises(ValueError, match="all on one CUDA device"):
        mm.multimask_counts(*([_fake("cpu")] + args[1:]), 2, True)
    assert mm.multimask_counts.launches == before


def test_cli_dispatch_table():
    sub = next(a for a in build_parser()._actions
               if isinstance(a.choices, dict))
    assert set(sub.choices) >= {
        "colorDepthSearch", "gradientScores", "normalizeGradientScores",
        "createColorDepthSearchDataInput", "importPPPResults", "exportData",
        "tag", "copyToMipsStore", "validateDBData", "deleteCDMatches"}
    from colormipsearch_torch.cmd import colordepthsearch_cmd
    assert sub.choices["colorDepthSearch"].get_default("func") is \
        colordepthsearch_cmd.run


def _empty_engine(h, w):
    tiles = ActiveTiles(coords=np.zeros((0, 2), np.int32), n_active=0,
                        query_size=0, height=h, width=w,
                        q_cmp=np.zeros((0, 8, 128), np.int32),
                        q_f32=np.zeros((0, 4, 8, 128), np.float32))
    return ActiveTilePixelEngine.from_tiles(tiles, True, 20, 10_000_000, 2)


def test_scorer_rejects_frames_of_another_size():
    """Tile windows index the padded frame: frames that do not fit the
    masks' size are refused before any launch."""
    scorer = mm.MultiMaskScorer([_empty_engine(48, 160)])
    assert scorer.frame_shape == (64, 512)
    frames = torch.ones((2, 64, 384), dtype=torch.int32)
    with pytest.raises(ValueError, match="do not fit"):
        scorer.launch_deferred((frames, frames), np.ones((1, 2), np.int32))
    with pytest.raises(ValueError, match="different sizes"):
        mm.MultiMaskScorer([_empty_engine(48, 160), _empty_engine(56, 160)])
