"""Guards of the port: it never imports JAX, never guesses a device and
never falls back from the CUDA kernel to its plain version."""

import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from colormipsearch_torch.cds import kernels  # noqa: E402
from colormipsearch_torch.cds import multimask as mm  # noqa: E402
from colormipsearch_torch.cds import pixel_active as pa  # noqa: E402
from colormipsearch_torch.cds.pixel_active import (  # noqa: E402
    ActiveTilePixelEngine, ActiveTiles)
from colormipsearch_torch.cmd.main import build_parser, main  # noqa: E402
from colormipsearch_torch.device import resolve_device  # noqa: E402
from colormipsearch_torch.scripts import op_microbench as ob  # noqa: E402


def test_port_imports_no_jax():
    """Every module of the port, and build_parser(), load no jax* and no
    colormipsearch_tpu* module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import colormipsearch_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    pkg.__path__, 'colormipsearch_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "importlib.import_module('colormipsearch_torch.cmd.main')"
        ".build_parser()\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(\n"
        "    ('jax.', 'jaxlib', 'colormipsearch_tpu')))\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n"
        "print('no jax', len(names))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "no jax" in r.stdout
    # the copies of the host modules are among the modules imported
    assert int(r.stdout.split()[-1]) >= 30
    walked = set(r.stdout.split())
    for name in ("ppp", "ppp.raw_reader", "cmd.mipstores",
                 "cmd.createdatainput_cmd", "cmd.copymips_cmd",
                 "cmd.importppp_cmd", "cmd.tag_cmd", "cmd.validate_cmd",
                 "cmd.delete_cmd", "scripts.dress_rehearsal"):
        assert f"colormipsearch_torch.{name}" in walked, name


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py names neither JAX nor the JAX package in an import,
    and checks it runs in a checkout by port files only."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    with open(path) as f:
        src = f.read()
    imports = [ln.strip() for ln in src.splitlines()
               if ln.strip().startswith(("import ", "from "))]
    assert imports
    bad = [ln for ln in imports
           if re.search(r"\b(jax|jaxlib|colormipsearch_tpu)\b", ln)]
    assert not bad, bad
    assert "colormipsearch_tpu/" not in src.split("def main")[1]


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
    """A CUDA-typed call with no buildable kernel raises, for each
    wrapper; the plain version is never run in its place."""
    monkeypatch.setattr(kernels, "find_nvcc", lambda: None)
    monkeypatch.setattr(kernels, "_loaded", {})
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))

    def plain(*a, **k):
        raise AssertionError("plain version ran for CUDA tensors")

    monkeypatch.setattr(mm, "multimask_counts_plain", plain)
    monkeypatch.setattr(mm, "multimask_words_counts_plain", plain)
    monkeypatch.setattr(ob, "op_chain_plain", plain)
    triples = pa.word_triples(10_000_000)
    calls = [
        (mm.multimask_counts, 12, (2, True)),
        (mm.multimask_words_counts, 9, (2, True, triples)),
    ]
    for fn, n_tensors, rest in calls:
        args = [_fake("cuda:0") for _ in range(n_tensors)]
        before = fn.launches
        with pytest.raises(RuntimeError, match="nvcc not found"):
            fn(*args, *rest)
        with pytest.raises(ValueError, match="all on one CUDA device"):
            fn(*([_fake("cpu")] + args[1:]), *rest)
        assert fn.launches == before
    before = ob.op_chain.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ob.op_chain("add i32", _fake("cuda:0"), _fake("cuda:0"))
    with pytest.raises(ValueError, match="CUDA device"):
        ob.op_chain("add i32", _fake("cpu"), _fake("cuda:0"))
    assert ob.op_chain.launches == before
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.load_libraries()
    assert kernels._loaded == {}


def test_one_library_per_source(monkeypatch, tmp_path):
    """Each csrc/<name>.cu builds into its own library, named by the hash
    of its source, of the local headers it includes and of the flags."""
    assert set(kernels.LIBRARIES) == {"multimask_ratio", "multimask_words",
                                      "op_chain", "prescreen_bound",
                                      "shape_score", "shape_planes"}
    for name in kernels.LIBRARIES:
        assert os.path.exists(kernels.source_path(name))
    paths = {kernels.library_path(n) for n in kernels.LIBRARIES}
    assert len(paths) == 6
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setattr(kernels, "CSRC", str(csrc))
    (csrc / "k.cu").write_text('#include "h.cuh"\nint f() { return 1; }\n')
    (csrc / "h.cuh").write_text("#pragma once\n")
    first = kernels.library_path("k")
    assert os.path.basename(first).startswith("libcms_k_")
    (csrc / "h.cuh").write_text("#pragma once\n// changed\n")
    assert kernels.library_path("k") != first
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-G",))
    assert kernels.library_path("k") != first
    with pytest.raises(ValueError, match="unknown kernel library"):
        kernels.load_library("k")


def test_cli_dispatch_table():
    """Every command of the JAX package runs on the port: each name of
    the reference's dispatch table dispatches to the run() of the port's
    module of the same name, and none refuses."""
    import importlib

    from colormipsearch_tpu.cmd.main import build_parser as jax_parser

    def table(parser):
        sub = next(a for a in parser._actions if isinstance(a.choices, dict))
        return {name: p.get_default("func") for name, p in sub.choices.items()}

    port, ref = table(build_parser()), table(jax_parser())
    assert set(port) == set(ref)
    assert len(port) == 11  # ten commands and the normalize alias
    for name, ref_run in ref.items():
        module = ref_run.__module__.replace("colormipsearch_tpu",
                                            "colormipsearch_torch")
        assert port[name] is importlib.import_module(module).run, name
    for name in port:
        with pytest.raises(SystemExit) as e:
            main([name, "--no-such-option"])
        assert e.value.code == 2  # argparse's usage error, not a refusal


def _empty_engine(h, w):
    tiles = ActiveTiles(coords=np.zeros((0, 2), np.int32), n_active=0,
                        query_size=0, height=h, width=w,
                        q_words=np.zeros((0, 8, 128), np.int32),
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
