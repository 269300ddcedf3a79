"""Multi-process runs of the port on the CPU: two processes in a gloo group
(torch.distributed), each a subprocess with its own time limit that
leaves the group on exit, and the --process-id/--process-count grid of
both commands. Every multi-process result equals the one-process run."""

import json
import os
import shutil
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from colormipsearch_torch.cmd.main import main  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_NAMES = [
    "VT033614_127B01_AE_01-20171124_64_H6-f-CH2_01",
    "BJD_127B01_AE_01-20171124_64_H6-40x-Brain-JRC2018_Unisex_20x_HR-"
    "2483089192251293794-CH2-01_CDM",
    "VT016795_115C08_AE_01-20200221_61_I2-m-CH1_01",
]
EMS = [("em-12191", "12191_JRC2018U"), ("em-lplc2", "1752016801-LPLC2-RT_18U")]
SEARCH = ["--maskThreshold", "20", "--dataThreshold", "20",
          "--pixColorFluctuation", "1", "--xyShift", "2", "--mirrorMask",
          "--processing-tag", "golden", "--maskBatchSize", "1",
          "--device", "cpu"]
GRAD = ["--maskThreshold", "20", "--mirrorMask", "--computeZGapOnTheFly",
        "--device", "cpu"]
RANK_TIMEOUT_S = 120


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(**extra):
    """The child's environment: no scale-out variables of this process, two
    threads per process, gloo on the loopback interface."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CMS_COORDINATOR", "CMS_NUM_PROCESSES",
                                "CMS_PROCESS_", "XLA_FLAGS"))}
    env.update(OMP_NUM_THREADS="2", GLOO_SOCKET_IFNAME="lo", **extra)
    return env


def _start(argv, env):
    """`python argv...` from the repo root, in the background."""
    return subprocess.Popen([sys.executable, *argv], cwd=REPO, env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(procs):
    """Wait for each process, killed at RANK_TIMEOUT_S; returns [(exit
    code, output)]."""
    out = []
    for p in procs:
        try:
            text, _ = p.communicate(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
        out.append((p.returncode, text))
    return out


def _group_envs(n=2):
    port = _free_port()
    return [_env(CMS_COORDINATOR=f"127.0.0.1:{port}",
                 CMS_NUM_PROCESSES=str(n), CMS_PROCESS_ID=str(r))
            for r in range(n)]


def _check_ok(runs):
    for r, (rc, text) in enumerate(runs):
        assert rc == 0, f"rank {r} exited {rc}:\n{text[-3000:]}"


@pytest.fixture(scope="module")
def workspace(tmp_path_factory, fixtures_dir):
    """Two EM masks against the three golden LM targets (with their
    gradient files, and BJD's z-gap file)."""
    ws = tmp_path_factory.mktemp("torch-mp")
    ems = [{"class": "org.janelia.colormipsearch.model.EMNeuronEntity",
            "id": str(1001 + i), "mipId": mip_id,
            "alignmentSpace": "JRC2018_Unisex_20x_HR",
            "libraryName": "flyem_test", "publishedName": name,
            "computeFiles": {"InputColorDepthImage": str(
                fixtures_dir / "ems" / f"{name}.tif")}}
           for i, (mip_id, name) in enumerate(EMS)]
    lms = []
    for i, name in enumerate(LM_NAMES):
        files = {"InputColorDepthImage": str(fixtures_dir / "lms" /
                                             f"{name}.tif"),
                 "GradientImage": str(fixtures_dir / "grad" / f"{name}.png")}
        zgap = fixtures_dir / "zgap" / f"{name}.tif"
        if zgap.exists():
            files["ZGapImage"] = str(zgap)
        lms.append({"class": "org.janelia.colormipsearch.model.LMNeuronEntity",
                    "id": str(2001 + i), "mipId": f"lm-{i}",
                    "alignmentSpace": "JRC2018_Unisex_20x_HR",
                    "libraryName": "flylight_test",
                    "publishedName": name.split("_")[0],
                    "computeFiles": files})
    for fname, ents in (("masks.json", ems), ("targets.json", lms)):
        with open(ws / fname, "w") as f:
            json.dump(ents, f)
    return ws


def _search_argv(ws, out, *extra):
    return ["colorDepthSearch", "-m", str(ws / "masks.json"),
            "-i", str(ws / "targets.json"), *SEARCH, "-od", str(out), *extra]


def _mask_files(out):
    """{file name: results without session ids} of a per-mask dir."""
    got = {}
    for name in sorted(os.listdir(out)):
        with open(os.path.join(out, name)) as f:
            doc = json.load(f)
        for r in doc["results"]:
            r.pop("sessionRefId", None)
        got[name] = doc
    return got


# run in a fresh interpreter: the group may not form within 2 s
NO_GROUP = ("import sys\n"
            "from colormipsearch_torch.parallel import multihost\n"
            "multihost.INIT_TIMEOUT_S = 2\n"
            "from colormipsearch_torch.cmd.main import main\n"
            "sys.exit(main(sys.argv[1:]))\n")


@pytest.fixture(scope="module")
def started(workspace, tmp_path_factory):
    """{name: (output dir, [process per rank])}: every multi-process run of
    this module that needs no one-process output, all started together
    at the module's set-up so that they run side by side (and beside the
    one-process runs); each test waits for its own. Processes still
    running at the module's end are killed."""
    runs = {}
    for engine in ("pallas", "dense"):
        # partitions of 2 and 1 targets: in the second, process 1's block
        # is empty; one dense mask batch of 2 below --maskBatchSize 3
        out = tmp_path_factory.mktemp(f"mp-{engine}") / "out"
        runs[engine] = (out, [_start(["-m", "colormipsearch_torch",
                                      *_search_argv(
                                          workspace, out, "--engine", engine,
                                          "--jax-distributed",
                                          "--processingPartitionSize", "2",
                                          "--maskBatchSize", "3")],
                                     env) for env in _group_envs()])
    # the grid: process 0 from CMS_PROCESS_ID/CMS_PROCESS_COUNT, process 1
    # from its options, each with its own -od
    grid = tmp_path_factory.mktemp("grid")
    runs["grid"] = (grid, [
        _start(["-m", "colormipsearch_torch",
                *_search_argv(workspace, grid / "p0")],
               _env(CMS_PROCESS_ID="0", CMS_PROCESS_COUNT="2")),
        _start(["-m", "colormipsearch_torch",
                *_search_argv(workspace, grid / "p1", "--process-id", "1",
                              "--process-count", "2")], _env())])
    runs["sweeps"] = (None, [_start(["-c", SWEEP_WORKER], env)
                             for env in _group_envs()])
    no_group = tmp_path_factory.mktemp("no-group") / "out"
    runs["no-group"] = (no_group, [_start(
        ["-c", NO_GROUP, *_search_argv(workspace, no_group,
                                       "--jax-distributed")],
        _group_envs()[0])])
    yield runs
    for _, procs in runs.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def one_process(workspace, started, tmp_path_factory):
    """The one-process colorDepthSearch output of each engine (computed
    while the `started` runs go on)."""
    outs = {}
    for engine in ("pallas", "dense"):
        out = tmp_path_factory.mktemp(f"one-{engine}")
        assert main(_search_argv(workspace, out, "--engine", engine)) == 0
        outs[engine] = out
    return outs


def test_one_process_goldens(one_process):
    for out in one_process.values():
        res = {r["image"]["mipId"]: (r["matchingPixels"], r["mirrored"])
               for r in _mask_files(out / "masks")["em-12191.json"]["results"]}
        assert res == {"lm-0": (439, False), "lm-1": (414, False),
                       "lm-2": (426, True)}
    assert _mask_files(one_process["pallas"] / "masks") == \
        _mask_files(one_process["dense"] / "masks")


@pytest.mark.parametrize("engine", ["pallas", "dense"])
def test_distributed_search(started, one_process, engine):
    """Two processes under --jax-distributed: process 0 alone writes, and
    its files equal the one-process run's."""
    out, procs = started[engine]
    runs = _finish(procs)
    _check_ok(runs)
    assert "results written by process 0" in runs[1][1]
    sessions = [n for n in os.listdir(out) if n.startswith("cdsSession")]
    assert len(sessions) == 1
    assert _mask_files(out / "masks") == \
        _mask_files(one_process[engine] / "masks")


def test_search_grid(started, one_process):
    """The --process-count 2 grid of colorDepthSearch, each process with its
    own -od: the union of the results equals the one-process run."""
    grid, procs = started["grid"]
    _check_ok(_finish(procs))
    outs = [grid / f"p{r}" for r in range(2)]
    want = _mask_files(one_process["pallas"] / "masks")
    union = {}
    for out in outs:
        for name, doc in _mask_files(out / "masks").items():
            union.setdefault(name, []).extend(doc["results"])
    assert sorted(union) == sorted(want)
    for name, results in union.items():
        key = lambda r: r["image"]["mipId"]  # noqa: E731
        assert sorted(results, key=key) == sorted(want[name]["results"],
                                                  key=key)
    # the targets were split: neither process saw all three
    for out in outs:
        seen = {r["image"]["mipId"] for d in _mask_files(out / "masks")
                .values() for r in d["results"]}
        assert 0 < len(seen) < 3


def test_gradient_grid(one_process, tmp_path):
    """The --process-count 2 grid of gradientScores over one shared -md:
    each process rescores its block of the masks, and the files equal the
    one-process run's."""
    src = one_process["pallas"] / "masks"
    single = shutil.copytree(src, tmp_path / "single")
    shared = shutil.copytree(src, tmp_path / "shared")
    assert main(["gradientScores", "-md", str(single), *GRAD]) == 0
    runs = _finish([_start(["-m", "colormipsearch_torch", "gradientScores",
                            "-md", str(shared), *GRAD, "--process-id",
                            str(r), "--process-count", "2"], _env())
                    for r in range(2)])
    _check_ok(runs)
    assert "owns 1 masks" in runs[0][1] and "owns 1 masks" in runs[1][1]
    got, want = _mask_files(shared), _mask_files(single)
    assert got == want
    gaps = {r["image"]["mipId"]: r["gradientAreaGap"]
            for r in want["em-12191.json"]["results"]}
    assert gaps == {"lm-0": 21365, "lm-1": 33884, "lm-2": 40696}


@pytest.mark.parametrize("command", ["colorDepthSearch", "gradientScores"])
def test_grid_process_id_out_of_range(workspace, tmp_path, command):
    argv = (_search_argv(workspace, tmp_path / "o") if command ==
            "colorDepthSearch" else ["gradientScores", "-md", str(tmp_path),
                                     *GRAD])
    with pytest.raises(SystemExit, match="not below --process-count 2"):
        main(argv + ["--process-id", "2", "--process-count", "2"])


def test_group_that_cannot_form_exits_nonzero(started):
    """--jax-distributed with CMS_NUM_PROCESSES=2 and no second process:
    the run ends with an error once the group's timeout passes; it does
    not carry on as one process."""
    out, procs = started["no-group"]
    (rc, text), = _finish(procs)
    assert rc != 0, text[-2000:]
    assert not out.exists()


def test_group_without_coordinator_exits_nonzero(workspace, tmp_path,
                                                 monkeypatch):
    """--jax-distributed with CMS_NUM_PROCESSES=2 and no CMS_COORDINATOR
    (a launch script's typo): the run refuses before any work instead of
    running the whole search as one process."""
    monkeypatch.delenv("CMS_COORDINATOR", raising=False)
    monkeypatch.setenv("CMS_NUM_PROCESSES", "2")
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no coordinator"):
        main(_search_argv(workspace, out, "--jax-distributed"))
    assert not out.exists()


SWEEP_WORKER = """
import sys
import numpy as np
import torch
from colormipsearch_torch.cds import pixel_kernel as pk
from colormipsearch_torch.cds.oracle import shift_ring_offsets
from colormipsearch_torch.cds.shape_kernel import (finish_shape_scores,
                                                   shape_score_rows)
from colormipsearch_torch.parallel import multihost as mh
from colormipsearch_torch.parallel import sweep

assert mh.maybe_init_distributed()
try:
    mesh = mh.global_pair_mesh(["cpu", "cpu"])  # 2 x 2 over 4 entries
    assert mesh.shape == {"mask": 2, "target": 2}
    assert mesh.ranks.tolist() == [[0, 0], [1, 1]]
    rng = np.random.default_rng(21)
    h, w = 40, 96
    qs = []
    for _ in range(4):
        q = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
        q[rng.random((h, w)) < 0.6] = 0
        qs.append(pk.prepare_query_planes(q, 20).words)
    q_words = np.stack(qs)
    t = rng.integers(0, 256, size=(6, h, w, 3)).astype(np.uint8)
    t[rng.random((6, h, w)) < 0.5] = 0
    zt9 = pk.z_tolerance_to_zt9(1.0)
    shifts = shift_ring_offsets(2)
    tp, tf = pk.pack_targets(t, 20, 2)
    want_s, want_m = (x.numpy() for x in pk.pixel_match_packed(
        torch.from_numpy(q_words), tp, tf, shifts, zt9, True))
    s, m, mx = sweep.sharded_pixel_sweep(mesh, q_words, tp, tf, shifts, zt9,
                                         True)
    assert (s == want_s).all() and (m == want_m).all()
    assert (mx == want_s.max(axis=1)).all()
    top = sweep.merge_topk(*sweep.sharded_pixel_sweep_topk(
        mesh, q_words, tp, tf, shifts, zt9, True, 2), 2)
    order = np.argsort(-want_s, axis=1, kind="stable")[:, :2]
    assert (top[1] == order).all()
    grad = rng.integers(0, 300, size=(6, h, w)).astype(np.int16)
    znz = rng.random((6, h, w)) < 0.5
    zsl = np.where(znz, rng.integers(0, 257, (6, h, w)), 0).astype(np.int16)
    tab = rng.random((6, h, w)) < 0.4
    qnz = rng.random((h, w)) < 0.5
    qsl = np.where(qnz, rng.integers(0, 257, (h, w)), 0).astype(np.int16)
    qm = qnz & (rng.random((h, w)) < 0.7)
    he = rng.random((h, w)) < 0.3
    score, use_m, best = sweep.sharded_shape_scores(
        mesh, qnz, qsl, qm, he, grad, znz, zsl, tab, mirror=True)
    _, _, want, want_use = finish_shape_scores(*shape_score_rows(
        *(torch.from_numpy(a) for a in (qnz, qsl, qm, he, grad, znz, zsl,
                                        tab)), mirror=True), mirror=True)
    assert (score == want).all() and (use_m == want_use).all()
    assert best.tolist() == [want.min()]
    got = mh.process_allgather((np.full(3, mh.process_index()),
                                np.array([True, mh.process_index() == 1])))
    assert got[0].tolist() == [[0, 0, 0], [1, 1, 1]]
    assert got[1].tolist() == [[True, False], [True, True]]
    print("rank", mh.process_index(), "SWEEPS OK", flush=True)
finally:
    mh.shutdown_distributed()
"""


def test_two_process_sweeps(started):
    """The sharded sweeps, top-k and shape scores over a 2 x 2 global mesh
    of two processes (two CPU entries each) equal the one-device scores on
    every process; process_allgather stacks each process's arrays."""
    runs = _finish(started["sweeps"][1])
    _check_ok(runs)
    for r, (_, text) in enumerate(runs):
        assert f"rank {r} SWEEPS OK" in text
