"""The port's scale-out layer (`colormipsearch_torch/parallel/`: the block
assignment, the process-block and device-block splits, the mesh, the
sharded dense sweeps, top-k and shape scores) against the JAX package's,
exactly: the JAX sweeps on conftest's 8 virtual CPU devices, the port's
on a mesh of 8 CPU entries. Also the device list of `--device` and
gradientScores spread over two device slots."""

import argparse

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from colormipsearch_tpu import parallel as ref_par  # noqa: E402
from colormipsearch_tpu.cds import pixel_kernel as ref_pk  # noqa: E402
from colormipsearch_tpu.cds.oracle import shift_ring_offsets  # noqa: E402
from colormipsearch_tpu.cds.shape_oracle import (  # noqa: E402
    build_query_shape_planes, build_target_shape_planes)
from colormipsearch_tpu.imageproc.io import \
    image_from_array as ref_image  # noqa: E402
from colormipsearch_tpu.parallel import distributed as ref_dist  # noqa: E402
from colormipsearch_tpu.parallel import mesh as ref_mesh  # noqa: E402
from colormipsearch_tpu.parallel import multihost as ref_mh  # noqa: E402
from colormipsearch_tpu.parallel import pallas_sweep as ref_ps  # noqa: E402
from colormipsearch_tpu.parallel import sweep as ref_sweep  # noqa: E402

from colormipsearch_torch import parallel as par  # noqa: E402
from colormipsearch_torch.cds import pixel_kernel as pk  # noqa: E402
from colormipsearch_torch.device import resolve_devices  # noqa: E402
from colormipsearch_torch.parallel import distributed  # noqa: E402
from colormipsearch_torch.parallel import mesh as mesh_mod  # noqa: E402
from colormipsearch_torch.parallel import multihost as mh  # noqa: E402
from colormipsearch_torch.parallel import sweep  # noqa: E402
from colormipsearch_torch.parallel.twophase_sweep import \
    device_blocks  # noqa: E402

CPU = torch.device("cpu")


def test_block_for_process_equals_jax():
    for n_masks in (0, 1, 5, 17):
        for n_targets in (0, 3, 10, 64):
            for count in (1, 2, 3, 4, 6, 8, 9):
                for pid in range(count):
                    got = distributed.block_for_process(n_masks, n_targets,
                                                        pid, count)
                    want = ref_dist.block_for_process(n_masks, n_targets,
                                                      pid, count)
                    assert vars(got) == vars(want)
                got = distributed.block_for_process(n_masks, n_targets, 1,
                                                    count, jobs_for_masks=1)
                want = ref_dist.block_for_process(n_masks, n_targets, 1,
                                                  count, jobs_for_masks=1)
                assert vars(got) == vars(want)


def test_process_block_equals_jax(monkeypatch):
    for num in (1, 2, 3, 7):
        monkeypatch.setenv("CMS_NUM_PROCESSES", str(num))
        for pid in range(num):
            monkeypatch.setenv("CMS_PROCESS_ID", str(pid))
            for n in (0, 1, 10, 101):
                assert mh.process_block(n) == ref_mh.process_block(n)


def test_device_blocks_and_factor_grid_equal_jax():
    for n in (0, 1, 2, 7, 64, 513):
        for d in (1, 2, 3, 8):
            assert device_blocks(n, d) == ref_ps.device_blocks(n, d)
    for n in range(1, 65):
        assert mesh_mod._factor_grid(n) == ref_mesh._factor_grid(n)


def test_meshes():
    mesh = par.make_pair_mesh(["cpu"] * 8)
    assert mesh.shape == {"mask": 2, "target": 4}
    assert mesh.devices[1, 3] == CPU and mesh.ranks is None
    assert mesh.local_positions(5) == mesh.positions()
    assert len(mesh.positions()) == 8
    assert par.make_pair_mesh(["cpu"] * 6, shape=(1, 6)).shape == \
        {"mask": 1, "target": 6}
    with pytest.raises(ValueError, match="mesh shape"):
        par.make_pair_mesh(["cpu"] * 6, shape=(4, 2))
    # one process: the global mesh is the local one
    assert par.global_pair_mesh(["cpu"] * 8).shape == \
        {"mask": 2, "target": 4}
    g = par.global_pair_mesh(["cpu"] * 8, mask_shards=1)
    assert g.shape == {"mask": 1, "target": 8} and g.ranks is None


def test_distribute_blocks():
    mesh = par.make_pair_mesh(["cpu"] * 6, shape=(2, 3))
    arr = np.arange(4 * 6 * 2).reshape(4, 6, 2)
    q = par.distribute(mesh, ("mask", None, None), arr)
    t = par.distribute(mesh, ("target", None, None), arr[:3])
    both = par.distribute(mesh, ("mask", "target"), arr)
    rep = par.distribute(mesh, (), arr)
    for (i, j) in mesh.positions():
        np.testing.assert_array_equal(q.shards[(i, j)], arr[2 * i:2 * i + 2])
        np.testing.assert_array_equal(t.shards[(i, j)], arr[j:j + 1])
        np.testing.assert_array_equal(both.shards[(i, j)],
                                      arr[2 * i:2 * i + 2, 2 * j:2 * j + 2])
        np.testing.assert_array_equal(rep.shards[(i, j)], arr)
    doubled = q.map(lambda x: 2 * x)
    np.testing.assert_array_equal(doubled.shards[(1, 2)], 2 * arr[2:])
    # 4 rows over 3 target blocks: balanced blocks, as device_blocks cuts
    uneven = par.distribute(mesh, ("target", None, None), arr)
    assert [uneven.shards[(1, j)].shape[0] for j in range(3)] == [2, 1, 1]
    np.testing.assert_array_equal(
        np.concatenate([uneven.shards[(0, j)] for j in range(3)]), arr)


def test_process_allgather_one_process():
    a = np.arange(6).reshape(2, 3)
    b = np.array([True, False])
    got = mh.process_allgather(a)
    assert got.shape == (1, 2, 3) and (got[0] == a).all()
    ga, gb = mh.process_allgather((a, b))
    assert gb.dtype == bool and gb.tolist() == [[True, False]]
    assert mh.gather_objects({"x": 1}) == [{"x": 1}]
    assert not mh.maybe_init_distributed(num_processes=1)


@pytest.fixture(scope="module")
def library():
    rng = np.random.default_rng(31)
    h, w = 40, 96
    qs = []
    for _ in range(4):
        q = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
        q[rng.random((h, w)) < 0.6] = 0
        qs.append(ref_pk.prepare_query_planes(ref_image(q), 20).words)
    t = rng.integers(0, 256, size=(8, h, w, 3)).astype(np.uint8)
    t[rng.random((8, h, w)) < 0.5] = 0
    t[6] = t[2]  # tied scores across target shards
    shifts = np.asarray(shift_ring_offsets(2), dtype=np.int32)
    return np.stack(qs), t, shifts, ref_pk.z_tolerance_to_zt9(1.0)


@pytest.mark.parametrize("shape", [(2, 4), (1, 8), (4, 2)])
def test_sharded_pixel_sweep_equals_jax(library, shape):
    q_words, t, shifts, zt9 = library
    tp, tf = ref_pk.pack_targets(jnp.asarray(t), 20, 2)
    want = ref_par.sharded_pixel_sweep(
        ref_par.make_pair_mesh(shape=shape), jnp.asarray(q_words), tp, tf,
        jnp.asarray(shifts), zt9, True)
    mesh = par.make_pair_mesh(["cpu"] * 8, shape=shape)
    gp, gf = pk.pack_targets(t, 20, 2)
    got = par.sharded_pixel_sweep(mesh, q_words, gp, gf, shifts, zt9, True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    # inputs already placed on the mesh give the same
    placed = par.sharded_pixel_sweep(
        mesh, par.distribute(mesh, ("mask", None, None), q_words),
        par.distribute(mesh, ("target", None, None), gp),
        par.distribute(mesh, ("target", None, None), gf), shifts, zt9, True)
    for g, p in zip(got, placed):
        np.testing.assert_array_equal(g, p)
    local_s, local_m = par.local_pixel_sweep(torch.from_numpy(q_words), gp,
                                             gf, shifts, zt9, True)
    np.testing.assert_array_equal(got[0], local_s.numpy())
    np.testing.assert_array_equal(got[1], local_m.numpy())


@pytest.mark.parametrize("k", [1, 3, 5])
def test_topk_equals_jax(library, k):
    q_words, t, shifts, zt9 = library
    tp, tf = ref_pk.pack_targets(jnp.asarray(t), 20, 2)
    want = ref_sweep.sharded_pixel_sweep_topk(
        ref_par.make_pair_mesh(shape=(2, 4)), jnp.asarray(q_words), tp, tf,
        jnp.asarray(shifts), zt9, True, k)
    gp, gf = pk.pack_targets(t, 20, 2)
    got = sweep.sharded_pixel_sweep_topk(
        par.make_pair_mesh(["cpu"] * 8, shape=(2, 4)), q_words, gp, gf,
        shifts, zt9, True, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    for g, w in zip(par.merge_topk(*got, k), ref_sweep.merge_topk(*want, k)):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("k", [1, 3])
def test_uneven_blocks_equal_one_device(library, k):
    """3 masks x 7 targets over a 2 x 4 mesh (blocks of 2/1 masks and
    2/2/2/1 targets, which the JAX package pads away): the sweep equals
    one device's, and the merged top-k equals a stable sort of the whole
    score grid (k = 3 overruns the one-target block)."""
    q_words, t, shifts, zt9 = library
    q_words, t = q_words[:3], t[:7]
    mesh = par.make_pair_mesh(["cpu"] * 8, shape=(2, 4))
    gp, gf = pk.pack_targets(t, 20, 2)
    want_s, want_m = (x.numpy() for x in par.local_pixel_sweep(
        torch.from_numpy(q_words), gp, gf, shifts, zt9, True))
    s, m, mx = par.sharded_pixel_sweep(mesh, q_words, gp, gf, shifts, zt9,
                                       True)
    np.testing.assert_array_equal(s, want_s)
    np.testing.assert_array_equal(m, want_m)
    np.testing.assert_array_equal(mx, want_s.max(axis=1))
    top_s, top_i, top_m = par.merge_topk(*sweep.sharded_pixel_sweep_topk(
        mesh, q_words, gp, gf, shifts, zt9, True, k), k)
    order = np.argsort(-want_s, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(top_i, order)
    np.testing.assert_array_equal(top_s, np.take_along_axis(want_s, order, 1))
    np.testing.assert_array_equal(top_m, np.take_along_axis(want_m, order, 1))


@pytest.mark.parametrize("mirror", [True, False])
def test_sharded_shape_scores_equal_jax(mirror):
    rng = np.random.default_rng(13)
    h, w, tsz = 40, 96, 8
    q = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
    q[rng.random((h, w)) < 0.5] = 0
    qp = build_query_shape_planes(ref_image(q), None)
    tplanes = []
    for _ in range(tsz):
        t = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
        t[rng.random((h, w)) < 0.5] = 0
        grad16 = rng.integers(0, 300, size=(h, w)).astype(np.uint16)
        tplanes.append(build_target_shape_planes(
            ref_image(t), ref_image(grad16), None, 20, None))
    query = (qp.q_nonzero, qp.q_slice, qp.q_mask, qp.high_expr)
    targets = [np.stack([getattr(p, n) for p in tplanes])
               for n in ("grad", "z_nonzero", "z_slice", "t_above")]
    want = ref_sweep.sharded_shape_scores(
        ref_par.make_pair_mesh(shape=(2, 4)),
        *(jnp.asarray(a) for a in query + tuple(targets)), mirror=mirror)
    # the planes as the port's scorer takes them: 16-bit values as int16
    port_query = (qp.q_nonzero, qp.q_slice.astype(np.int16),
                  qp.q_mask.astype(bool), qp.high_expr.astype(bool))
    grad, znz, zsl, tab = targets
    got = par.sharded_shape_scores(
        par.make_pair_mesh(["cpu"] * 8, shape=(2, 4)), *port_query,
        grad.view(np.int16), znz, zsl.astype(np.int16), tab, mirror=mirror)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w_))
    assert got[1].any() == mirror


def test_resolve_devices(monkeypatch):
    assert resolve_devices("cpu") == [CPU]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_devices("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert resolve_devices("cuda") == [torch.device("cuda", 0),
                                       torch.device("cuda", 1)]
    assert resolve_devices("cuda:1") == [torch.device("cuda", 1)]
    with pytest.raises(RuntimeError, match="only 2 CUDA card"):
        resolve_devices("cuda:2")


def _gradient_library(tmp_path, n):
    """A mask and n targets of 72 x 136 (CDM and 8-bit gradient files) as
    the port's match entities."""
    from PIL import Image

    from colormipsearch_torch import model
    rng = np.random.default_rng(8)
    h, w = 72, 136   # the reference's 60 px dilation needs h > 60
    query = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    query[rng.random((h, w)) < 0.7] = 0
    em = model.EMNeuronEntity(entity_id=1, mip_id="em")
    matches = []
    for i in range(n):
        px = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        px[rng.random((h, w)) < 0.6] = 0
        if i % 3 == 0:
            px = np.ascontiguousarray(query[:, ::-1])  # a mirrored match
        cdm, grad = tmp_path / f"t{i}.png", tmp_path / f"t{i}_g.png"
        Image.fromarray(px).save(cdm)
        Image.fromarray(rng.integers(0, 255, size=(h, w), dtype=np.uint8),
                        mode="L").save(grad)
        lm = model.LMNeuronEntity(entity_id=10 + i, mip_id=f"lm-{i}")
        lm.compute_files[model.ComputeFileType.InputColorDepthImage] = \
            model.FileData.from_string(str(cdm))
        lm.compute_files[model.ComputeFileType.GradientImage] = \
            model.FileData.from_string(str(grad))
        m = model.CDMatchEntity()
        m.mask_image, m.matched_image = em, lm
        matches.append(m)
    return query, matches


@pytest.mark.parametrize("roi", [False, True])
def test_gradient_two_slots_equal_one(tmp_path, roi):
    """score_mask_partitions over [cpu, cpu] (plane builds split between
    the two slots, each batch scored per slot; the ROI branch moves the
    planes to the first device) equals the run over [cpu]."""
    from colormipsearch_torch.cds.shape_oracle import \
        build_mirrored_query_shape_planes
    from colormipsearch_torch.cmd import gradientscores_cmd as gc
    from colormipsearch_torch.imageproc.io import image_from_array
    from colormipsearch_torch.mips import MIPsCache
    query, _ = _gradient_library(tmp_path, 0)
    h, w = query.shape[:2]
    roi_img = None
    if roi:
        roi_px = np.full((h, w, 3), 255, np.uint8)
        roi_px[:, w // 2:] = 0
        roi_img = image_from_array(roi_px)
    args = argparse.Namespace(maskThreshold=20, mirrorMask=True,
                              computeZGapOnTheFly=True, targetsPerBatch=4,
                              planes_threads=2)
    results = {}
    for devices in ([CPU], [CPU, CPU]):
        _, matches = _gradient_library(tmp_path, 10)
        cache = gc.PlaneCache(devices)
        img = image_from_array(query)
        qplanes = gc._build_qplanes(img, None, roi_img, 0, CPU)
        qplanes_m = (gc._to_device(build_mirrored_query_shape_planes(
            img, None, roi_img, 0), CPU) if roi else None)
        scored = gc.score_mask_partitions(matches, qplanes, MIPsCache(64),
                                          args, None, cache, qplanes_m)
        results[len(devices)] = [(m.matched_image.mip_id,
                                  m.gradient_area_gap,
                                  m.high_expression_area) for m in scored]
        slots = {cache.slot(m.matched_image.entity_id) for m in matches}
        assert slots == set(range(len(devices)))
    assert results[1] == results[2] and len(results[1]) == 10
