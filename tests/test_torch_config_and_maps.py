"""The port's own copies of the JAX package's framework-free modules
(config dataclasses, map builders, ground graph, node weights, lidar
simulator) against the originals, on the CPU. Every comparison is exact:
the copies must compute what the originals compute."""
import dataclasses

import numpy as np
import pytest

import dddmr_navigation_tpu.config as jcfg
from dddmr_navigation_tpu.io import maps as jmaps
from dddmr_navigation_tpu.perception.static_weights import (
    compute_node_weights as j_node_weights)
from dddmr_navigation_tpu.planning.global_.graph import (
    build_ground_graph as j_graph)
from dddmr_navigation_tpu.utils import lidar_sim as jlidar

import dddmr_navigation_tpu_torch.config as tcfg
from dddmr_navigation_tpu_torch import entry
from dddmr_navigation_tpu_torch.interop import config_from
from dddmr_navigation_tpu_torch.io import maps as tmaps
from dddmr_navigation_tpu_torch.perception.static_weights import (
    compute_node_weights as t_node_weights)
from dddmr_navigation_tpu_torch.planning.global_.graph import (
    build_ground_graph as t_graph)
from dddmr_navigation_tpu_torch.utils import lidar_sim as tlidar

CONFIG_CLASSES = sorted(
    name for name in dir(jcfg)
    if dataclasses.is_dataclass(getattr(jcfg, name))
    and isinstance(getattr(jcfg, name), type))


def test_config_exports_match():
    """The port's config package exports every name the JAX package's
    does."""
    want = {n for n in dir(jcfg) if not n.startswith("_")} - {"schema"}
    assert want <= set(dir(tcfg))
    assert len(CONFIG_CLASSES) >= 15


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_defaults_match(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    assert ([f.name for f in dataclasses.fields(t)]
            == [f.name for f in dataclasses.fields(j)])
    assert dataclasses.asdict(t()) == dataclasses.asdict(j())


def test_config_from_rebuilds_a_non_default_config():
    j = jcfg.NavigationConfig(
        local_planner=jcfg.LocalPlannerConfig(
            generator=jcfg.DDSimpleGeneratorConfig(
                linear_x_sample=7, angular_z_sample=9, max_num_steps=12),
            critics=jcfg.CriticsConfig(
                twirling=jcfg.CriticConfig(weight=0.3),
                stick_path=None),
            max_obstacle_points=96, collision_near_k=24),
        global_planner=jcfg.GlobalPlannerConfig(max_relax_iters=77,
                                                turning_weight=0.25),
        perception=jcfg.PerceptionConfig(voxel_window_cells_xy=40))
    t = tcfg.NavigationConfig(
        local_planner=tcfg.LocalPlannerConfig(
            generator=tcfg.DDSimpleGeneratorConfig(
                linear_x_sample=7, angular_z_sample=9, max_num_steps=12),
            critics=tcfg.CriticsConfig(
                twirling=tcfg.CriticConfig(weight=0.3),
                stick_path=None),
            max_obstacle_points=96, collision_near_k=24),
        global_planner=tcfg.GlobalPlannerConfig(max_relax_iters=77,
                                                turning_weight=0.25),
        perception=tcfg.PerceptionConfig(voxel_window_cells_xy=40))
    got = config_from(j)
    assert type(got) is tcfg.NavigationConfig
    assert type(got.local_planner.generator) is tcfg.DDSimpleGeneratorConfig
    assert got == t
    assert dataclasses.asdict(got) == dataclasses.asdict(j)


@pytest.mark.parametrize("resolution", [0.25, 0.5])
def test_multi_level_map_matches(resolution):
    jg, jm = jmaps.multi_level_map(resolution=resolution)
    tg, tm = tmaps.multi_level_map(resolution=resolution)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(tm, jm)
    assert tg.dtype == jg.dtype and tm.dtype == jm.dtype


def test_flat_ground_and_box_obstacle_match():
    np.testing.assert_array_equal(tmaps.flat_ground_map(4, 3, 0.25, 0.1),
                                  jmaps.flat_ground_map(4, 3, 0.25, 0.1))
    np.testing.assert_array_equal(
        tmaps.box_obstacle([1.2, 0.8, 0.0], size=(0.3, 0.3, 0.6)),
        jmaps.box_obstacle([1.2, 0.8, 0.0], size=(0.3, 0.3, 0.6)))


@pytest.fixture(scope="module")
def ml_map():
    return jmaps.multi_level_map(resolution=0.5)


def test_ground_graph_matches(ml_map):
    ground = ml_map[0]
    want, got = j_graph(ground), t_graph(ground)
    assert got._fields == want._fields
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)


def test_node_weights_match(ml_map):
    ground, map_pts = ml_map
    jw, jd = j_node_weights(ground, map_pts)
    tw, td = t_node_weights(ground, map_pts)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(td, jd)
    assert (jd < 1.0).any()               # the duct's overhang is marked


@pytest.mark.parametrize("yaw", [0.0, 0.7])
def test_simulate_scan_matches_on_config3_world(yaw):
    jw = jlidar.BoxWorld()
    for mn, mx in (entry.CONFIG3_BOX, ((9.1, 7.6, 0.0), (9.5, 8.0, 1.0))):
        jw.add_box(mn, mx)
    tw = entry.config3_world([((9.1, 7.6, 0.0), (9.5, 8.0, 1.0))])
    assert type(tw) is tlidar.BoxWorld
    pos = np.asarray(entry.CONFIG3_ROBOT, np.float32) + np.asarray(
        entry.CONFIG3_OFFSET, np.float32)
    jp, jm = jlidar.simulate_scan(jw, pos, sensor_yaw=yaw, n_rings=16,
                                  n_cols=400)
    tp, tm = tlidar.simulate_scan(tw, pos, sensor_yaw=yaw, n_rings=16,
                                  n_cols=400)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tp, jp)
    assert jm.any() and not jm.all()


def test_voxel_downsample_matches():
    rng = np.random.default_rng(5)
    pts = (rng.normal(0, 1.5, (3000, 3))).astype(np.float32)
    for leaf in (0.1, 0.25):
        np.testing.assert_array_equal(tmaps.voxel_downsample(pts, leaf),
                                      jmaps.voxel_downsample(pts, leaf))
    empty = np.zeros((0, 3), np.float32)
    assert tmaps.voxel_downsample(empty, 0.1).shape == (0, 3)


@pytest.mark.parametrize("num", [0, 1, 3])
def test_scan_stitcher_matches(num):
    from dddmr_navigation_tpu.perception.stitcher import ScanStitcher as J
    from dddmr_navigation_tpu_torch.perception.stitcher import (
        ScanStitcher as T)
    rng = np.random.default_rng(num)
    j, t = J(num, pad_to=500), T(num, pad_to=500)
    for _ in range(5):
        pts = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
        mask = rng.uniform(size=300) < 0.6
        (jp, jm), (tp, tm) = j.push(pts, mask), t.push(pts, mask)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tm, jm)
    j.clear()
    t.clear()


def test_watchdog_matches():
    from dddmr_navigation_tpu.runtime import watchdog as jw
    from dddmr_navigation_tpu_torch.runtime import watchdog as tw
    gates = [m.FreshnessGate(expected_dt={"lidar": 0.2, "odom": 0.3})
             for m in (jw, tw)]
    for name, now in (("lidar", 10.0), ("odom", 10.05), ("lidar", 10.4)):
        for gate in gates:
            gate.update(name, now=now)
        for q in (10.1, 10.3, 10.36, 10.5):
            assert gates[0].ok(now=q) == gates[1].ok(now=q)
            assert (gates[0].is_current("odom", now=q)
                    == gates[1].is_current("odom", now=q))
    monitors = [m.TickMonitor(budget_ms=0.0, window=3) for m in (jw, tw)]
    for mon in monitors:
        for _ in range(5):
            mon.start()
            mon.stop()
    a, b = (mon.stats() for mon in monitors)
    assert a.keys() == b.keys()
    assert (a["ticks"], a["deadline_misses"]) == (b["ticks"],
                                                  b["deadline_misses"])


@pytest.mark.parametrize("encoding", ["ascii", "binary", "binary_compressed"])
def test_pcd_matches(tmp_path, encoding):
    kw = dict(binary=encoding != "ascii",
              compressed=encoding == "binary_compressed")
    """io/pcd.py: each package reads what either writes, in each encoding,
    to the same arrays; the LZF codec gives the same bytes both ways."""
    from dddmr_navigation_tpu.io import pcd as jpcd
    from dddmr_navigation_tpu_torch.io import pcd as tpcd
    rng = np.random.default_rng(7)
    pts = rng.normal(0, 3, (500, 4)).astype(np.float32)
    pts[::7] = np.round(pts[::7], 1)          # runs for the LZF back-refs
    fields = ("x", "y", "z", "intensity")
    for w, name in ((jpcd, "j"), (tpcd, "t")):
        w.write_pcd(str(tmp_path / f"{name}.pcd"), pts, fields=fields, **kw)
    assert ((tmp_path / "j.pcd").read_bytes()
            == (tmp_path / "t.pcd").read_bytes())
    for name in ("j", "t"):
        a = tpcd.read_pcd(str(tmp_path / f"{name}.pcd"))
        np.testing.assert_array_equal(a, jpcd.read_pcd(
            str(tmp_path / f"{name}.pcd")))
        # ascii stores "%.6f": half its last digit, and the f32 read back
        np.testing.assert_allclose(a, pts, rtol=0, atol=1e-6
                                   if encoding == "ascii" else 0)
    raw = pts.tobytes()
    comp = tpcd.lzf_compress(raw)
    assert comp == jpcd.lzf_compress(raw)
    assert tpcd.lzf_decompress(comp, len(raw)) == raw


@pytest.mark.parametrize("encoding", ["P2", "P5"])
def test_occupancy_matches(tmp_path, encoding):
    """io/occupancy.py: ``read_pgm`` of a P2 and a P5 image,
    ``occupancy_to_clouds`` of it (plain and negated), and
    ``cloud_to_occupancy`` of the clouds (and of an empty cloud) equal the
    original's."""
    from dddmr_navigation_tpu.io import occupancy as jocc
    from dddmr_navigation_tpu_torch.io import occupancy as tocc
    rng = np.random.default_rng(7)
    img = rng.choice(np.array([0, 205, 254], np.uint8), size=(23, 31),
                     p=[0.2, 0.1, 0.7])
    path = tmp_path / "map.pgm"
    if encoding == "P5":
        path.write_bytes(b"P5\n# map\n31 23\n255\n" + img.tobytes())
    else:
        path.write_text("P2\n31 23\n255\n" + "\n".join(
            " ".join(str(v) for v in row) for row in img) + "\n")
    grid = tocc.read_pgm(str(path))
    np.testing.assert_array_equal(grid, jocc.read_pgm(str(path)))
    np.testing.assert_array_equal(grid, img)
    for negate in (False, True):
        tg, tw = tocc.occupancy_to_clouds(grid, 0.05, (1.0, -2.0),
                                          negate=negate)
        jg, jw = jocc.occupancy_to_clouds(grid, 0.05, (1.0, -2.0),
                                          negate=negate)
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(tw, jw)
        for cloud in (tg, tw):
            tgrid, torigin = tocc.cloud_to_occupancy(cloud, 0.05)
            jgrid, jorigin = jocc.cloud_to_occupancy(cloud, 0.05)
            np.testing.assert_array_equal(tgrid, jgrid)
            assert torigin == jorigin
    empty = np.zeros((0, 3), np.float32)
    assert tocc.cloud_to_occupancy(empty)[0].shape == (0, 0)
