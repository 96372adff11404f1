"""Check of the PyTorch port (dddmr_navigation_tpu_torch) on one CUDA
card, at the full width of the 64-robot headline fleet, the fused tick of
bench config 3, the full-fidelity fleet of bench config 4 (also sharded
over an NCCL process group), the single-robot navigation session, the
localization vertical (pose-graph submaps, feature weights, odom3d and
global localization from an unknown start), the SLAM vertical (one
mapping run at ``SlamConfig()``'s full width, its map saved, edited and
localized on) and semantic segmentation (the 19-class DDRNet-slim at
240×320, its reroute chain and train step), with the runtime's
checkpoints and traces, and the mark/clear graph.

    python3 chip_smoke.py

It checks results and times nothing: the benchmark (``BENCHMARK.json``,
``navbench/``) measures the port. In order, and any failed check raises
(exit code 1):
  1. requires CUDA;
  2. builds the hand-written kernels from ``dddmr_navigation_tpu_torch/csrc``
     (one nvcc per source, in parallel) and prints ptxas's report; then
     holds each kernel against the plain PyTorch version, bit for bit, on
     the adversarial inputs of ``ops/adversarial.py`` (seed
     ``ADVERSARIAL_SEED``);
  3. holds each kernel against its plain PyTorch version on the card, on
     the inputs the headline chain gives it at ticks 0, 25 and 49: hits and
     distances equal bit for bit, and the plain hits must hold both
     outcomes so that the comparison can fail; the distance kernel's
     compacted point set (its plain mirror) must give the plain distances;
  4. runs the 64-robot, 50-tick chain on the kernel path and on the plain
     path: per-tick state codes, best indices and found counts must be
     equal, and the launch counters must show each kernel launched as
     often as the chain calls it (one collision sweep and two distance
     calls per tick, no successor-table walk: the headline tick plans
     nothing); the plain path runs every kernel's plain version;
  5. holds tick 0, and the state codes of every tick of the chain, against
     the JAX package's golden file
     (``dddmr_navigation_tpu_torch/testdata/headline_tick0.npz``).

Then the fused phase, bench config 3 (``bench.py::bench_config3``) at
full width: the multi-level map (3,116 ground nodes, 16 direction bins), a
96×96×44 perception window, a 16×1000 lidar, 64×128 = 8,192 samples of 40
steps, one robot; any failed check raises:
  7. builds the map and the robot's state from the port's numpy map
     functions;
  8. holds the map's direction bins against the JAX golden file
     (``dddmr_navigation_tpu_torch/testdata/config3_golden.npz``) exactly,
     its edge azimuths and turning table within 1e-6;
  9. teacher-forced stages: from the golden's tick-0 entry costs and
     tables the turning relaxation must give JAX's field bit for bit and
     the same iteration count; from JAX's field the extraction must give
     JAX's node ids;
 10. the golden's 20-tick chain, teacher-forced on its poses (each tick's
     scan simulated with ``lidar_sim`` at the recorded pose, and checked
     against the golden's recorded scan), on the kernel path and on the
     plain path: state codes, plan_ok, plan counts, relaxation
     iterations and best indices equal on both; against the golden the
     integer outputs equal (a best index may differ only as a tie within
     1e-5 of JAX's cost), the composed dGraph and plan positions within
     1e-5 m; one ``swept_box_hits``, two ``masked_min_distance`` and
     one ``walk_table`` launch per tick;
 11. as step 3, on the fused tick's arguments at ticks 0, 10 and 19 of
     the chain run with one more box in the robot's path (config 3's own
     box is never in a rollout's way), so that the plain hits hold both
     outcomes; and the successor-table walk kernel against its plain
     version at every walk of that run, and at a copy of each whose
     paths are cut (made stuck three hops in): bit for bit, with walks
     that reach the goal and walks that stop short of it.

Then the fleet phase, bench config 4 (``bench.py::bench_config4``) at full
width: 64 robots on the 12×8 m warehouse floor (1,617 ground nodes), MCL
with 60 particles in ``corr`` mode on drifting odometry, a 64×64×24 window,
2,048 scan points, 16×16 samples of 40 steps, one turning relaxation for
the fleet (192 iterations at most), the rotate generator, the FSM and the
rotate recovery; any failed check raises:
 13. builds the map, submap and start state (the MCL's initial normals
     from ``dddmr_navigation_tpu_torch/testdata/config4_golden.npz``);
 14. the cold tick and 10 warm ticks closed loop on the kernel path and on
     the plain path, MCL draws from one ``torch.Generator`` on the card:
     integer outputs equal and floats bit for bit, three ``swept_box_hits``
     launches (simple rollouts; the rotate-shortest-angle and the
     recovery's rotate-in-place rollouts, S = 2) and two
     ``masked_min_distance`` launches and one ``walk_table`` launch per
     tick;
 15. the golden chain with JAX's own MCL draws, each tick teacher-forced
     on the recorded true pose, twist and MCL state: decisions, command
     sources, planner states, plan_ok and iterations equal JAX's, commands,
     plan poses and MCL errors within 1e-5;
 16. as step 3, on the arguments of warm ticks 1 and 6 with four robots'
     obstacles replaced by a ring that every rollout hits, so that every
     call shape (S = 289 and S = 2) holds both outcomes; the walk kernel
     as in step 11, at every walk of ticks 0-6.

Then the sharded phase, on the fleet phase's world, start state, draws
and inputs (64 robots, full width); any failed check raises:
 23. ``init_process_group("nccl")`` at world size 1 (MASTER_ADDR
     127.0.0.1, a free port; no other backend stands in) and a 1-D
     ``make_fleet_mesh``;
 24. ``sharded_fleet_full_tick`` over the cold tick and two warm ticks:
     every output and the whole state bit-equal to the unsharded
     ``fleet_full_tick``, the reduced count equal to its TRAJECTORY_FOUND
     count, three ``swept_box_hits``, two ``masked_min_distance`` and
     one ``walk_table`` launch a tick; ``sharded_fleet_tick`` (headline,
     64 robots) and ``sharded_fleet_tick_multihost`` over a (1, 1)
     ``(dcn, ici)`` mesh equal to ``fleet_tick``, their reduced mean cost
     bit-equal;
 25. as step 3, on the sharded tick's arguments at ticks 1 and 2 with
     four robots ringed; the walk kernel as in step 11, at every walk of
     ticks 0-2; ``destroy_process_group``.

Then the session phase: one robot's ``NavigationSession`` through the
session demo's scenario (``entry.session_scenario()``: the 14×8 m floor at
0.2 m, 2,911 ground nodes, a 2.8 m wall across the route, a 72×72×24
window, a 32×360 range image, 24×240 simulated rays, 66 samples of 64
steps and 2 × 256 rotate steps against all 2,048 observation points,
1,024 relaxation iterations, the LOS gate over 4,096 long edges, DWA
replans at 10 Hz; two depth cameras of 3 × 1,024 points, a no-entry zone
and a 0.2 m/s zone); any failed check raises:
 18. builds the session;
 19. replays the JAX session's recorded ticks
     (``dddmr_navigation_tpu_torch/testdata/session_golden.npz``) from
     their recorded inputs: decisions, planner states, plan pose counts,
     done, succeeded and DWA pivots equal JAX's, commands and the composed
     field within 1e-5;
 20. runs the scenario closed loop on the kernel path and on the plain
     path: equal bit for bit, SUCCESS within 0.6 m of the goal, more than
     0.2 m from the wall, never inside the no-entry zone, all three
     kernels launched; the walk kernel as in step 11, at every walk of
     the kernel path's loop (1 × 41,824 edge states);
 21. as step 3, on the arguments of the align-heading ticks 3 and 4 (both
     generators run), tick 4's collision calls with a ring that every
     rollout hits: the simple call (1, 66, 64, K 2,048), the rotate call
     (1, 2, 256, K 2,048), the stick-path (1 × 4,224) and toward-plan
     (1 × 66) distance calls;
 22. runs the session with the threaded plan manager to SUCCESS, its
     worker publishing plans.

Then the localization phase (``entry.global_localization_scenario()``:
the JAX package's box world, a 0.2 m submap, 2,048 seed particles × 16
yaws shrunk ×0.75 every second tick to 32, 192 sharp features in 9 m);
any failed check raises:
 26. the box world written as a pose graph of four keyframes
     (``write_pose_graph``), read back equal; ``SubmapManager.initialize``
     on the card equal to ``build_submap_context`` of the same stitched
     points; a drift past a 1 m trigger prefetches on the warm-up thread,
     and the swapped-in context is complete and equal to the new center's;
 27. the JAX chain (``dddmr_navigation_tpu_torch/testdata/
     globalloc_golden.npz``) from JAX's seed and update draws, unforced
     and teacher-forced on JAX's MCL state each tick: particle counts,
     ``fix_cnt`` and the fixed tick exact; teacher-forced, estimates and
     particles within rtol 2e-6 (atol 1e-6), the map→odom LPF states
     within atol 2e-5, a value that is not finite failing, but for
     resampling flips of at most ``LOC_FLIP_SHARE`` of a tick's
     particles; both fixed within 1.0 m of the truth;
 28. ``draw_seed`` covers [0, G) and [0, 16) exactly in 64 draws a node;
     closed loops from ``torch.Generator`` seeds ``LOC_SEEDS``, each
     seeded from its generator's draws: each reaches ``fixed``, at least
     ``LOC_MIN_WITHIN`` within 1.0 m;
 29. ``preprocess_features`` (96 flat, 192 sharp) on the card equal to
     the CPU's (masks exact, weights within 1e-6, normals within 1e-5);
     ``integrate_log`` of 1,000 steps within 1e-5 m of the CPU's.

Then the SLAM phase (``entry.slam_scenario()``: ``bench.py::bench_slam``'s
16 m room with two boxes, ``SlamConfig()``: a 16×1,000 range image,
64/512/256/2,048 features, 12 + 6 Gauss-Newton iterations, submap pads of
2,048 and 4,096, a 256-keyframe and 512-edge graph, whose normal system is
1,536 × 1,536; 56 scans on a 3 m circle at 0.4 m a scan, 1.15 laps). It
runs none of the hand-written kernels (the JAX SLAM reaches no Pallas
kernel); any failed check raises:
 30. the JAX run (``dddmr_navigation_tpu_torch/testdata/slam_golden.npz``)
     replayed teacher-forced at every scan (the port's session put in the
     state JAX started the scan from, the submap rebuilt from it): each
     keyframe scan's features equal JAX's bit for bit; the poses after
     odometry, refinement and the scan, the ICP result and the optimized
     graph within ``SLAM_TOL``; keyframe, edge, loop and loop-candidate
     integers exact;
 31. the scenario closed loop on the card, unforced: its keyframe count
     and loop closures against JAX's (``SLAM_KF_SLACK``,
     ``SLAM_LOOP_SLACK``), the last pose within 0.5 m of the truth, the
     largest departure from JAX's poses printed;
 32. the run's map saved (``MappingSession.save``) and read back equal;
     localization on it (``entry.run_slam_localization``: a
     ``SubmapManager``, 48 particles from the true start, 10 ticks along
     the mapped route) from each of ``SLAM_LOC_SEEDS``: finite estimates,
     the median final error within ``SLAM_LOC_FINAL``; ``GraphEditor``
     load → ``add_icp_edge`` on the first loop pair → ``optimize`` →
     ``save``, read back equal.

Then the semantic phase (``entry.semantic_scenario()``: the committed
19-class DDRNet-slim artifact, net width 48, 240×320, ~1.43 M parameters,
on the 8 EVAL-family frames of the JAX test's seed; ``bench.py::
bench_semantic``'s shape), and the runtime on the card. It runs none of
the hand-written kernels (the JAX net reaches no Pallas kernel: its
convolutions run in cuDNN here); any failed check raises:
 35. the frames regenerated from the seed against the golden file's
     checksums (``dddmr_navigation_tpu_torch/testdata/
     semantic_golden.npz``, ``tools/make_semantic_golden.py``); frame 0's
     logits within ``SEM_LOGITS_TOL`` of JAX's; the class masks at batch 8
     equal JAX's wherever its top-two gap exceeds 2·``SEM_LOGITS_TOL``,
     at most ``SEM_FLIP_SHARE`` of the pixels flipped; mIoU within 0.005
     of JAX's and at least max(0.30, 0.8 × the artifact's held-out mIoU −
     0.1), the JAX test's floor; the f32 logits convolution within 1e-5 of
     f64 with TF32 allowed in the process (so ``semantic.ieee_f32`` turns
     it off), its f32 resize equal to the CPU's bit for bit;
 36. the 4-class reroute chain (``entry.run_semantic_reroute``): > 90 % of
     the detected zone points in the true zone, the straight plan equal to
     JAX's and the zone's bending > 1.2 m inside x ∈ (2, 5), the mask as
     JAX's but for 0.1 % of its pixels;
 37. 12 Adam steps on the card from the JAX train test's initial weights
     (stored in the golden file): the loss falls ≥ 10 %, each step's within
     2 % of JAX's;
 40. ``entry.session_checkpoint_round_trip`` on the full session scenario
     (``runtime.CheckpointManager``: the restored session ticks as the
     original does) and ``runtime.tracing.trace`` writing a trace with the
     card's kernels.

Then the mark/clear graph phase (``entry.mark_clear_scenario``: robots
driving past two boxes on a 4 × 4 m floor, a 32 × 32 × 16 window, 12
ticks); any failed check raises:
 41. for one robot clustering on the full lattice and four on the pooled
     one, ``perception_update`` (one CUDA graph a tick) against its eager
     body from the same state at every tick: grid, origin, dGraph and
     clear offset equal bit for bit; a state kept from a tick unchanged
     by the next; one capture and 11 replays, in the graph's counts and
     the recorder's; the recorder's marked-cell counters equal to the
     eager body's; a new map of equal tables captures a new graph.

No step 6, 12, 17, 33, 34, 38 or 39: the benchmark measures the port, so
this script times nothing, and the other steps keep the numbers that the
documents cite. The last line is ``{"ok": true, "device": {...}}``. TF32
is off and matmuls run at full f32 ("highest"): the fused tick's distance
field and cluster sums are matmuls, as the JAX package runs them at
Precision.HIGHEST.
"""
import contextlib
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
TICKS = 50
ROBOTS = 64
CHECK_TICKS = (0, TICKS // 2, TICKS - 1)   # kernel vs plain at these ticks
PER_TICK = {"swept_box_hits": 1, "masked_min_distance": 2}   # launches
ADVERSARIAL_SEED = 3

FUSED_TICKS = 20                  # the golden chain's length
FUSED_CHECK_TICKS = (0, 10, FUSED_TICKS - 1)
# A box in the robot's path for the kernel checks only: config 3's own box
# lies behind the robot, and no rollout of the chain reaches it.
FUSED_CHECK_BOX = ((9.1, 7.6, 0.0), (9.5, 8.0, 1.0))

FLEET_PER_TICK = {"swept_box_hits": 3, "masked_min_distance": 2}
WALKS_PER_TICK = 1                # one extraction a fused or fleet tick
FLEET_CHECK_TICKS = (1, 6)        # kernel vs plain on these warm ticks
FLEET_RING_ROBOTS = (0, 1, 2, 3)  # their recorded obstacles get a ring
FLEET_SEED = 4                    # the chains' torch.Generator seed
FLEET_INT = ("decision", "cmd_source", "ps_simple", "ps_rotate", "plan_ok",
             "wf_iters", "best_index", "recovery_active")
FLEET_FLOAT = ("vx", "wz", "plan_pos", "plan_yaw", "mcl_err")

SHARDED_TICKS = 3                 # the cold tick and two warm ones
SHARDED_CHECK_TICKS = (1, 2)      # kernel vs plain on these sharded ticks
PG_TIMEOUT_S = 120                # NCCL's init and collectives
LOC_SEEDS = tuple(range(16))      # the closed loops' torch.Generator seeds
# Global localization from a random start lands within the JAX test's
# 1.0 m on some seeds only, in either package: the JAX test fixes one key,
# PRNGKey(3), and keys 0-7 land within it 2 times in 8
# (tools/globalloc_success_rate.py). The card's generator gives each seed
# the same draws on every run, and 9 of these 16 loops landed within it
# on the H100 (PERF.md); the bound leaves two for resampling's ulps to
# move. The replay of the JAX test's own draws (step 27) holds the bound
# on its one start.
LOC_MIN_WITHIN = 7
LOC_COVER_DRAWS = 64              # seed draws per value in the range check
# Resampling copies the particle whose cumulative weight first reaches
# each scan point; the card's weights differ from XLA-on-the-CPU's in
# the last ulps, so a scan point on a boundary takes the neighbouring
# particle. A teacher-forced tick may flip this share of its particles.
LOC_FLIP_SHARE = 0.01
LOC_ODOM_STEPS = 1000
LOC_KEYFRAMES = ((-4.0, 0.0, 0.3), (-1.5, 0.0, -0.4), (1.5, 0.0, 1.1),
                 (4.0, 0.0, -2.0))  # the pose graph's (x, y, yaw)
LOC_SUBMAP_RADIUS = 3.0
SESSION_CHECK_TICKS = (3, 4)      # align-heading ticks: both generators run
SESSION_RING_TICK = 4             # its collision calls get the ring
# The teacher-forced SLAM replay against JAX: poses in metres and
# quaternion components, the ICP fitness relative (the CPU holds 1.7e-6
# over all 56 scans).
SLAM_TOL = 1e-5
# An unforced mapping run departs from JAX's by centimetres within a few
# scans in either package (one ulp of a scan point moves the JAX run itself
# by 1.9 cm at scan 1), so a keyframe may fall a scan earlier or later and
# a loop close against a neighbouring keyframe: on the CPU this step ends
# with JAX's 20 keyframes, three of its four loops against the keyframe
# before JAX's. On the H100 the keyframe count and all four loop pairs
# equal JAX's, the same in every run (ROADMAP Queue 3), and are held so.
SLAM_KF_SLACK = 0                 # keyframes at the end, against JAX's
SLAM_LOOP_SLACK = 0               # a loop's older keyframe, against JAX's
SLAM_LOC_SEEDS = tuple(range(16))  # the localization passes' generators
# MCL on the saved map (corner features only, as the reference's pcdSaver
# stitches it) keeps within 0.5 m for 4 % of JAX's estimates over keys
# 0-15; their final errors have median 1.62 m and reach 3.59 m
# (tools/slam_localization_rate.py). The card's passes are held to JAX's
# largest final error in the median.
SLAM_LOC_FINAL = 3.59
# The segmenter's logits against JAX's: its activations are bf16, and where
# a sum's order differs (a convolution, a group statistic) an activation
# rounds to the neighbouring bf16 value now and then; through the last
# layers that moves a logit by a few hundredths (0.021-0.035 over the 8
# frames on the CPU, whose logits span +-27). The same bounds hold the CPU
# (tests/test_torch_semantic.py).
SEM_LOGITS_TOL = 0.05
SEM_FLIP_SHARE = 5e-4             # class flips, share of the pixels
SEM_CKPT_TICKS = 4                # session ticks before the checkpoint


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


@contextlib.contextmanager
def critics_calling(hits_fn, dist_fn):
    """Point the critics at other functions for the two kernel calls."""
    from dddmr_navigation_tpu_torch.planning.local import critics
    saved = critics.swept_box_hits, critics.masked_min_distance
    critics.swept_box_hits, critics.masked_min_distance = hits_fn, dist_fn
    try:
        yield
    finally:
        critics.swept_box_hits, critics.masked_min_distance = saved


def recorder_pair(check_ticks, per_tick=PER_TICK):
    """Wrappers of the two kernel entry points that keep the arguments of
    the calls made at ``check_ticks`` (tick = call count // calls per
    tick). Returns ({name: wrapper factory}, {name: [(tick, args)]})."""
    calls = {name: [] for name in per_tick}
    seen = dict.fromkeys(per_tick, 0)

    def recorder(name, fn):
        def rec(*args):
            if seen[name] // per_tick[name] in check_ticks:
                calls[name].append((seen[name] // per_tick[name], args))
            seen[name] += 1
            return fn(*args)
        return rec
    return recorder, calls


def check_compacted(torch, args):
    """The distance kernel computes only the valid points, and the parking
    point once: that point set, from its plain mirror, must give the plain
    version's distances."""
    from dddmr_navigation_tpu_torch.ops.distance_field import (
        masked_min_distance_compacted_plain, masked_min_distance_plain)
    _, out = masked_min_distance_compacted_plain(*args)
    check(torch.equal(out, masked_min_distance_plain(*args)),
          "the distance kernel's compacted point set changed a distance")


def check_kernels(kernels, calls, check_ticks, per_tick=PER_TICK):
    """Each kernel against its plain version on the recorded arguments,
    bit for bit (hits and distances); the plain hits of each call shape
    must hold both outcomes over the checked ticks, and the distance
    kernel's compacted point set must give the plain distances."""
    import torch
    check(all(len(calls[k]) == per_tick[k] * len(check_ticks)
              for k in calls),
          f"unexpected kernel calls per tick: "
          f"{ {k: len(v) for k, v in calls.items()} }")
    for name, k in kernels.items():
        outcomes = {}
        for t, args in calls[name]:
            got = k["kernel"](*args)
            want = k["plain"](*args)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"{name}: {got.shape}/{got.dtype} vs plain "
                  f"{want.shape}/{want.dtype}")
            if got.dtype == torch.bool:
                err = int((got != want).sum())
                check(err == 0, f"{name} tick {t}: {err} hits differ "
                      f"from plain")
                shape = "x".join(str(d) for d in args[0].shape[:3])
                hits, total = outcomes.get(shape, (0, 0))
                outcomes[shape] = (hits + int(want.sum()),
                                   total + want.numel())
                what = f"{int(want.sum())}/{want.numel()} hits"
            else:
                check(bool((want < 1e6).any()),
                      f"{name} tick {t}: every plain distance is masked")
                err = float((got - want).abs().max())
                check(torch.equal(got, want), f"{name} tick {t}: distances "
                      f"differ from plain (max abs {err!r})")
                check_compacted(torch, args)
                what = f"{int((want < 1e6).sum())}/{want.numel()} unmasked"
            shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
            print(f"{name} tick {t} {shapes} ({what}): equal to plain")
        # both outcomes occur at every call shape, so a kernel that never
        # (or always) hits disagrees with the plain version above
        for shape, (hits, total) in outcomes.items():
            check(0 < hits < total, f"{name} {shape}: the plain version "
                  f"gives {hits}/{total} hits at ticks {check_ticks}; the "
                  f"comparison could not fail")


def adversarial_checks(torch, dev, kernels):
    """Each kernel against the plain version on the adversarial inputs of
    ``ops/adversarial.py`` (faces, corners, the cull's sphere radius ± its
    margin, ±1 ulp around minima, all-invalid sets, 100 m coordinates),
    bit for bit."""
    from dddmr_navigation_tpu_torch.ops import adversarial
    box = [torch.as_tensor(a, device=dev)
           for a in adversarial.box_inputs(ADVERSARIAL_SEED)]
    sets = {"swept_box_hits": [(*box, adversarial.HALF)],
            "masked_min_distance": [
                [torch.as_tensor(a, device=dev)
                 for a in adversarial.dist_inputs(ADVERSARIAL_SEED, q=q)]
                for q in (1000, 40000)]}     # the narrow and wide variants
    for name, k in kernels.items():
        for args in sets[name]:
            got = k["kernel"](*args)
            want = k["plain"](*args)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"{name}: differs from plain on adversarial inputs")
            if name == "swept_box_hits":
                check(0 < int(want.sum()) < want.numel(),
                      "adversarial hits hold one outcome only")
            else:
                check_compacted(torch, args)
            shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
            print(f"adversarial {name} {shapes}: kernel equal to plain")


@contextlib.contextmanager
def walk_calling(fn):
    """Point the extractions at another function for the walk kernel's
    call (``planning/global_/wavefront.py::walk_table``)."""
    from dddmr_navigation_tpu_torch.planning.global_ import wavefront
    saved = wavefront.walk_table
    wavefront.walk_table = fn
    try:
        yield
    finally:
        wavefront.walk_table = saved


@contextlib.contextmanager
def plain_path(ops):
    """Every kernel call on its plain PyTorch version."""
    with critics_calling(ops.swept_box_hits_plain,
                         ops.masked_min_distance_plain), \
            walk_calling(ops.walk_table_plain):
        yield


@contextlib.contextmanager
def walks_recorded(ops):
    """Keep the arguments of every successor-table walk the extractions
    make, each still run by the kernel."""
    calls = []

    def rec(*args):
        calls.append(args)
        return ops.walk_table(*args)
    with walk_calling(rec):
        yield calls


def cut_walk(torch, args):
    """A walk's arguments with each robot's path made stuck at the state
    three hops after its first, so that it stops short of the goal."""
    succ, stuck, e0 = args[:3]
    e = e0
    for _ in range(3):
        e = succ.gather(1, e[:, None])[:, 0]
    stuck = stuck.clone()
    stuck[torch.arange(e.shape[0], device=e.device), e] = True
    return (succ, stuck, e0) + tuple(args[3:])


def check_walks(torch, ops, calls, what):
    """The walk kernel against its plain version at every recorded call and
    at its cut copy: idxs, valids, length and final equal bit for bit,
    dtypes included. Over them some robot's walk must reach its goal and
    some stop short of it, so that the comparison could fail either way."""
    check(len(calls) > 0, f"{what}: no successor-table walk recorded")
    before = ops.walk_table.launches
    reached = stopped = 0
    for i, args in enumerate(calls):
        for tag, a in (("", args), (" cut", cut_walk(torch, args))):
            got = ops.walk_table(*a)
            want = ops.walk_table_plain(*a)
            torch.cuda.synchronize()
            for name, x, y in zip(("idxs", "valids", "length", "final"),
                                  got, want):
                check(x.dtype == y.dtype and torch.equal(x, y),
                      f"{what} walk {i}{tag}: {name} differs from plain")
            at_goal = want[3] == a[6]
            reached += int(at_goal.sum())
            stopped += int((~at_goal).sum())
    check(ops.walk_table.launches == before + 2 * len(calls),
          f"{what}: the walk kernel launched "
          f"{ops.walk_table.launches - before} times for {2 * len(calls)} "
          f"walks")
    check(reached > 0 and stopped > 0, f"{what}: {reached} walks reach "
          f"the goal and {stopped} stop short; the comparison could not "
          f"fail both ways")
    print(f"{what}: walk kernel equal to plain at {len(calls)} walks and "
          f"their cut copies ({reached} robots' walks reach the goal, "
          f"{stopped} stop short)")


def reset_launches(ops):
    ops.swept_box_hits.launches = 0
    ops.masked_min_distance.launches = 0
    ops.walk_table.launches = 0


def read_launches(ops):
    return {"swept_box_hits": ops.swept_box_hits.launches,
            "masked_min_distance": ops.masked_min_distance.launches,
            "walk_table": ops.walk_table.launches}


def want_launches(per_tick, walks_per_tick, ticks):
    """Each kernel's launches over ``ticks`` ticks."""
    return {**{k: n * ticks for k, n in per_tick.items()},
            "walk_table": walks_per_tick * ticks}


def main():
    import numpy as np
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    check(os.path.isdir(os.path.join(ROOT, "dddmr_navigation_tpu_torch")),
          f"no dddmr_navigation_tpu_torch package beside {__file__}")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")

    from dddmr_navigation_tpu_torch import entry, ops
    from dddmr_navigation_tpu_torch.ops import build

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # 2. build
    lib_path, report = build.build()
    build.load_library()
    print(f"build: {os.path.relpath(lib_path, ROOT)}")
    for line in report.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    kernels = {
        "swept_box_hits": dict(kernel=ops.swept_box_hits,
                               plain=ops.swept_box_hits_plain),
        "masked_min_distance": dict(kernel=ops.masked_min_distance,
                                    plain=ops.masked_min_distance_plain),
    }
    adversarial_checks(torch, dev, kernels)
    shared = {}
    headline_phase(np, torch, dev, entry, ops, kernels)
    fused_phase(np, torch, dev, entry, ops, kernels)
    fleet_phase(np, torch, dev, entry, ops, kernels, shared)
    sharded_phase(torch, entry, ops, kernels, shared)
    shared.clear()
    session_phase(np, torch, dev, entry, ops, kernels)
    localization_phase(np, torch, dev, entry)
    slam_phase(np, torch, dev, entry)
    semantic_phase(np, torch, dev, entry)
    mark_clear_graph_phase(torch, dev, entry)

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def headline_phase(np, torch, dev, entry, ops, kernels):
    """Steps 3-5: the 64-robot headline chain."""
    cfg = entry.headline_config()
    plans, state, obstacles, obs_valid = entry.headline_inputs(
        cfg, ROBOTS, dev)

    # 3. each kernel against its plain version, on the arguments the chain
    # gives it at CHECK_TICKS. Tick 0's collision sweep cannot hit anything
    # (the robots stand still, every obstacle is beyond the swept boxes), so
    # later ticks, where some samples hit and others do not, are checked too.
    recorder, calls = recorder_pair(CHECK_TICKS)
    with critics_calling(recorder("swept_box_hits", ops.swept_box_hits),
                         recorder("masked_min_distance",
                                  ops.masked_min_distance)):
        entry.run_chain(cfg, plans, state, obstacles, obs_valid,
                        max(CHECK_TICKS) + 1)
    torch.cuda.synchronize()
    check_kernels(kernels, calls, CHECK_TICKS)

    # 4. the 50-tick chain, through the kernels, then through the plain
    # versions; the launch counters are read around the kernel run only
    reset_launches(ops)
    chain = entry.run_chain(cfg, plans, state, obstacles, obs_valid, TICKS)
    torch.cuda.synchronize()
    launches = read_launches(ops)
    print(f"launches in the {TICKS}-tick chain: {launches}")
    want = want_launches(PER_TICK, 0, TICKS)
    check(launches == want, f"launch counts {launches}, expected {want}")
    with plain_path(ops):
        plain = entry.run_chain(cfg, plans, state, obstacles, obs_valid, TICKS)
    torch.cuda.synchronize()
    check(read_launches(ops) == launches, "plain chain launched a kernel")
    for field in ("state", "best_index", "found"):
        a, b = getattr(chain, field), getattr(plain, field)
        check(torch.equal(a, b), f"chain {field} differs kernel vs plain: "
              f"{torch.nonzero(a != b)[:5].tolist()}")
    pos_err = float((chain.final.pos - plain.final.pos).abs().max())
    check(bool(torch.isfinite(chain.final.pos).all()), "non-finite poses")
    print(f"chain: found per tick {chain.found.tolist()}; final pose diff "
          f"kernel vs plain {pos_err!r} m; travelled "
          f"{float((chain.final.pos - state.pos)[:, 0].mean()):.3f} m")

    # 5. tick 0 against the JAX package
    g = np.load(os.path.join(ROOT, "dddmr_navigation_tpu_torch", "testdata",
                             "headline_tick0.npz"))
    st, bi = chain.state[0].cpu().numpy(), chain.best_index[0].cpu().numpy()
    vx, wz = chain.vx[0].cpu().numpy(), chain.wz[0].cpu().numpy()
    check(np.array_equal(st, g["state"]), "tick 0 state differs from JAX")
    ties = 0
    for b in np.flatnonzero(bi != g["best_index"]):
        gap = abs(float(g["costs"][b, bi[b]] - g["costs"][b, g["best_index"][b]]))
        check(gap <= 1e-5, f"robot {b}: best index {bi[b]} vs JAX "
              f"{g['best_index'][b]}, cost gap {gap}")
        ties += 1
    dvx = float(np.abs(vx - g["vx"]).max())
    dwz = float(np.abs(wz - g["wz"]).max())
    check(dvx <= 1e-5 and dwz <= 1e-5, f"tick 0 vx/wz off JAX: {dvx} {dwz}")
    print(f"golden tick 0: states equal, best index equal on "
          f"{ROBOTS - ties}/{ROBOTS} robots ({ties} ties within 1e-5), "
          f"max |dvx| {dvx!r} |dwz| {dwz!r}")
    codes = chain.state.cpu().numpy()
    bad = np.argwhere(codes != g["chain_state"][:TICKS])
    check(bad.size == 0, f"chain state codes differ from JAX at (tick, robot) "
          f"{bad[:5].tolist()}")
    print(f"golden chain: all {codes.size} state codes of the {TICKS}-tick "
          f"chain equal JAX's")


def fused_phase(np, torch, dev, entry, ops, kernels):
    """Steps 7-11: bench config 3's fused tick at full width."""
    from dddmr_navigation_tpu_torch.planning.global_ import wavefront as tw

    g = np.load(os.path.join(ROOT, "dddmr_navigation_tpu_torch", "testdata",
                             "config3_golden.npz"))

    # 7. build
    cfg = entry.config3_config()
    c3 = entry.config3_inputs(cfg, dev)
    fm = c3.fmap
    gp, p, lp = cfg.global_planner, cfg.perception, cfg.local_planner
    n_nodes, k_nbr = fm.nbr_idx.shape
    print(f"fused: config 3 built: G={n_nodes} ground nodes, K={k_nbr} "
          f"neighbors, "
          f"{gp.turning_dir_bins} direction bins; window "
          f"{p.voxel_window_cells_xy}x{p.voxel_window_cells_xy}x"
          f"{p.voxel_window_cells_z} = {p.voxel_window_cells_xy ** 2 * p.voxel_window_cells_z}"
          f" cells; {p.lidar.range_image_rows * p.lidar.range_image_cols} "
          f"scan points; {lp.generator.n_samples_padded} samples x "
          f"{lp.generator.max_num_steps} steps", flush=True)

    # 8. the map's tables against JAX's
    def on_dev(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    bins_ok = torch.equal(fm.wf_bins.cpu(),
                          torch.as_tensor(g["bins"].astype(np.int32)))
    az_err = float((fm.wf_az - on_dev(g["az"])).abs().max())
    pen_err = float((fm.turn_pen - on_dev(g["turn_pen"])).abs().max())
    print(f"fused map tables: bins equal JAX's: {bins_ok}; max |az| diff "
          f"{az_err!r}; max |turning table| diff {pen_err!r}")
    check(bins_ok, "direction bins differ from JAX's: "
          f"{int((fm.wf_bins.cpu().numpy() != g['bins']).sum())} edges")
    check(az_err <= 1e-6 and pen_err <= 1e-6,
          f"edge azimuths / turning table off JAX: {az_err} {pen_err}")

    # 9. teacher-forced stages from the golden's tick-0 tables
    enter = on_dev(g["enter"])[None]
    goal_idx = on_dev(g["goal_idx"], torch.int64).view(1)
    start_idx = on_dev(g["start_idx"], torch.int64).view(1)
    bins = on_dev(g["bins"], torch.int32)
    field, _, iters = tw.wavefront_distances_turning(
        fm.nbr_idx, fm.nbr_dist, fm.nbr_valid[None], enter,
        fm.avg_intensity, goal_idx, fm.ground, gp.turning_weight,
        n_dir_bins=gp.turning_dir_bins, max_iters=gp.max_relax_iters,
        az=on_dev(g["az"]), bin_of_edge=bins)
    want_field = torch.as_tensor(g["relaxed"])
    n_diff = int((field[0].cpu() != want_field).sum())
    print(f"teacher-forced relaxation: {int(iters[0])} iterations (JAX "
          f"{int(g['wf_iters'][0])}), {n_diff} of {want_field.numel()} "
          f"field entries differ from JAX's")
    check(n_diff == 0 and int(iters[0]) == int(g["wf_iters"][0]),
          "teacher-forced relaxation differs from JAX's")
    ids, valid, length, ok = tw.extract_path_turning(
        fm.nbr_idx, fm.nbr_dist, fm.nbr_valid[None], enter,
        on_dev(g["relaxed"])[None], bins, start_idx, goal_idx, fm.ground,
        gp.turning_weight, max_len=gp.max_path_len,
        turn_pen=on_dev(g["turn_pen"]))
    ids_ok = np.array_equal(np.where(g["node_valid"], ids[0].cpu().numpy(), -1),
                            np.where(g["node_valid"], g["node_ids"], -1))
    valid_ok = np.array_equal(valid[0].cpu().numpy(), g["node_valid"])
    print(f"teacher-forced extraction: {int(length[0])} nodes, ids equal "
          f"JAX's: {ids_ok and valid_ok}")
    check(ids_ok and valid_ok and bool(ok[0]),
          "teacher-forced extraction differs from JAX's")

    # 10. the 20-tick chain, teacher-forced on the golden's poses
    def scans_for(world, check_golden):
        scans, masks, n_off = [], [], 0
        for t in range(FUSED_TICKS):
            pts, mask = entry.config3_scan(cfg, world, g["positions"][t],
                                           float(g["yaws"][t]))
            if check_golden:
                n = int(g["scan_count"][t])
                idx = g["scan_idx"][n_off:n_off + n].astype(np.int64)
                same = (np.array_equal(np.flatnonzero(mask), idx)
                        and np.array_equal(pts[idx],
                                           g["scan_pts"][n_off:n_off + n]))
                check(same, f"tick {t}: lidar_sim's scan differs from the "
                      f"golden's recorded scan")
                n_off += n
            scans.append(on_dev(pts)[None])
            masks.append(on_dev(mask)[None])
        return scans, masks

    scans, masks = scans_for(entry.config3_world(), True)
    print(f"scans: {FUSED_TICKS} sweeps simulated at the golden poses equal "
          f"the golden's recorded scans ({int(g['scan_count'].sum())} valid "
          f"points)")
    poses = [on_dev(g[k])[:, None] for k in ("positions", "quats", "v_in",
                                             "w_in")]
    state0 = entry.config3_state(c3)

    def run():
        return entry.run_fused_chain(c3, state0, scans, masks, *poses)

    reset_launches(ops)
    chain = run()
    torch.cuda.synchronize()
    launches = read_launches(ops)
    print(f"launches in the {FUSED_TICKS}-tick fused chain: {launches}")
    want = want_launches(PER_TICK, WALKS_PER_TICK, FUSED_TICKS)
    check(launches == want, f"fused launch counts {launches}, expected "
          f"{want}")
    with plain_path(ops):
        plain = run()
    torch.cuda.synchronize()
    check(read_launches(ops) == launches, "plain chain launched a kernel")
    for field_name in ("state", "plan_ok", "plan_count", "wf_iters",
                       "best_index"):
        a, b = getattr(chain, field_name), getattr(plain, field_name)
        check(torch.equal(a, b), f"fused chain {field_name} differs kernel "
              f"vs plain: {torch.nonzero(a != b)[:5].tolist()}")
    print(f"fused chain: kernel and plain paths equal; states "
          f"{chain.state[:, 0].tolist()}; plan counts "
          f"{chain.plan_count[:, 0].tolist()}; relaxation iterations "
          f"{chain.wf_iters[:, 0].tolist()}")

    # against the golden chain
    for field_name in ("state", "plan_ok", "plan_count", "wf_iters"):
        got = getattr(chain, field_name)[:, 0].cpu().numpy()
        check(np.array_equal(got, g[field_name]),
              f"fused {field_name} differs from JAX: {got.tolist()} vs "
              f"{g[field_name].tolist()}")
    best = chain.best_index[:, 0].cpu().numpy()
    ties = []
    for t in np.flatnonzero(best != g["best_index"]):
        gap = abs(float(g["costs"][t, best[t]]
                        - g["costs"][t, g["best_index"][t]]))
        check(gap <= 1e-5, f"fused tick {t}: best index {best[t]} vs JAX "
              f"{g['best_index'][t]}, cost gap {gap}")
        ties.append((int(t), gap))
    same = best == g["best_index"]
    dvx = float(np.abs(chain.vx[:, 0].cpu().numpy() - g["vx"])[same].max())
    dwz = float(np.abs(chain.wz[:, 0].cpu().numpy() - g["wz"])[same].max())
    d_first = float(np.abs(chain.composed_first[0].cpu().numpy()
                           - g["composed_first"]).max())
    d_last = float(np.abs(chain.composed_last[0].cpu().numpy()
                          - g["composed_last"]).max())
    d_plan = float(np.abs(chain.plan_positions[:, 0].cpu().numpy()
                          - g["plan_positions"]).max())
    print(f"golden fused chain: states, plan_ok, plan counts and iterations "
          f"equal JAX's; best index equal on {int(same.sum())}/{FUSED_TICKS} "
          f"ticks, ties {ties}; max |dvx| {dvx!r} |dwz| {dwz!r} (equal "
          f"indices); composed dGraph max diff tick 0 {d_first!r}, tick "
          f"{FUSED_TICKS - 1} {d_last!r} m; plan positions max diff "
          f"{d_plan!r} m")
    check(max(dvx, dwz) <= 1e-5, f"fused vx/wz off JAX: {dvx} {dwz}")
    check(max(d_first, d_last, d_plan) <= 1e-5,
          f"fused composed dGraph / plan off JAX: {d_first} {d_last} "
          f"{d_plan}")

    # 11. kernels against plain on the fused tick's arguments, with a box
    # in the robot's path so that some rollouts hit and some do not
    box_scans, box_masks = scans_for(entry.config3_world([FUSED_CHECK_BOX]),
                                     False)
    recorder, calls = recorder_pair(FUSED_CHECK_TICKS)
    n_check = max(FUSED_CHECK_TICKS) + 1
    with critics_calling(recorder("swept_box_hits", ops.swept_box_hits),
                         recorder("masked_min_distance",
                                  ops.masked_min_distance)), \
            walks_recorded(ops) as walks:
        entry.run_fused_chain(c3, state0, box_scans[:n_check],
                              box_masks[:n_check],
                              *(x[:n_check] for x in poses))
    torch.cuda.synchronize()
    check_kernels(kernels, calls, FUSED_CHECK_TICKS)
    check_walks(torch, ops, walks, "fused")


def with_ring(name, args, robots):
    """Collision-kernel arguments with the first 96 obstacles of
    ``robots`` replaced by a ring of radius 0.45 m around the robot at
    heights 0.1 and 0.35 m (the obstacles are robot-centered): every
    rollout of theirs hits, the others' keep their own outcome."""
    import math
    import torch
    if name != "swept_box_hits":
        return args
    axes, projc, step_valid, obs, obs_valid, half = args
    ang = torch.arange(48, device=obs.device) * (2.0 * math.pi / 48)
    ring = torch.stack([0.45 * torch.cos(ang), 0.45 * torch.sin(ang),
                        torch.full_like(ang, 0.1)], dim=1)
    ring = torch.cat([ring, ring + ring.new_tensor([0.0, 0.0, 0.25])])
    obs, obs_valid = obs.clone(), obs_valid.clone()
    rows = list(robots)
    obs[rows, :96] = ring
    obs_valid[rows, :96] = True
    return axes, projc, step_valid, obs, obs_valid, half


def fleet_phase(np, torch, dev, entry, ops, kernels, shared):
    """Steps 13-16: bench config 4's full-fidelity fleet at full width.
    Leaves the world, start state, draws and tick inputs in ``shared``
    for the sharded phase."""
    from dddmr_navigation_tpu_torch.interop import (
        DRAW_KEYS, port_draws, port_mcl_state)
    from dddmr_navigation_tpu_torch.state_estimation import pf

    g = np.load(os.path.join(ROOT, "dddmr_navigation_tpu_torch", "testdata",
                             "config4_golden.npz"))

    # 13. build
    c4 = entry.config4_inputs(device=dev)
    lp, p = c4.cfg.local_planner, c4.cfg.perception
    b, n = entry.CONFIG4_ROBOTS, c4.mcl.num_particles
    ticks = entry.CONFIG4_TICKS + 1
    print(f"fleet: config 4 built: {b} robots, "
          f"G={c4.fmap.nbr_idx.shape[0]} ground nodes, "
          f"K={c4.fmap.nbr_idx.shape[1]}, window "
          f"{p.voxel_window_cells_xy}x{p.voxel_window_cells_xy}x"
          f"{p.voxel_window_cells_z}, {p.lidar.max_scan_points} scan points, "
          f"{lp.generator.n_samples_padded} samples x "
          f"{lp.generator.max_num_steps} steps, rotate 2 x "
          f"{lp.rotate_generator.max_num_steps} steps, {n} particles, "
          f"{c4.walls.shape[0]} wall points", flush=True)
    inputs = [entry.config4_tick_inputs(c4, t, b) for t in range(ticks)]
    gen = torch.Generator(device=dev).manual_seed(FLEET_SEED)
    gen_draws = [pf.draw_mcl(gen, b, n, dev) for _ in range(ticks)]
    gold_draws = [port_draws({k: g[k][t] for k in DRAW_KEYS}, dev)
                  for t in range(ticks)]
    state0 = entry.config4_state(c4, (
        torch.as_tensor(g["init_pos_n"], device=dev),
        torch.as_tensor(g["init_rpy_n"], device=dev)))

    shared.update(c4=c4, state0=state0, draws=gen_draws, inputs=inputs)

    def run(draws=gen_draws, n_ticks=ticks, **kw):
        return entry.run_fleet_full_chain(
            c4, state0, draws.__getitem__, n_ticks,
            inputs_of=inputs.__getitem__, **kw)

    # 14. the cold tick and 10 warm ticks through the kernels, then through
    # the plain versions, closed loop from one state and one set of draws
    reset_launches(ops)
    chain, final = run()
    torch.cuda.synchronize()
    launches = read_launches(ops)
    print(f"launches in the {ticks}-tick fleet chain: {launches}")
    want = want_launches(FLEET_PER_TICK, WALKS_PER_TICK, ticks)
    check(launches == want, f"fleet launch counts {launches}, expected "
          f"{want}")
    with plain_path(ops):
        plain, pfinal = run()
    torch.cuda.synchronize()
    check(read_launches(ops) == launches, "plain chain launched a kernel")
    for f in FLEET_INT + FLEET_FLOAT:
        check(torch.equal(chain[f], plain[f]), f"fleet chain {f} differs "
              f"kernel vs plain: {torch.nonzero(chain[f] != plain[f])[:5]}")
    check(torch.equal(final.mcl.particles.pos, pfinal.mcl.particles.pos)
          and torch.equal(final.pos, pfinal.pos),
          "fleet final state differs kernel vs plain")
    check(all(bool(torch.isfinite(chain[f]).all()) for f in FLEET_FLOAT),
          "non-finite fleet outputs")
    dec = chain["decision"].cpu().numpy()
    print(f"fleet chain: kernel and plain paths equal (integers and floats "
          f"bit for bit); decisions per tick "
          f"{[np.bincount(d, minlength=10).tolist() for d in dec[[0, -1]]]} "
          f"(ticks 0 and {ticks - 1}); relaxation iterations "
          f"{chain['wf_iters'][:, 0].tolist()}; mcl_err max "
          f"{float(chain['mcl_err'].max()):.4f} m; travelled "
          f"{float((final.pos - state0.pos).norm(dim=1).mean()):.3f} m")

    # 15. against the golden chain, each tick started from the recorded
    # true pose, twist and MCL state (teacher-forced), with its draws
    def forced(t):
        return dict(pos=torch.as_tensor(g["pos"][t], device=dev),
                    quat=torch.as_tensor(g["quat"][t], device=dev),
                    v=torch.as_tensor(g["v"][t], device=dev),
                    w=torch.as_tensor(g["w"][t], device=dev),
                    mcl=port_mcl_state(g, t, dev))
    gold, _ = run(draws=gold_draws, forced=forced)
    for f in FLEET_INT[:6]:
        got = gold[f].cpu().numpy()
        bad = np.argwhere(got != g[f][:ticks])
        check(bad.size == 0, f"fleet {f} differs from JAX at (tick, robot) "
              f"{bad[:5].tolist()}")
    errs = {f: float(np.abs(gold[f].cpu().numpy() - g[f][:ticks]).max())
            for f in FLEET_FLOAT}
    print(f"golden fleet chain (teacher-forced on the recorded true poses "
          f"and MCL states): decisions, command sources, planner states, "
          f"plan_ok and iterations equal JAX's on all {ticks} x {b}; max "
          f"diffs {errs}")
    check(max(errs.values()) <= 1e-5, f"fleet floats off JAX: {errs}")

    # 16. kernels against plain on two warm ticks' arguments, four robots'
    # obstacles ringed so that every call shape holds both outcomes
    recorder, calls = recorder_pair(FLEET_CHECK_TICKS, FLEET_PER_TICK)
    with critics_calling(recorder("swept_box_hits", ops.swept_box_hits),
                         recorder("masked_min_distance",
                                  ops.masked_min_distance)), \
            walks_recorded(ops) as walks:
        run(n_ticks=max(FLEET_CHECK_TICKS) + 1)
    torch.cuda.synchronize()
    calls = {name: [(t, with_ring(name, a, FLEET_RING_ROBOTS))
                    for t, a in cs] for name, cs in calls.items()}
    check_kernels(kernels, calls, FLEET_CHECK_TICKS, FLEET_PER_TICK)
    check_walks(torch, ops, walks, "fleet")


def session_phase(np, torch, dev, entry, ops, kernels):
    """Steps 18-22: the single-robot navigation session (perception, depth
    cameras, zone layers, DWA replans, the local planner, the move-base
    FSM) at the session demo's full width."""
    g = np.load(os.path.join(ROOT, "dddmr_navigation_tpu_torch", "testdata",
                             "session_golden.npz"))

    # 18. build
    sc = entry.session_scenario()
    lp, p = sc.cfg.local_planner, sc.cfg.perception
    sess = entry.make_session(sc, dev)
    n_nodes, k_nbr = sess.driver.runtime.graph.nbr_idx.shape
    print(f"session: built: G={n_nodes} ground nodes, K={k_nbr}; window "
          f"{p.voxel_window_cells_xy}x{p.voxel_window_cells_xy}x"
          f"{p.voxel_window_cells_z}; range image "
          f"{p.lidar.range_image_rows}x{p.lidar.range_image_cols}; "
          f"{lp.generator.n_samples_padded} samples x "
          f"{lp.generator.max_num_steps} steps, rotate 2 x "
          f"{lp.rotate_generator.max_num_steps}; {lp.max_obstacle_points} "
          f"observation points, near-K {lp.collision_near_k}; "
          f"{sc.cameras} cameras x {sc.buffer_depth} frames x "
          f"{sc.depth_points} points; {len(sc.no_entry)} no-entry and "
          f"{len(sc.speed_zone[0])} speed-zone points", flush=True)

    # 19. the golden's recorded ticks, unforced
    replay = entry.replay_session(sess, sc, g, forced=False)
    bad, dv, dw, dc = entry.replay_errors(g, replay)
    print(f"golden session replay ({len(replay)} recorded ticks, unforced): "
          f"integer mismatches {bad[:8]}; max |dvx| {dv!r} |dwz| {dw!r}; "
          f"composed field max diff {dc!r}; decisions "
          f"{[o['decision'] for o in replay[::10]]} (every 10th); pivots "
          f"{sorted(set(o['pivot'] for o in replay))[:12]}")
    check(not bad, f"session replay integers differ from JAX: {bad[:8]}")
    check(max(dv, dw, dc) <= 1e-5, f"session replay off JAX: {dv} {dw} {dc}")
    sess.close()

    # 20. closed loop on the kernel path and on the plain path
    def closed_loop(threaded=False):
        s_ = entry.make_session(sc, dev, threaded_plan_manager=threaded)
        try:
            ch = entry.run_session_chain(s_, sc, entry.SESSION_TICKS)
        finally:
            s_.close()
        torch.cuda.synchronize()
        return ch, s_

    reset_launches(ops)
    with walks_recorded(ops) as walks:
        chain, _ = closed_loop()
    launches = read_launches(ops)
    n = len(chain.vx)
    print(f"launches in the {n}-tick session chain: {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched in the session chain: {launches}")
    with plain_path(ops):
        plain, _ = closed_loop()
    check(read_launches(ops) == launches, "plain chain launched a kernel")
    for f in chain._fields:
        a, b = getattr(chain, f), getattr(plain, f)
        check(a.shape == b.shape and np.array_equal(a, b),
              f"session chain {f} differs kernel vs plain")
    pos = chain.pos
    final = pos[-1] + np.array([chain.vx[-1] * np.cos(chain.yaw[-1]) * 0.1,
                                chain.vx[-1] * np.sin(chain.yaw[-1]) * 0.1,
                                0.0], np.float32)
    to_goal = float(np.linalg.norm(final[:2] - sc.goal[:2]))
    (wx0, wy0, _), (wx1, wy1, _) = entry.SESSION_WALL
    dx = np.maximum(np.maximum(wx0 - pos[:, 0], pos[:, 0] - wx1), 0.0)
    dy = np.maximum(np.maximum(wy0 - pos[:, 1], pos[:, 1] - wy1), 0.0)
    clearance = float(np.hypot(dx, dy).min())
    lo, hi = sc.no_entry.min(0), sc.no_entry.max(0)
    entered = int(((pos[:, :2] >= lo[:2]) & (pos[:, :2] <= hi[:2]))
                  .all(1).sum())
    changes = [(int(t), int(chain.decision[t])) for t in range(n)
               if t == 0 or chain.decision[t] != chain.decision[t - 1]]
    print(f"session closed loop: kernel and plain paths equal bit for bit "
          f"over {n} ticks; succeeded {bool(chain.succeeded[-1])} at tick "
          f"{n - 1} ({n * 0.1:.1f} s simulated); final "
          f"distance to goal {to_goal:.3f} m; least wall clearance "
          f"{clearance:.3f} m; ticks in the no-entry zone {entered}; min y "
          f"{float(pos[:, 1].min()):.2f} m; decision changes {changes}; "
          f"golden chain {len(g['vx'])} ticks, succeeded "
          f"{bool(g['succeeded'][-1])}")
    check(bool(chain.succeeded[-1]) and to_goal < 0.6,
          f"session did not succeed near the goal ({to_goal} m)")
    check(clearance > 0.2, f"session came within {clearance} m of the wall")
    check(entered == 0, "session entered the no-entry zone")
    check_walks(torch, ops, walks, "session")

    # 21. the kernels at the session's call shapes, from the align-heading
    # ticks at the start (both generators run), the later tick's collision
    # calls with a ring that every rollout hits
    calls = {name: [] for name in kernels}
    cur = [0]

    def recorder(name, fn):
        def rec(*args):
            if cur[0] in SESSION_CHECK_TICKS:
                calls[name].append((cur[0], args))
            return fn(*args)
        return rec

    def inputs(t, p_, y_):
        cur[0] = t
        return entry.session_inputs(sc, p_, y_)

    s_chk = entry.make_session(sc, dev)
    with critics_calling(recorder("swept_box_hits", ops.swept_box_hits),
                         recorder("masked_min_distance",
                                  ops.masked_min_distance)):
        entry.run_session_chain(s_chk, sc, max(SESSION_CHECK_TICKS) + 1,
                                inputs=inputs)
    s_chk.close()
    torch.cuda.synchronize()
    calls = {name: [(t, with_ring(name, a, (0,)) if t == SESSION_RING_TICK
                     else a) for t, a in cs] for name, cs in calls.items()}
    per_check = {k: len(v) // len(SESSION_CHECK_TICKS)
                 for k, v in calls.items()}
    check_kernels(kernels, calls, SESSION_CHECK_TICKS, per_check)

    # 22. threaded plan manager to SUCCESS
    tch, t_sess = closed_loop(threaded=True)
    published = t_sess.driver.plan_manager.published
    print(f"threaded session: succeeded {bool(tch.succeeded[-1])} after "
          f"{len(tch.vx)} ticks; the worker published {published} plans on "
          f"its own CUDA stream")
    check(bool(tch.succeeded[-1]), "threaded session did not succeed")
    check(published > 0, "the plan worker published no plan")


def tree_diffs(torch, a, b, path="state"):
    """The paths at which two nested NamedTuples, tuples, lists or dicts
    of tensors differ: shape, type or any bit (NaN equal to NaN)."""
    if torch.is_tensor(a):
        if not torch.is_tensor(b) or a.shape != b.shape or a.dtype != b.dtype:
            return [path]
        same = torch.equal(a, b)
        if not same and a.is_floating_point():
            same = bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
        return [] if same else [path]
    if isinstance(a, dict):
        return sum((tree_diffs(torch, a[k], b[k], f"{path}.{k}")
                    for k in a), [])
    if isinstance(a, (tuple, list)):
        names = getattr(a, "_fields", range(len(a)))
        return sum((tree_diffs(torch, x, y, f"{path}.{n}")
                    for n, x, y in zip(names, a, b)), [])
    return [] if a == b else [path]


def sharded_phase(torch, entry, ops, kernels, shared):
    """Steps 23-25: the sharded fleet ticks over NCCL at world size 1 on
    the card, config 4 at full width."""
    import datetime
    import socket
    import torch.distributed as dist
    from dddmr_navigation_tpu_torch.parallel import fleet as tfleet
    from dddmr_navigation_tpu_torch.parallel import multihost

    c4, state0 = shared["c4"], shared["state0"]
    draws, inputs = shared["draws"], shared["inputs"]
    b = state0.pos.shape[0]

    # 23. NCCL at world size 1; no other backend stands in for it
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ["MASTER_ADDR"] = "127.0.0.1"
    os.environ["MASTER_PORT"] = str(port)
    dist.init_process_group("nccl", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        mesh = tfleet.make_fleet_mesh(device="cuda")
        check(tfleet.rank_block(mesh) == (0, 1), "rank block")
        print(f"sharded: NCCL process group at world size 1 on "
              f"{torch.cuda.get_device_name(0)} (port {port}); mesh "
              f"{mesh}", flush=True)
        _sharded_checks(torch, entry, ops, kernels, c4, state0, draws,
                        inputs, b, mesh, tfleet, multihost)
    finally:
        dist.destroy_process_group()


def _sharded_checks(torch, entry, ops, kernels, c4, state0, draws, inputs, b,
                    mesh, tfleet, multihost):
    def sharded(n_ticks):
        return entry.run_sharded_fleet_full_chain(
            c4, state0, draws.__getitem__, n_ticks, mesh,
            inputs_of=inputs.__getitem__)

    def unsharded(n_ticks):
        state, diags = state0, []
        for t in range(n_ticks):
            state, diag = entry.config4_tick(c4, state, t, draws[t],
                                             inputs=inputs[t])
            diags.append(diag)
        return {k: torch.stack([d[k] for d in diags]) for k in diags[0]}, \
            state

    # 24. the sharded full tick against the unsharded one: every output
    # and the whole state bit for bit, the reduced count equal to the
    # unsharded tick's TRAJECTORY_FOUND count; then the headline tick and
    # the multihost tick over a (1, 1) mesh
    reset_launches(ops)
    s_out, s_state, found = sharded(SHARDED_TICKS)
    torch.cuda.synchronize()
    launches = read_launches(ops)
    want = want_launches(FLEET_PER_TICK, WALKS_PER_TICK, SHARDED_TICKS)
    check(launches == want, f"sharded launch counts {launches}, expected "
          f"{want}")
    u_out, u_state = unsharded(SHARDED_TICKS)
    torch.cuda.synchronize()
    check(set(s_out) == set(u_out), "sharded diag keys differ")
    bad = [k for k in u_out if tree_diffs(torch, s_out[k], u_out[k])]
    check(not bad, f"sharded outputs differ from unsharded: {bad}")
    bad = tree_diffs(torch, s_state, u_state)
    check(not bad, f"sharded state differs from unsharded at {bad[:6]}")
    n_found = [float(f) for f in found]
    want_found = [float((u_out["ps_simple"][t] == 4).sum())
                  for t in range(SHARDED_TICKS)]
    check(n_found == want_found, f"reduced found counts {n_found}, "
          f"unsharded {want_found}")
    print(f"sharded full tick ({b} robots, {SHARDED_TICKS} ticks): "
          f"{len(u_out)} outputs and the whole state bit-equal to the "
          f"unsharded tick; reduced TRAJECTORY_FOUND counts {n_found}; "
          f"launches {launches}")

    cfg = entry.headline_config()
    plans, hstate, obstacles, obs_valid = entry.headline_inputs(
        cfg, ROBOTS, c4.fmap.ground.device)
    hargs = (plans, hstate, obstacles, obs_valid)
    want_cmd = tfleet.fleet_tick(cfg, *hargs)
    ok = want_cmd.best_cost >= 0
    want_mean = (torch.where(ok, want_cmd.best_cost, 0.0).sum()
                 / torch.clamp(ok.to(torch.float32).sum(), min=1.0))
    hmesh = multihost.make_host_mesh(1, 1, device="cuda")
    check(tuple(hmesh.mesh.shape) == (1, 1), "host mesh shape")
    for name, tick, m in (
            ("sharded_fleet_tick", tfleet.sharded_fleet_tick(cfg, mesh),
             mesh),
            ("sharded_fleet_tick_multihost",
             multihost.sharded_fleet_tick_multihost(cfg, hmesh), hmesh)):
        args = multihost.host_local_batch(
            m, tfleet.shard_fleet_arrays(m, hargs))
        vx, wz, codes, costs, mean = tick(*args)
        torch.cuda.synchronize()
        for got, ref, f in ((vx, want_cmd.vx, "vx"), (wz, want_cmd.wz, "wz"),
                            (codes, want_cmd.state, "state"),
                            (costs, want_cmd.best_cost, "best_cost")):
            check(torch.equal(got, ref), f"{name} {f} differs from "
                  f"fleet_tick")
        check(torch.equal(mean, want_mean), f"{name} mean cost "
              f"{float(mean)!r} vs {float(want_mean)!r}")
        print(f"{name} ({ROBOTS} robots): commands, codes and costs equal "
              f"to fleet_tick; reduced mean cost {float(mean)!r} over "
              f"{int(ok.sum())} robots")

    # 25. kernels against plain at the sharded tick's call shapes
    recorder, calls = recorder_pair(SHARDED_CHECK_TICKS, FLEET_PER_TICK)
    with critics_calling(recorder("swept_box_hits", ops.swept_box_hits),
                         recorder("masked_min_distance",
                                  ops.masked_min_distance)), \
            walks_recorded(ops) as walks:
        sharded(max(SHARDED_CHECK_TICKS) + 1)
    torch.cuda.synchronize()
    calls = {name: [(t, with_ring(name, a, FLEET_RING_ROBOTS))
                    for t, a in cs] for name, cs in calls.items()}
    check_kernels(kernels, calls, SHARDED_CHECK_TICKS, FLEET_PER_TICK)
    check_walks(torch, ops, walks, "sharded")


def _pose_graph(np, submaps, map_pts, ground_pts):
    """The box world as a pose graph: each keyframe of LOC_KEYFRAMES holds
    the map and ground points nearest to it (in x), in its own frame."""
    poses = np.zeros((len(LOC_KEYFRAMES), 8), np.float32)
    poses[:, 0] = [k[0] for k in LOC_KEYFRAMES]
    poses[:, 1] = [k[1] for k in LOC_KEYFRAMES]
    poses[:, 6] = [k[2] for k in LOC_KEYFRAMES]
    xs = poses[:, 0]

    def split(pts):
        owner = np.argmin(np.abs(pts[:, :1] - xs[None, :]), axis=1)
        out = []
        for i in range(len(xs)):
            r = submaps._rpy_matrix(0.0, 0.0, poses[i, 6])
            out.append(((pts[owner == i] - poses[i, :3]) @ r).astype(
                np.float32))
        return out
    return submaps.PoseGraph(poses, split(map_pts), split(ground_pts))


def localization_phase(np, torch, dev, entry):
    """Steps 26-29: the localization vertical at the global-localization
    scenario's full size (2,048 particles)."""
    import tempfile
    from dddmr_navigation_tpu_torch.interop import (
        mcl_fields, port_seed_draws, port_tick_of_one, tick_of)
    from dddmr_navigation_tpu_torch.state_estimation import (
        feature_weights, odom3d, submaps)
    from dddmr_navigation_tpu_torch.state_estimation.likelihood import (
        build_submap_context)

    g = np.load(os.path.join(ROOT, "dddmr_navigation_tpu_torch", "testdata",
                             "globalloc_golden.npz"))
    sc = entry.global_localization_scenario()
    n_ticks = int(g["n"].shape[0])

    # 26. the box world through pose-graph files and the submap manager
    graph = _pose_graph(np, submaps, sc.map_pts, sc.ground_pts)
    with tempfile.TemporaryDirectory() as d:
        submaps.write_pose_graph(d, graph)
        back = submaps.read_pose_graph(d)
    check(np.array_equal(back.poses, graph.poses)
          and all(np.array_equal(a, b) for a, b in zip(
              back.feature_clouds + back.ground_clouds,
              graph.feature_clouds + graph.ground_clouds)),
          "the pose graph did not read back equal")

    def ctx_diffs(a, b):
        return tree_diffs(torch, a, b, "ctx")

    center = np.asarray(entry.GLOBALLOC_CENTER, np.float32)
    mgr = submaps.SubmapManager(back, sc.cfg,
                                search_radius=LOC_SUBMAP_RADIUS,
                                warmup_trigger_distance=20.0, res=sc.res,
                                device=dev)
    ctx0 = mgr.initialize(center)
    direct = build_submap_context(
        *submaps.stitch_submap(back, center, LOC_SUBMAP_RADIUS), sc.cfg,
        res=sc.res, device=dev)
    check(not ctx_diffs(ctx0, direct), f"the manager's context differs: "
          f"{ctx_diffs(ctx0, direct)}")
    check(ctx0.map_field.dist.is_cuda, "the context is not on the card")
    far = center + np.float32([5.0, 0.0, 0.0])
    mgr.warmup_trigger_distance = 1.0
    check(mgr.current(far) is ctx0, "swapped before the warm-up")
    check(mgr.join(timeout=120.0), "the warm-up thread did not finish")
    ctx1 = mgr.current(far)
    check(ctx1 is not ctx0, "no swap after the warm-up")
    direct1 = build_submap_context(
        *submaps.stitch_submap(back, far, LOC_SUBMAP_RADIUS), sc.cfg,
        res=sc.res, device=dev)
    check(not ctx_diffs(ctx1, direct1), f"the swapped context differs: "
          f"{ctx_diffs(ctx1, direct1)}")
    check(ctx1.map_field.dist.is_cuda and bool(torch.isfinite(
        ctx1.map_field.dist).all()), "the swapped context is incomplete")
    check(ctx_diffs(ctx1, ctx0), "the swap kept the old submap")
    print(f"localization: pose graph of {len(back.poses)} keyframes "
          f"written and read back equal; submap at {center.tolist()} "
          f"(radius {LOC_SUBMAP_RADIUS} m) built on the card, equal to "
          f"build_submap_context; a drift to "
          f"{far.tolist()} prefetched on the warm-up thread and swapped in "
          f"complete (fields {tuple(ctx0.map_field.dist.shape)} -> "
          f"{tuple(ctx1.map_field.dist.shape)})", flush=True)
    del mgr, ctx0, ctx1, direct, direct1

    # 27. the golden chain on the card with JAX's seed and draws: unforced,
    # then teacher-forced on JAX's MCL state each tick
    ctx = build_submap_context(sc.map_pts, sc.ground_pts, sc.cfg, res=sc.res,
                               device=dev)
    recs = [tick_of(g, k) for k in range(n_ticks)]
    keys = ("odom_prev_pos", "odom_prev_quat", "odom_pos", "odom_quat",
            "flat", "flat_m", "sharp", "sharp_m")
    rec_inputs = [{k: torch.as_tensor(r[k], device=dev) for k in keys}
                  for r in recs]
    rec_ticks = [port_tick_of_one(r, dev) for r in recs]

    def replay(forced):
        gl = entry.make_global_localization(
            sc, seed_draws=port_seed_draws(g, dev), ctx=ctx, device=dev)
        return entry.run_global_localization(
            sc, gl, draws_of=lambda t: rec_ticks[t - 1][1],
            inputs_of=lambda t: rec_inputs[t - 1], keep_states=True,
            forced=(lambda t: rec_ticks[t - 1][0]) if forced else None)

    def errors(chain):
        """The worst excess of any compared output over its tolerance
        (rtol 2e-6 and atol 1e-6, the LPF states' atol 2e-5), with where
        it is, a value that is not finite counting as an infinite excess;
        particles compared row by row, a row off in any field by a finite
        amount counted as a resampling flip and left out of the excess;
        the largest |pose_pos| difference; and per tick (tick, flipped
        rows, particles) where any row flipped."""
        def excess(got, want, atol):
            return np.nan_to_num(np.abs(got - want) - 2e-6 * np.abs(want)
                                 - atol, nan=np.inf)
        worst = (-1.0, "")
        dp, flips = 0.0, []
        for k in range(len(chain.n)):
            got_p = chain.pose_pos[k][0].cpu().numpy()
            dp = max(dp, float(np.abs(got_p - g["pose_pos"][k]).max()))
            worst = max(worst, (float(excess(got_p, g["pose_pos"][k],
                                             1e-6).max()),
                                f"tick {k + 1} pose_pos"))
            worst = max(worst, (float(excess(
                chain.pose_quat[k][0].cpu().numpy(), g["pose_quat"][k],
                1e-6).max()), f"tick {k + 1} pose_quat"))
            if k + 1 >= len(recs):
                continue
            got = mcl_fields(chain.states[k])
            want = {n_: v for n_, v in recs[k + 1].items()
                    if n_.startswith("mcl_")}
            part = [n_ for n_ in want if n_.startswith("mcl_particles_")]
            rows = np.stack([excess(got[n_][0], want[n_], 1e-6).reshape(
                len(want[n_]), -1).max(axis=1) for n_ in part]).max(axis=0)
            flipped = (rows > 0) & np.isfinite(rows)
            if flipped.any():
                flips.append((k + 1, int(flipped.sum()), len(rows)))
            for n_ in part:
                e = excess(got[n_][0], want[n_], 1e-6).reshape(
                    len(rows), -1).max(axis=1)[~flipped]
                if e.size:
                    worst = max(worst, (float(e.max()), f"tick {k + 1} {n_}"))
            for n_, v in want.items():
                if n_ in part:
                    continue
                lpf = n_.startswith(("mcl_f_pos", "mcl_f_ang"))
                worst = max(worst, (float(excess(got[n_][0], v, 2e-5 if lpf
                                                 else 1e-6).max()),
                                    f"tick {k + 1} {n_}"))
        return dp, worst, flips

    def schedule_ok(chain):
        return (chain.n == [int(x) for x in g["n"]]
                and chain.fix_cnt == [int(x) for x in g["fix_cnt"]]
                and chain.fixed == [bool(x) for x in g["fixed"]])
    for forced in (False, True):
        chain = replay(forced)
        torch.cuda.synchronize()
        dp, worst, flips = errors(chain)
        tick_fixed = 1 + chain.fixed.index(True) if True in chain.fixed \
            else None
        true_pos = g["true_pos"][-1]
        err = float(np.linalg.norm(chain.pose_pos[-1][0, :2].cpu().numpy()
                                   - true_pos[:2]))
        print(f"golden global localization on the card "
              f"({'teacher-forced on JAX MCL state' if forced else 'unforced'}"
              f", JAX's draws): particle counts {chain.n[0]} -> "
              f"{chain.n[-1]} over {len(chain.n)} ticks, fixed at tick "
              f"{tick_fixed} (JAX: {n_ticks}); max |pose_pos| diff {dp!r} m; "
              f"worst excess over the tolerance {worst}; resampling flips "
              f"(tick, rows, particles) {flips}; final error {err:.3f} m")
        check(schedule_ok(chain), "particle counts, fix_cnt or the fixed "
              "tick differ from JAX's")
        if forced:
            check(worst[0] <= 0.0, f"teacher-forced replay off JAX: {worst}")
            check(all(r <= max(1, math.ceil(LOC_FLIP_SHARE * n))
                      for _, r, n in flips), f"teacher-forced replay: "
                  f"resampling flipped too many particles: {flips}")
        check(err < 1.0, f"{'teacher-forced' if forced else 'unforced'} "
              f"replay ends {err:.3f} m off")
    del chain

    # 28. closed loops on the card, each from its own torch.Generator
    from dddmr_navigation_tpu_torch.state_estimation.global_localization \
        import draw_seed
    n_ground = len(sc.ground_pts)
    cover = draw_seed(torch.Generator(device=dev).manual_seed(0),
                      LOC_COVER_DRAWS * n_ground, n_ground, sc.yaw_samples,
                      dev)
    for idx, m in ((cover.node_idx, n_ground),
                   (cover.yaw_idx, sc.yaw_samples)):
        check(torch.equal(torch.unique(idx).cpu(), torch.arange(m)),
              f"{LOC_COVER_DRAWS * n_ground} seed draws do not cover "
              f"[0, {m}) exactly")
    ground = torch.as_tensor(sc.ground_pts, device=dev)
    finals = []
    for seed in LOC_SEEDS:
        gen = torch.Generator(device=dev).manual_seed(seed)
        gl = entry.make_global_localization(sc, gen, ctx=ctx, device=dev)
        want = draw_seed(torch.Generator(device=dev).manual_seed(seed),
                         sc.num_start, n_ground, sc.yaw_samples, dev)
        check(torch.equal(gl.state.particles.pos[0],
                          ground[want.node_idx]), f"seed {seed}: the loop "
              f"did not start from its generator's draws")
        chain = entry.run_global_localization(sc, gl)
        torch.cuda.synchronize()
        pos, _ = entry.globalloc_pose(len(chain.n))
        err = float(np.linalg.norm(chain.pose_pos[-1][0, :2].cpu().numpy()
                                   - pos[:2]))
        finals.append((seed, gl.fixed, len(chain.n), err))
    print("closed-loop global localization on the card (torch.Generator "
          "seeds " + ", ".join(f"{s}: fixed {f} at tick {t}, error "
                               f"{e:.3f} m" for s, f, t, e in finals) + ")")
    check(all(f for _, f, _, _ in finals), "a closed loop never fixed")
    within = sum(e < 1.0 for _, _, _, e in finals)
    print(f"closed loops within 1.0 m of the truth when fixed: {within} of "
          f"{len(finals)}")
    check(within >= LOC_MIN_WITHIN, f"only {within} of {len(finals)} "
          f"closed loops within 1.0 m")

    # 29. preprocessing and odometry on the card against the CPU
    r0 = recs[0]
    cpu_out = feature_weights.preprocess_features(
        sc.cfg, *(torch.as_tensor(r0[k]) for k in ("flat", "flat_m", "sharp",
                                                    "sharp_m")))
    dev_out = [x.cpu() for x in feature_weights.preprocess_features(
        sc.cfg, *(rec_inputs[0][k] for k in ("flat", "flat_m", "sharp",
                                              "sharp_m")))]
    for i in (0, 1, 2, 3):
        check(torch.equal(dev_out[i], cpu_out[i]), f"preprocess_features "
              f"output {i} differs card vs CPU")
    dw = float((dev_out[4] - cpu_out[4]).abs().max())
    check(dw <= 1e-6, f"sharp weights card vs CPU off by {dw}")
    n_c = torch.as_tensor(r0["sharp"], device=dev)
    dn = float((feature_weights.knn_normals(n_c, rec_inputs[0]["sharp_m"])
                .cpu() - feature_weights.knn_normals(
                    torch.as_tensor(r0["sharp"]),
                    torch.as_tensor(r0["sharp_m"])))[r0["sharp_m"]]
               .abs().max())
    print(f"preprocess_features ({len(r0['flat'])} flat, {len(r0['sharp'])} "
          f"sharp): keep masks equal card vs CPU, weights within {dw!r}, "
          f"normals within {dn!r}")
    check(dn <= 1e-5, f"normals card vs CPU off by {dn}")
    rng = np.random.default_rng(11)
    n = LOC_ODOM_STEPS
    roll, pitch, yaw = (rng.uniform(-a, a, n).astype(np.float32)
                        for a in (0.3, 0.4, 3.1))
    from dddmr_navigation_tpu_torch.geometry import quat_from_rpy
    q = quat_from_rpy(*(torch.as_tensor(x) for x in (roll, pitch, yaw)))
    log = (torch.as_tensor(rng.uniform(-1, 2, n).astype(np.float32)), q,
           torch.as_tensor(rng.uniform(0.05, 0.15, n).astype(np.float32)))
    cpu_st, cpu_path = odom3d.integrate_log(odom3d.init_odom3d("cpu"), *log)
    dev_st, dev_path = odom3d.integrate_log(
        odom3d.init_odom3d(dev), *(x.to(dev) for x in log))
    dpath = float((dev_path.cpu() - cpu_path).abs().max())
    print(f"integrate_log of a {n}-step log: path card vs CPU within "
          f"{dpath!r} m (final {dev_st.pos.tolist()})")
    check(dpath <= 1e-5, f"odom3d path card vs CPU off by {dpath}")


def slam_phase(np, torch, dev, entry):
    """Steps 30-32: the SLAM vertical at ``SlamConfig()``'s full width."""
    import tempfile
    from dddmr_navigation_tpu_torch.interop import tick_of
    from dddmr_navigation_tpu_torch.slam.editor import GraphEditor
    from dddmr_navigation_tpu_torch.state_estimation.submaps import (
        read_pose_graph)

    g = dict(np.load(os.path.join(ROOT, "dddmr_navigation_tpu_torch",
                                  "testdata", "slam_golden.npz")))
    sc = entry.slam_scenario()
    scans = [entry.slam_scan(sc, t) for t in range(sc.scans)]
    t_rec = int(g["scan_t"])
    check(np.array_equal(scans[t_rec][0], g["scan_points"])
          and np.array_equal(scans[t_rec][1], g["scan_mask"]),
          "the regenerated scan differs from the recorded one")

    def replay(t):
        return entry.replay_mapping(sc, g, [t], dev,
                                    scans_of=lambda t: scans[t])[t]

    # 30. teacher-forced replay of every scan of the JAX run
    worst = {}

    def err(name, got, want, rel=False):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        e = float(np.abs(got - want).max())
        if rel:
            e /= max(1.0, float(np.abs(want).max()))
        worst[name] = max(worst.get(name, (0.0, -1)), (e, t))
    bad, n_front = [], 0
    for t in range(sc.scans):
        sess = replay(t)
        last, out = sess.last_scan, tick_of(g, t, prefix="out_")
        ints = ((bool(last["keyframe"]), sess.n_keyframes, sess.n_edges,
                 len(sess.loop_closures),
                 last.get("loop_candidate", (-1, False)),
                 "icp" in last, "graph" in last),
                (bool(out["keyframe"]), int(out["n_keyframes"]),
                 int(out["n_edges"]), int(out["n_loops"]),
                 (int(out["cand"]) if out["found"] else -1,
                  bool(out["found"])),
                 bool(out["has_icp"]), bool(out["has_graph"])))
        if ints[0] != ints[1]:
            bad.append((t, ints))
        if out["keyframe"]:
            k = sess.n_keyframes - 1
            same = all(np.array_equal(getattr(last["feats"], f).cpu().numpy(),
                                      g[f"kf_{f}"][k])
                       for f in last["feats"]._fields)
            if not same:
                bad.append((t, "frontend"))
            n_front += 1
        for key in ("odom", "refined"):
            if key in last and out[f"has_{key}"]:
                err(f"{key} pos", last[key][0], out[f"{key}_pos"])
                err(f"{key} quat", last[key][1], out[f"{key}_quat"])
        if "icp" in last and out["has_icp"]:
            err("icp pos", last["icp"][0].cpu(), out["icp_pos"])
            err("icp quat", last["icp"][1].cpu(), out["icp_quat"])
            err("icp fitness", last["icp"][2], out["icp_fitness"], rel=True)
        if "graph" in last and out["has_graph"]:
            err("graph pos", last["graph"].pos.cpu(), out["graph_pos"])
            err("graph quat", last["graph"].quat.cpu(), out["graph_quat"])
        err("scan pos", sess.cur_pos, out["pos"])
        err("scan quat", sess.cur_quat, out["quat"])
    torch.cuda.synchronize()
    print(f"SLAM golden replay on the card, teacher-forced at all "
          f"{sc.scans} scans: frontend "
          f"bit-equal at {n_front} keyframe scans; worst error (value, scan)"
          f" by output: {worst}; integer mismatches {bad[:5]}", flush=True)
    check(not bad, f"SLAM replay off JAX's integers or features: {bad[:5]}")
    check(n_front == int(g["out_n_keyframes"][-1]),
          f"frontend checked at {n_front} keyframe scans")
    check(all(e <= SLAM_TOL for e, _ in worst.values()),
          f"SLAM replay off JAX beyond {SLAM_TOL}: {worst}")

    # 31. the scenario closed loop, unforced
    sess = entry.make_mapping_session(sc, dev)
    chain = entry.run_mapping_chain(sess, sc, scans_of=lambda t: scans[t])
    truth, _ = entry.slam_truth(sc, sc.scans - 1)
    final = float(np.linalg.norm(chain.pos[-1][:2] - truth[:2]))
    dep = float(np.abs(chain.pos - g["out_pos"]).max())
    # JAX's loops: those of the state the last scan started from, and the
    # last scan's own
    n_loops = int(g["out_n_loops"][-1])
    jax_pairs = [(int(i), int(j)) for i, j, _ in np.asarray(tick_of(
        g, sc.scans - 1, prefix="state_")["loop_closures"])]
    if n_loops > len(jax_pairs):
        jax_pairs.append((int(g["out_cand"][-1]),
                          int(g["out_n_keyframes"][-1]) - 1))
    pairs = [(i, j) for i, j, _ in chain.loop_closures]
    jax_kf = int(g["out_n_keyframes"][-1])
    print(f"SLAM closed loop on the card, unforced ({sc.scans} scans): "
          f"{chain.keyframes[-1]} keyframes (JAX "
          f"{jax_kf}), {chain.edges[-1]} edges (JAX "
          f"{int(g['out_n_edges'][-1])}), loops {pairs} (JAX {jax_pairs}); "
          f"largest departure from JAX's poses {dep!r} m; final error "
          f"{final:.3f} m from the truth (JAX "
          f"{float(np.linalg.norm(g['out_pos'][-1][:2] - truth[:2])):.3f})",
          flush=True)
    check(final < 0.5, f"the mapping run ends {final} m from the truth")
    check(abs(chain.keyframes[-1] - jax_kf) <= SLAM_KF_SLACK,
          f"{chain.keyframes[-1]} keyframes against JAX's {jax_kf}")
    check(len(pairs) == n_loops and all(
        j == jj and abs(i - ii) <= SLAM_LOOP_SLACK
        for (i, j), (ii, jj) in zip(pairs, jax_pairs)),
        f"loop closures {pairs} against JAX's {jax_pairs}")

    # 32. the map saved, read back, localized on and edited
    with tempfile.TemporaryDirectory() as d:
        graph = sess.pose_graph()
        sess.save(d)
        back = read_pose_graph(d)
        check(np.array_equal(back.poses, graph.poses) and all(
            np.array_equal(a, b) for a, b in zip(
                back.feature_clouds + back.ground_clouds,
                graph.feature_clouds + graph.ground_clouds)),
            "the saved map did not read back equal")
        runs = np.asarray([[e for _, e, _ in run] for run in
                           entry.run_slam_localization(
                               sc, back, [torch.Generator(device=dev)
                                          .manual_seed(seed)
                                          for seed in SLAM_LOC_SEEDS],
                               device=dev)])
        med = float(np.median(runs[:, -1]))
        print(f"localization on the saved map ({len(back.poses)} keyframes;"
              f" {len(SLAM_LOC_SEEDS)} passes of {runs.shape[1]} ticks): "
              f"final errors "
              f"{np.round(runs[:, -1], 3).tolist()} m, median {med:.3f} m "
              f"(bound {SLAM_LOC_FINAL}), largest {float(runs.max()):.3f} "
              f"m; {100 * float((runs < 0.5).mean()):.1f}% of estimates "
              f"within 0.5 m", flush=True)
        check(np.isfinite(runs).all(), "a localization estimate is not "
              "finite")
        check(med <= SLAM_LOC_FINAL, f"localization on the saved map: "
              f"median final error {med} m")
        # the loop pair whose sparser corner cloud is the largest (a
        # keyframe may hold a handful of corners, or none)
        i, j = max(pairs or [(0, len(back.poses) - 1)], key=lambda p: min(
            len(back.feature_clouds[p[0]]), len(back.feature_clouds[p[1]])))
        sizes = (len(back.feature_clouds[i]), len(back.feature_clouds[j]))
        ed = GraphEditor.load(d, device=dev)
        fit = ed.add_icp_edge(i, j)
        before = ed.graph.poses.copy()
        ed.optimize()
        moved = float(np.abs(ed.graph.poses[:, :3] - before[:, :3]).max())
        d2 = os.path.join(d, "edited")
        ed.save(d2)
        again = read_pose_graph(d2)
        print(f"GraphEditor on the saved map: ICP edge {i} -> {j} "
              f"({sizes[0]} and {sizes[1]} corner points) fitness {fit!r}, "
              f"re-optimized (poses moved up to {moved:.4f} m), saved and "
              f"read back with {len(again.edges)} loop edges", flush=True)
        # a fitness of 0 would mean no pair within reach (ICP's mean over
        # no matches)
        check(0.0 < fit <= sc.cfg.history_keyframe_fitness_score,
              f"the editor's ICP edge fitness {fit}")
        check(np.isfinite(ed.graph.poses).all() and np.array_equal(
            again.poses, ed.graph.poses), "the edited map did not read back "
            "equal")


def semantic_phase(np, torch, dev, entry):
    """Steps 35-37 and 40: semantic segmentation at full width, and the
    runtime's checkpoints and traces on the card."""
    import tempfile
    from dddmr_navigation_tpu_torch.interop import semantic_params_from
    from dddmr_navigation_tpu_torch.perception import semantic as sem
    from dddmr_navigation_tpu_torch.perception.semantic_data import miou
    from dddmr_navigation_tpu_torch.runtime import trace

    g = dict(np.load(os.path.join(ROOT, "dddmr_navigation_tpu_torch",
                                  "testdata", "semantic_golden.npz")))
    # 35. the 19-class artifact against the JAX golden
    sc = entry.semantic_scenario(device=dev)
    # numpy's vectorized trigonometry may round otherwise on another host's
    # CPU: the regenerated frames may differ from the recorded ones in ulps
    sums = sc.rgb.astype(np.float64).sum(axis=(1, 2, 3))
    rgb_rel = float(np.abs(sums / g["rgb_sums"] - 1).max())
    print(f"EVAL frames regenerated with numpy {np.__version__}: checksums "
          f"{rgb_rel!r} off the recorded ones (relative)", flush=True)
    check(rgb_rel <= 1e-6, "the regenerated EVAL frames differ from the "
          f"recorded ones by {rgb_rel}")
    n_params = sum(p.numel() for p in sc.params.values())
    rgb8 = torch.as_tensor(sc.rgb, device=dev)
    with torch.no_grad():
        logits0 = sc.model(rgb8[:1])[0].cpu().numpy()
        masks = sem.infer_classes(sc.model, sc.params, rgb8).cpu().numpy()
    err = float(np.abs(logits0 - g["logits0"]).max())
    want = g["masks"].astype(np.int32)
    decided = g["gap"].astype(np.float32) > 2 * SEM_LOGITS_TOL
    flips = masks != want
    score = miou(masks, sc.labels, num_classes=19)
    floor = max(0.30, 0.8 * sc.meta["miou_heldout"] - 0.1)
    print(f"semantic golden on the card (19 classes, width 48, {n_params} "
          f"parameters, 8 EVAL frames of 240x320 at batch 8): frame 0 "
          f"logits max |err| {err!r} (tolerance {SEM_LOGITS_TOL}, range "
          f"{float(np.abs(g['logits0']).max()):.2f}); class flips "
          f"{int(flips.sum())} of {flips.size} "
          f"({100 * float(flips.mean()):.4f}%, bound "
          f"{100 * SEM_FLIP_SHARE}%), {int((flips & decided).sum())} where "
          f"JAX's top-two gap exceeds {2 * SEM_LOGITS_TOL}; mIoU {score!r} "
          f"(JAX {float(g['miou'])!r}, floor {floor:.4f})", flush=True)
    check(err <= SEM_LOGITS_TOL, f"logits off JAX's by {err}")
    check(not (flips & decided).any(), "a class flipped where JAX's top-two "
          f"gap exceeds {2 * SEM_LOGITS_TOL}")
    check(flips.mean() <= SEM_FLIP_SHARE, f"{int(flips.sum())} class flips")
    check(abs(score - float(g["miou"])) <= 0.005, f"mIoU {score} against "
          f"JAX's {float(g['miou'])}")
    check(score >= floor, f"EVAL-family mIoU {score} under {floor}")
    # the f32 parts (the logits convolution, the f32 resizes) run with TF32
    # off even where the process allows it
    x = (torch.rand((1, 96, 30, 40), device=dev) * 4).bfloat16()
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad():
            y = sc.model.Conv_0(x)
            up = sem.resize_bilinear(y, 120, 160).cpu()
            ref = torch.nn.functional.conv2d(
                x.double().cpu(), sc.model.Conv_0.weight.double().cpu())
            ref = ref + sc.model.Conv_0.bias.double().cpu()[:, None, None]
            up_cpu = sem.resize_bilinear(y.cpu(), 120, 160)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    rel = float(((y.cpu().double() - ref).abs()
                 / ref.abs().clamp_min(1.0)).max())
    print(f"f32 logits convolution with TF32 allowed in the process: max "
          f"relative error {rel!r} against f64 (TF32's 10-bit mantissa would "
          f"give ~1e-3); its f32 resize equal to the CPU's bit for bit: "
          f"{torch.equal(up, up_cpu)}", flush=True)
    check(rel <= 1e-5, f"the logits convolution ran in TF32 ({rel})")
    check(torch.equal(up, up_cpu), "the f32 resize differs from the CPU's")

    # 36. the 4-class reroute chain
    r = entry.run_semantic_reroute(dev)
    mask_flips = int((r["pred"] != g["reroute_mask"].astype(np.int32)).sum())
    bend_free = entry.reroute_bend(r["ground"], r["ids_free"])
    bend_zone = entry.reroute_bend(r["ground"], r["ids_zone"])
    print(f"reroute chain on the card: {mask_flips} mask pixels off JAX's "
          f"of {r['pred'].size}; "
          f"{int(r['in_zone'].sum())} zone points (JAX "
          f"{int(g['reroute_zone_points'])}), "
          f"{100 * float(r['in_zone'].mean()):.1f}% in the true zone; plans "
          f"ok {r['ok_free']}/{r['ok_zone']}, largest |y| in x in (2, 5): "
          f"{bend_free:.2f} m free, {bend_zone:.2f} m with the zone; free "
          f"plan equal to JAX's: "
          f"{np.array_equal(r['ids_free'], g['reroute_ids_free'])}",
          flush=True)
    check(r["ok_free"] and r["ok_zone"], "a reroute plan failed")
    check(len(r["zone"]) > 50 and r["in_zone"].mean() > 0.9,
          "the detected zone points miss the true zone")
    check(bend_free < 0.3 and bend_zone > 1.2, "the plan did not bend "
          f"around the zone ({bend_free}, {bend_zone})")
    check(mask_flips <= 1e-3 * r["pred"].size, f"{mask_flips} mask flips")
    check(np.array_equal(r["ids_free"], g["reroute_ids_free"]),
          "the straight plan differs from JAX's")

    # 37. twelve train steps on the card from JAX's initial weights
    rgb, labels = entry.semantic_train_task()
    model, _ = sem.init_segmenter(32, 32, 3, 8, device=dev)
    params = semantic_params_from(
        {k[len("train_init"):]: v for k, v in g.items()
         if k.startswith("train_init")}, dev)
    init_opt, step = sem.make_train_step(model, learning_rate=3e-3)
    state = init_opt(params)
    rgb_t, lab_t = torch.as_tensor(rgb, device=dev), torch.as_tensor(
        labels, device=dev)
    losses = []
    for _ in range(12):
        params, state, loss = step(params, state, rgb_t, lab_t)
        losses.append(float(loss))
    drift = float(np.max(np.abs(np.asarray(losses) / g["train_losses"] - 1)))
    print(f"12 train steps on the card: loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f} (JAX "
          f"{float(g['train_losses'][0]):.5f} -> "
          f"{float(g['train_losses'][-1]):.5f}), relative departure from "
          f"JAX's {abs(losses[0] / float(g['train_losses'][0]) - 1)!r} at "
          f"step 1, {drift!r} at most", flush=True)
    check(losses[-1] <= 0.9 * losses[0], f"losses {losses}")
    check(drift <= 0.02, f"train losses off JAX's by {drift}")

    # 40. the runtime: a session checkpoint round trip and a trace
    with tempfile.TemporaryDirectory() as d:
        ck = entry.session_checkpoint_round_trip(
            entry.session_scenario(), os.path.join(d, "ck"),
            ticks=SEM_CKPT_TICKS, device=dev)
        print(f"session checkpoint round trip on the card: restored step "
              f"{ck['step']}, state equal {ck['same_state']}, next tick "
              f"{ck['out_a']} (original) and {ck['out_b']} (restored)",
              flush=True)
        check(ck["step"] == SEM_CKPT_TICKS and ck["same_state"],
              "the checkpoint did not restore the session's state")
        check(ck["out_a"] == ck["out_b"], "the restored session ticks "
              "otherwise than the original")
        with trace(os.path.join(d, "trace")) as prof:
            sem.infer_classes(sc.model, None, rgb8[:1])
        files = os.listdir(os.path.join(d, "trace"))
        kernels = sum(ev.count for ev in prof.key_averages()
                      if ev.device_type == torch.autograd.DeviceType.CUDA)
        print(f"runtime.tracing.trace on the card: {files} written, "
              f"{kernels} device kernels recorded", flush=True)
        check(len(files) == 1, "the trace wrote no file")
        check(kernels > 0, "the trace recorded no device kernel")


def mark_clear_graph_phase(torch, dev, entry):
    """Step 41: the mark/clear graph against the eager step."""
    from dddmr_navigation_tpu_torch.perception.static_map import (
        build_map_context)
    for robots, pool in ((1, 1), (4, 2)):
        sc = entry.mark_clear_scenario(robots, pool, ticks=12)
        for which in ("first map", "new map"):
            ctx = build_map_context(sc.ground, sc.walls, device=dev)
            got = entry.run_mark_clear_pair(sc, ctx, dev)
            c = got["counters"]
            tag = f"mark/clear graph, {robots} robot(s), pool {pool}, {which}"
            check(got["mismatch"] == [],
                  f"{tag}: graph differs from eager at {got['mismatch']}")
            check(got["aliased"] == [],
                  f"{tag}: kept states changed after ticks {got['aliased']}")
            counts = (got["captures"], got["replays"],
                      c.get("mark_clear.graph_capture"),
                      c.get("mark_clear.graph_replay"))
            check(counts == (1, 11, 1, 11),
                  f"{tag}: captures, replays (graph, recorder) {counts}")
            seen, kept = got["eager_counts"]
            check((c.get("marked_cells"), c.get("marked_kept"))
                  == (seen, kept) and seen > 0,
                  f"{tag}: marked counters {c} against eager {seen}, {kept}")
            print(f"{tag}: 12 ticks bit-equal to eager, 1 capture, 11 "
                  f"replays, marked {seen} seen / {kept} kept", flush=True)

if __name__ == "__main__":
    main()
