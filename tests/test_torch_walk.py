"""The global planner's successor-table walk (``ops/walk.py``): the plain
version against a scalar walk written here, robot by robot, and on the
card (marked ``cuda``, skipped without one) the kernel
(``csrc/walk_table.cu``) against the plain version, bit for bit and dtype
for dtype.

The tables are built so that each case's stop is where its name says: a
robot's walk follows a chain of states whose nodes are distinct, so the
goal is met first where the case puts it. Node tables have S = G states
(``node_of`` the identity), edge tables S = G·K (``node_of`` a relabelling
of each state's source node). This file imports no JAX, so the card can
run it whole.
"""
import pytest
import torch

from dddmr_navigation_tpu_torch.ops import walk
from dddmr_navigation_tpu_torch.ops.walk import walk_table, walk_table_plain
from dddmr_navigation_tpu_torch.planning.global_ import wavefront as wf

KINDS = ("start_goal", "stuck0", "stuck_mid", "goal_mid", "goal_last",
         "cycle")
G_CASE = 600       # nodes of the constructed tables: chains of 511 states
K_CASE = 4         # out-edges a node in the edge tables


def scalar_walk(succ, stuck, e0, stuck0, node_of, start, goal, max_len):
    """The walk, one robot and one hop at a time, on Python ints."""
    succ, stuck, node_of = succ.tolist(), stuck.tolist(), node_of.tolist()
    idxs, valids, length, final = [], [], [], []
    for b in range(len(succ)):
        nodes = [int(start[b])]
        stop = 0
        if not (int(start[b]) == int(goal[b]) or bool(stuck0[b])):
            e, stop = int(e0[b]), max_len - 1
            for i in range(1, max_len):
                nodes.append(node_of[e])
                if stuck[b][e] or node_of[e] == int(goal[b]):
                    stop = i
                    break
                e = succ[b][e]
        fin = nodes[stop]
        idxs.append([nodes[i] if i <= stop else fin for i in range(max_len)])
        valids.append([i <= stop for i in range(max_len)])
        length.append(stop + 1)
        final.append(fin)
    return (torch.tensor(idxs, dtype=torch.int64),
            torch.tensor(valids, dtype=torch.bool),
            torch.tensor(length, dtype=torch.int64),
            torch.tensor(final, dtype=torch.int64))


def case_tables(kinds, max_len, table, seed=0, g=G_CASE, k=K_CASE):
    """Walk inputs for one robot per entry of ``kinds``, on CPU tensors.

    Robot b walks the chain c_0 = e0, c_1, ... of states on distinct nodes
    P[0], P[1], ... (P a permutation of the nodes, its own per robot), so
    that slot i + 1 emits P[i]; off the chain the table is random. The
    kind sets where the walk stops:
      start_goal: start == goal (slot 0);
      stuck0: the first hop impossible (slot 0);
      stuck_mid: c_m stuck, m = (max_len - 2) // 2 (slot m + 1);
      goal_mid: the goal is P[m] (slot m + 1);
      goal_last: the goal is P[max_len - 2] (slot max_len - 1);
      cycle: the chain's last few states loop, nothing terminal.
    """
    gen = torch.Generator().manual_seed(seed)
    b = len(kinds)
    n_chain = max_len - 1
    assert n_chain + 2 <= g
    if table == "node":
        s, per = g, 1
        node_of = torch.arange(g)
    else:
        s, per = g * k, k
        node_of = torch.randperm(g, generator=gen).repeat_interleave(k)
    succ = torch.randint(0, s, (b, s), generator=gen)
    stuck = torch.rand((b, s), generator=gen) < 0.02
    e0 = torch.empty(b, dtype=torch.int64)
    stuck0 = torch.zeros(b, dtype=torch.bool)
    start = torch.empty(b, dtype=torch.int64)
    goal = torch.empty(b, dtype=torch.int64)
    m = (max_len - 2) // 2
    for r, kind in enumerate(kinds):
        order = torch.randperm(g, generator=gen)
        if per == 1:
            chain = order[:n_chain]
        else:
            # a random one of the chain node's K states
            base = torch.argsort(node_of, stable=True).view(g, k)[:, 0]
            chain = (base[order[:n_chain]]
                     + torch.randint(0, k, (n_chain,), generator=gen))
        nodes = node_of[chain]
        assert torch.equal(nodes, order[:n_chain])
        succ[r, chain[:-1]] = chain[1:]
        loop_to = max(0, n_chain - 5) if kind == "cycle" else n_chain - 1
        succ[r, chain[-1]] = chain[loop_to]
        stuck[r, chain] = False
        e0[r] = chain[0]
        start[r] = order[-1]
        goal[r] = order[-2]          # on no chain state
        if kind == "start_goal":
            goal[r] = start[r]
        elif kind == "stuck0":
            stuck0[r] = True
            goal[r] = order[min(1, n_chain - 1)]
        elif kind == "stuck_mid":
            stuck[r, chain[m]] = True
        elif kind == "goal_mid":
            goal[r] = order[m]
        elif kind == "goal_last":
            goal[r] = order[n_chain - 1]
    return succ, stuck, e0, stuck0, node_of, start, goal


def expected_length(kind, max_len):
    m = (max_len - 2) // 2
    return {"start_goal": 1, "stuck0": 1, "stuck_mid": m + 2,
            "goal_mid": m + 2, "goal_last": max_len,
            "cycle": max_len}[kind]


def assert_same(got, want):
    for name, a, w in zip(("idxs", "valids", "length", "final"), got, want):
        assert a.dtype == w.dtype, (name, a.dtype, w.dtype)
        assert a.shape == w.shape, (name, a.shape, w.shape)
        assert torch.equal(a.cpu(), w.cpu()), name


# ---------------------------------------------------------------------------
# the plain version against the scalar walk (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("table", ["node", "edge"])
@pytest.mark.parametrize("max_len", [2, 3, 512])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_walk_one_robot(kind, max_len, table):
    args = case_tables([kind], max_len, table, seed=max_len)
    got = walk_table_plain(*args, max_len)
    assert_same(got, scalar_walk(*args, max_len))
    assert int(got[2][0]) == expected_length(kind, max_len)


@pytest.mark.parametrize("table", ["node", "edge"])
@pytest.mark.parametrize("max_len", [2, 3, 512])
def test_plain_walk_64_robots(max_len, table):
    kinds = [KINDS[i % len(KINDS)] for i in range(64)]
    args = case_tables(kinds, max_len, table, seed=7 + max_len)
    got = walk_table_plain(*args, max_len)
    assert_same(got, scalar_walk(*args, max_len))
    assert got[2].tolist() == [expected_length(kd, max_len) for kd in kinds]
    reached = got[3] == args[6]
    assert bool(reached.any()) and not bool(reached.all())


def test_walk_table_takes_plain_on_cpu_and_raises_elsewhere():
    args = case_tables(list(KINDS), 64, "edge")
    before = walk_table.launches
    assert_same(walk_table(*args, 64), walk_table_plain(*args, 64))
    assert wf.walk_table is walk_table
    assert walk_table.launches == before
    with pytest.raises(ValueError):
        walk_table(*(a.to("meta") for a in args), 64)


def grid_graph(n=12):
    """An n × n grid, 8-connected, with -1 padding at the border."""
    ij = [(i, j) for i in range(n) for j in range(n)]
    moves = [(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)
             if (di, dj) != (0, 0)]
    idx = torch.full((n * n, len(moves)), -1, dtype=torch.int64)
    for u, (i, j) in enumerate(ij):
        for c, (di, dj) in enumerate(moves):
            if 0 <= i + di < n and 0 <= j + dj < n:
                idx[u, c] = (i + di) * n + j + dj
    pos = torch.tensor([[0.5 * i, 0.5 * j, 0.0] for i, j in ij])
    safe = idx.clamp(min=0)
    dist = torch.where(idx >= 0, (pos[safe] - pos[:, None]).norm(dim=-1),
                       0.0)
    return idx, dist, idx >= 0, pos


def turning_extraction_inputs(device="cpu", n=12):
    """A relaxed turning field over a grid with a blocked strip, for two
    robots (one with the goal walled off)."""
    idx, dist, valid, pos = grid_graph(n)
    g = n * n
    enter = torch.zeros(2, g)
    wall = torch.tensor([i * n + n // 2 for i in range(n - 2)])
    enter[:, wall] = torch.inf
    enter[1, [i * n + n // 2 for i in range(n)]] = torch.inf
    nbr_valid = valid[None].expand(2, g, -1).clone()
    start = torch.tensor([0, 2 * n + 1])
    goal = torch.tensor([g - 1, g - 3])
    tw = 0.1
    field, bins, _ = wf.wavefront_distances_turning(
        idx, dist, nbr_valid, enter, torch.zeros(g), goal, pos, tw,
        n_dir_bins=8, max_iters=256)
    # the turning table from the CPU, so that both devices score alike
    turn_pen = wf.turning_penalty_table(idx, pos, tw)
    args = (idx, dist, nbr_valid, enter, field, bins, start, goal, pos)
    return tuple(a.to(device) for a in args), tw, turn_pen.to(device)


def test_turning_extraction_walk_matches_scalar():
    """The extraction's own tables: the path reaches the goal where one
    exists and stops where it does not, and its walk is the scalar one."""
    args, tw, turn_pen = turning_extraction_inputs()
    seen = []
    real = wf.walk_table

    def spy(*args):
        seen.append(args)
        return real(*args)
    wf.walk_table = spy
    try:
        ids, valid, length, ok = wf.extract_path_turning(
            *args, tw, max_len=64, turn_pen=turn_pen)
    finally:
        wf.walk_table = real
    goal = args[7]
    assert ok.tolist() == [True, False]
    assert int(ids[0, int(length[0]) - 1]) == int(goal[0])
    (walked,) = seen
    assert_same(walk_table_plain(*walked), scalar_walk(*walked))


# ---------------------------------------------------------------------------
# the kernel against the plain version (card only)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def kernel_vs_plain(args, max_len, device):
    dev_args = [a.to(device) for a in args]
    before = walk_table.launches
    got = walk_table(*dev_args, max_len)
    torch.cuda.synchronize()
    assert walk_table.launches == before + 1
    assert all(t.is_cuda for t in got)
    want = walk_table_plain(*args, max_len)
    assert_same(got, want)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["node", "edge"])
@pytest.mark.parametrize("max_len", [2, 3, 512])
@pytest.mark.parametrize("b", [1, 64])
def test_kernel_matches_plain_on_cases(cuda_device, b, max_len, table):
    kinds = [KINDS[i % len(KINDS)] for i in range(max(b, len(KINDS)))][:b]
    if b == 1:
        for kind in KINDS:
            kernel_vs_plain(case_tables([kind], max_len, table,
                                        seed=max_len), max_len, cuda_device)
    else:
        kernel_vs_plain(case_tables(kinds, max_len, table, seed=b + max_len),
                        max_len, cuda_device)


# (B, G, K) of the cells' extractions: robot8k, session1, fleet64
CELL_SHAPES = [(1, 3116, 12), (1, 2614, 16), (64, 1617, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,g,k", CELL_SHAPES)
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_kernel_matches_plain_on_random_tables(cuda_device, b, g, k, seed):
    gen = torch.Generator().manual_seed(seed)
    s = g * k
    succ = torch.randint(0, s, (b, s), generator=gen)
    stuck = torch.rand((b, s), generator=gen) < 1.0 / 400
    e0 = torch.randint(0, s, (b,), generator=gen)
    stuck0 = torch.rand(b, generator=gen) < 0.1
    node_of = torch.randint(0, g, (s,), generator=gen)
    start = torch.randint(0, g, (b,), generator=gen)
    goal = torch.randint(0, g, (b,), generator=gen)
    goal[::7] = start[::7]
    args = (succ, stuck, e0, stuck0, node_of, start, goal)
    for max_len in (2, 512):
        kernel_vs_plain(args, max_len, cuda_device)
    # node tables at the same shapes
    succ_n = torch.randint(0, g, (b, g), generator=gen)
    stuck_n = torch.rand((b, g), generator=gen) < 1.0 / 400
    e0_n = torch.randint(0, g, (b,), generator=gen)
    kernel_vs_plain((succ_n, stuck_n, e0_n, stuck0, torch.arange(g), start,
                     goal), 512, cuda_device)


@pytest.mark.cuda
def test_kernel_matches_plain_at_its_longest_walk(cuda_device):
    """``MAX_LEN`` slots: the nodes of a whole walk fill the shared memory
    the kernel asks for."""
    n = walk.MAX_LEN
    kernel_vs_plain(case_tables(list(KINDS), n, "node", g=n + 8), n,
                    cuda_device)


@pytest.mark.cuda
def test_turning_extraction_on_card_equals_cpu(cuda_device):
    cpu_args, tw, cpu_pen = turning_extraction_inputs()
    dev_args, _, dev_pen = turning_extraction_inputs(cuda_device)
    want = wf.extract_path_turning(*cpu_args, tw, max_len=64,
                                   turn_pen=cpu_pen)
    before = walk_table.launches
    got = wf.extract_path_turning(*dev_args, tw, max_len=64,
                                  turn_pen=dev_pen)
    torch.cuda.synchronize()
    assert walk_table.launches == before + 1
    assert_same(got, want)


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda_device):
    args = [a.to(cuda_device) for a in case_tables(list(KINDS), 64, "edge")]
    bad_dtype = list(args)
    bad_dtype[0] = args[0].int()
    with pytest.raises(TypeError):
        walk_table(*bad_dtype, 64)
    bad_shape = list(args)
    bad_shape[4] = args[4][:-1]
    with pytest.raises(ValueError):
        walk_table(*bad_shape, 64)
    bad_device = list(args)
    bad_device[4] = args[4].cpu()
    with pytest.raises(ValueError):
        walk_table(*bad_device, 64)
    with pytest.raises(ValueError):
        walk_table(*args, 1)
    with pytest.raises(ValueError):
        walk_table(*args, walk.MAX_LEN + 1)
