"""Kernel S's lane layout, held on the CPU without a card (no JAX).

``build_paths`` packs each class's paths into warp groups of at most 32
lanes: every path that fits is in exactly one group of its own class, on
e + 1 consecutive lanes (the root dummy first), and every longer path is
on the long-path list and in no group; each element's edges (the CSR a
lane decides from) are its path's edges of that slot, in depth order.
A float64 torch emulation of one warp group — ``extend_path`` with the
path weights shifted up one lane and the fractions broadcast from lane d,
then each lane's own ``unwound_path_sum`` with pw[j] broadcast — gives
``_chunk_contrib``'s per-element contributions bit for bit
(``torch.equal``): the kernel's arithmetic, operation for operation, is
the plain version's. ``launch_plan`` keeps a pass's workspace in its
byte budget, the shared memory in the card's, and the reduction's chunk
count equal to the grid's, and what orders a row's sums (warps, chunks)
does not depend on the batch.
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

from lambdagap_tpu_torch.models import shap, synth
from lambdagap_tpu_torch.models.tree import Tree


def _chain_tree(seed=0, chain=40, leaves=96, features=48):
    """A tree whose leftmost path splits ``chain`` distinct features in a
    row (a merged path of ``chain`` + 1 elements, too long for a warp),
    then random splits."""
    rng = np.random.RandomState(seed)
    tree = Tree(max_leaves=leaves)
    for f in range(chain):
        tree.split(0, f, f, 0, float(rng.randn()), bool(f % 2), f % 3, 1.0,
                   float(rng.normal(0, 0.02)), float(rng.normal(0, 0.02)),
                   2.0, 1.0, 2, 1)
    while tree.num_leaves < leaves:
        f = int(rng.randint(features))
        tree.split(int(rng.randint(tree.num_leaves)), f, f, 0,
                   float(rng.randn()), bool(rng.rand() < 0.5),
                   int(rng.randint(3)), 1.0, float(rng.normal(0, 0.02)),
                   float(rng.normal(0, 0.02)), 2.0, 1.0, 2, 1)
    return tree


def _case(kind):
    """(trees, tree classes, classes, rows float64)."""
    rng = np.random.RandomState(4)
    if kind == "numeric":
        trees, feats = synth.random_trees(3, 12, 31, 10, grid_size=40), 10
        return trees, [0] * 12, 1, synth.random_rows(rng, 40, feats) \
            .astype(np.float64)
    if kind == "categorical":
        trees = synth.categorical_trees(4, num_trees=8, num_features=6)
        return trees, [0] * 8, 1, synth.hostile_rows(rng, 40, 6) \
            .astype(np.float64)
    if kind == "multiclass":
        trees = synth.random_trees(6, 15, 31, 10, grid_size=40)
        return trees, [i % 3 for i in range(15)], 3, \
            synth.random_rows(rng, 40, 10).astype(np.float64)
    trees = [_chain_tree()] + synth.random_trees(7, 4, 63, 48, grid_size=30)
    return trees, [0, 1, 0, 1, 1], 2, \
        synth.random_rows(rng, 40, 48).astype(np.float64)


@pytest.mark.parametrize("kind", ["numeric", "categorical", "multiclass",
                                  "long"])
def test_packing_covers_every_path_once(kind):
    trees, tc, K, _ = _case(kind)
    p = shap.build_paths(trees, tc, K)
    P = len(p.path_value)
    lanes = np.diff(p.path_elem_lo) + 1
    G = p.class_groups[-1]
    assert np.array_equal(p.class_group_lo, p.class_groups)
    assert p.lane_path.shape == (G * shap.WARP,)
    lp = p.lane_path.reshape(G, shap.WARP)
    ls = p.lane_slot.reshape(G, shap.WARP)
    heads = lp[ls == 0]
    # each fitting path heads exactly one group; long ones none
    assert np.array_equal(np.sort(heads), np.nonzero(lanes <= 32)[0])
    assert np.array_equal(p.long_path, np.nonzero(lanes > 32)[0])
    assert p.num_long == len(p.long_path)
    if kind == "long":
        assert p.num_long >= 1 and p.max_elems > 33
    else:
        assert p.num_long == 0
    cls = np.searchsorted(p.class_path_lo, np.arange(P), side="right") - 1
    assert np.array_equal(
        p.class_long_lo, np.searchsorted(p.long_path, p.class_path_lo))
    for g in range(G):
        used = lp[g] >= 0
        # a path's lanes are consecutive, slots 0..e, and nothing is split
        for lane in np.nonzero(ls[g] == 0)[0]:
            path = lp[g, lane]
            span = slice(lane, lane + lanes[path])
            assert (lp[g, span] == path).all()
            assert np.array_equal(ls[g, span], np.arange(lanes[path]))
        assert used.sum() == lanes[np.unique(lp[g][used])].sum()
        # one class a group, and the class's own range of groups
        k = np.unique(cls[lp[g][used]])
        assert len(k) == 1
        assert p.class_groups[k[0]] <= g < p.class_groups[k[0] + 1]
    assert (ls[lp < 0] == -1).all()


@pytest.mark.parametrize("kind", ["numeric", "categorical", "long"])
def test_element_edges_are_the_paths_edges_by_slot(kind):
    trees, tc, K, _ = _case(kind)
    p = shap.build_paths(trees, tc, K)
    for path in range(len(p.path_value)):
        elo, ehi = p.path_elem_lo[path], p.path_elem_lo[path + 1]
        dlo, dhi = p.path_edge_lo[path], p.path_edge_lo[path + 1]
        codes = p.edge_slot[dlo:dhi]
        for slot in range(1, ehi - elo + 1):
            el = elo + slot - 1
            mine = p.elem_edge[p.elem_edge_lo[el]:p.elem_edge_lo[el + 1]]
            want = (p.edge_node[dlo:dhi] << 1 | codes & 1)[codes >> 1 == slot]
            assert np.array_equal(mine, want)


def _emulate_group(x, p, g):
    """One warp group of the grouped kernel, lane for lane, as float64 torch
    ops in the kernel's order: per-element contributions [R, 32] and the
    lanes' (path, slot)."""
    W = shap.WARP
    lane = torch.arange(W)
    path = p.lane_path[g * W:(g + 1) * W].long()
    slot = p.lane_slot[g * W:(g + 1) * W].long()
    live = path >= 0
    pc = path.clamp(min=0)
    elo = p.path_elem_lo[pc].long()
    e = torch.where(live, p.path_elem_lo[pc + 1].long() - elo, 0)
    base = torch.where(live, lane - slot, lane)
    elem = live & (slot > 0)
    el = (elo + slot - 1).clamp(min=0)
    zero = torch.where(elem, p.elem_zero[el], 1.0)
    v = torch.where(live, p.path_value[pc], 0.0)
    R = x.shape[0]
    # each lane decides its own element's edges
    one = torch.ones((R, W), dtype=torch.float64)
    for i in torch.nonzero(elem).flatten().tolist():
        lo, hi = int(p.elem_edge_lo[el[i]]), int(p.elem_edge_lo[el[i] + 1])
        for code in p.elem_edge[lo:hi].tolist():
            bad = _decide_node(x, code >> 1, p) != bool(code & 1)
            one[:, i] = torch.where(bad, 0.0, one[:, i])
    steps = int(e.max())
    # extend_path: lane i holds pw[i]; shfl_up brings pw[i - 1]
    pw = torch.ones((R, W), dtype=torch.float64)
    for d in range(1, steps + 1):
        src = (base + d).clamp(max=W - 1)
        zd, od = zero[src], one[:, src]
        prev = torch.cat([pw[:, :1], pw[:, :-1]], 1)
        den = torch.full((1,), d + 1.0, dtype=torch.float64)
        sd = slot.double()
        a = zd * pw * (d - sd) / den
        b = od * prev * sd / den
        new = torch.where(slot == 0, a, torch.where(slot < d, a, 0.0) + b)
        pw = torch.where(live & (d <= e) & (slot <= d), new, pw)
    # each lane's unwound_path_sum, pw[j] broadcast from lane base + j
    nop = pw[:, (base + e).clamp(max=W - 1)]
    total = torch.zeros((R, W), dtype=torch.float64)
    e1 = (e + 1).double()
    nz = one != 0
    for j in range(steps - 1, -1, -1):
        pwj = pw[:, (base + j).clamp(max=W - 1)]
        act = elem & (j < e)
        ej = (e - j).double()
        tmp = nop * e1 / ((j + 1) * one)
        nop_next = pwj - tmp * zero * ej / e1
        alt = pwj / (zero * ej / e1)
        total = torch.where(act, torch.where(nz, total + tmp, total + alt),
                            total)
        nop = torch.where(act & nz, nop_next, nop)
    contrib = total * (one - zero) * v
    return contrib, path, slot


def _decide_node(x, node, p):
    return shap._decide(x, torch.tensor([node]), p)[:, 0]


@pytest.mark.parametrize("kind", ["numeric", "categorical", "multiclass"])
def test_lane_parallel_arithmetic_equals_plain_bit_for_bit(kind):
    trees, tc, K, X = _case(kind)
    p = shap.to_device(shap.build_paths(trees, tc, K), torch.device("cpu"))
    x = torch.from_numpy(X)
    R = x.shape[0]
    checked = 0
    for g in range(p.class_groups[-1]):
        got, path, slot = _emulate_group(x, p, g)
        heads = path[slot == 0]
        want, _ = shap._chunk_contrib(x, p, heads)
        m = want.shape[1] // len(heads)
        want = want.view(R, len(heads), m)
        for q, h in enumerate(heads.tolist()):
            lanes = (path == h) & (slot > 0)
            assert torch.equal(got[:, lanes], want[:, q, slot[lanes]])
            checked += int(lanes.sum())
    assert checked == len(p.elem_zero)


def test_packing_fills_warps_on_a_wide_forest():
    """255-leaf trees at HIGGS width (28 features): paths of up to ~20
    merged elements pack at least 90% of the groups' lanes."""
    trees = synth.random_trees(0, 20, 255, 28)
    p = shap.build_paths(trees, [0] * 20, 1)
    assert p.num_long == 0
    assert (p.lane_path >= 0).mean() > 0.9


@pytest.mark.parametrize("rows", [1, 256, 4096, 1 << 20])
@pytest.mark.parametrize("width", [28, 136, 6000])
def test_launch_plan_stays_in_its_budgets(rows, width):
    trees, tc, K, _ = _case("long")
    p = shap.build_paths(trees, tc, K)
    plan = shap.launch_plan(p, rows, width)
    counts = np.diff(p.class_groups)
    assert plan["chunks"] == int(
        (-(-counts // plan["groups_per_chunk"])).sum())
    assert plan["chunks"] <= shap.MAX_CHUNKS + K
    one = shap.launch_plan(p, 1, width)
    for key in ("warps", "staged", "chunks", "groups_per_chunk"):
        assert plan[key] == one[key]
    slices = plan["chunks"] + K            # the long paths' slices
    assert plan["passes"] * plan["pass_rows"] >= rows
    assert (plan["passes"] - 1) * plan["pass_rows"] < rows
    assert plan["workspace"] == slices * plan["pass_rows"] * width
    assert (plan["workspace"] * 8 <= shap.SCRATCH_BYTES
            or plan["pass_rows"] == 1)
    assert plan["smem_bytes"] <= shap.SMEM_MAX
    assert plan["tile"] <= min(plan["pass_rows"], shap.TILE_ROWS)
    assert plan["staged"] == (width != 6000)
    if not plan["staged"]:
        assert plan["warps"] == plan["tile"] == 1
    assert plan["long_cap"] == 64
    assert plan["cuda_launches"] == 3 * plan["passes"]
    assert (plan["scratch"] * 8 <= shap.SCRATCH_BYTES
            or plan["long_blocks"] == 1)


def test_a_path_longer_than_256_elements_is_refused_by_name():
    tree = _chain_tree(chain=257, leaves=258, features=300)
    p = shap.build_paths([tree], [0], 1)
    assert p.max_elems == 258
    with pytest.raises(ValueError, match="at most 256"):
        shap.launch_plan(p, 4, 300)
