"""The port's GPU domain model (nos_tpu_torch.gpu) against nos_tpu.tpu.

Exact, for this integer logic: the geometry operations against
nos_tpu.tpu.geometry on hypothesis-drawn dicts; MigGpu against TpuBoard
and SharedGpu against SharedChip on seeded random sequences, each side
fed the same allowed-geometry table through its own override hook with
profile names mapped one to one (a MIG profile's memory slices equal
its topology's chips, which both searches weigh by); and the H100 table
itself: every allowed geometry packs into the placement grid, the list
is ordered fewest slices first, and it holds the MIG User Guide's
combinations.
"""
import random

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from nos_tpu.tpu import geometry as jg
from nos_tpu.tpu import known as jknown
from nos_tpu.tpu.board import TpuBoard
from nos_tpu.tpu.sharing import SharedChip
from nos_tpu.tpu.topology import enumerate_tilings
from nos_tpu_torch.gpu import geometry as tg
from nos_tpu_torch.gpu import known as tknown
from nos_tpu_torch.gpu.mig import MigGpu
from nos_tpu_torch.gpu.slicing import SharedGpu

V5E = "tpu-v5-lite-podslice"
H100 = tknown.H100_80GB
# topology -> MIG profile with as many memory slices as the topology has chips
TO_MIG = {"1x1": "1g.10gb", "1x2": "2g.20gb", "2x2": "4g.40gb", "2x4": "7g.80gb"}
TO_TPU = {v: k for k, v in TO_MIG.items()}


def to_mig(g):
    return {TO_MIG[p]: n for p, n in g.items()}


@pytest.fixture
def same_tables():
    """v5e's own tilings of its 2x4 board on the TPU side, their MIG
    translation on the GPU side, each through its override hook."""
    tilings = [dict(g) for g in enumerate_tilings("2x4", ("1x1", "1x2", "2x2", "2x4"))]
    jknown.set_known_geometries({V5E: tilings})
    tknown.set_known_geometries({H100: [to_mig(g) for g in tilings]})
    try:
        yield tilings
    finally:
        jknown.set_known_geometries(None)
        tknown.set_known_geometries(None)


# ------------------------------------------------------------- geometry

PROFILES = st.sampled_from(["1g.10gb", "1g.20gb", "2g.20gb", "3g.40gb", "4g.40gb",
                            "7g.80gb", "20gb", "26gb"])
GEOMETRIES = st.dictionaries(PROFILES, st.integers(-3, 7), max_size=6)


@settings(max_examples=200, deadline=None)
@given(GEOMETRIES, GEOMETRIES)
def test_geometry_operations_match_the_reference(a, b):
    assert tg.geometry_add(a, b) == jg.geometry_add(a, b)
    assert tg.geometry_subtract(a, b) == jg.geometry_subtract(a, b)
    assert tg.geometry_fits(a, b) == jg.geometry_fits(a, b)


@settings(max_examples=200, deadline=None)
@given(st.dictionaries(st.sampled_from(sorted(TO_TPU)), st.integers(0, 7), max_size=4))
def test_memory_slices_count_as_the_reference_counts_chips(g):
    memory, _ = tg.geometry_slices(g)
    assert memory == jg.geometry_chips({TO_TPU[p]: n for p, n in g.items()})


def test_geometry_slices_count_memory_and_compute():
    # 1g.20gb and 2g.20gb take the same memory slices, not the same compute
    assert tg.geometry_slices({"1g.20gb": 4}) == (8, 4)
    assert tg.geometry_slices({"2g.20gb": 3, "1g.10gb": 1}) == (7, 7)
    assert tg.geometry_slices({"3g.40gb": 1, "4g.40gb": 1}) == (8, 7)
    with pytest.raises(ValueError):
        tg.geometry_slices({"1g.10gb+me": 1})


# ------------------------------------------------------------ H100 table


def _packs(g, spec):
    """A placement of every instance of ``g`` on disjoint memory slices at
    allowed starts, or None."""
    items = sorted((tknown.mig_profile(p) for p, n in g.items() for _ in range(n)),
                   key=lambda p: -p.memory_slices)

    def place(i, taken):
        if i == len(items):
            return []
        p = items[i]
        for s in p.starts:
            cells = set(range(s, s + p.memory_slices))
            if s + p.memory_slices <= spec.memory_slices and not cells & taken:
                rest = place(i + 1, taken | cells)
                if rest is not None:
                    return [(p.name, s)] + rest
        return None

    return place(0, set())


def test_every_allowed_geometry_packs_into_the_placement_grid():
    spec = tknown.KNOWN_GPUS[H100]
    geometries = tknown.allowed_geometries(H100)
    assert geometries
    for g in geometries:
        memory, compute = tg.geometry_slices(g)
        assert memory <= spec.memory_slices and compute <= spec.compute_slices, g
        assert all(n <= tknown.mig_profile(p).max_instances for p, n in g.items()), g
        assert _packs(g, spec) is not None, g
        # maximal: no profile can be added to it
        for p in spec.profiles:
            bigger = tg.geometry_add(g, {p.name: 1})
            m, c = tg.geometry_slices(bigger)
            assert (m > spec.memory_slices or c > spec.compute_slices
                    or bigger[p.name] > p.max_instances or _packs(bigger, spec) is None), (g, p)


def test_allowed_geometries_are_ordered_fewest_slices_first():
    geometries = tknown.allowed_geometries(H100)
    keys = [(sum(g.values()), sorted(g.items())) for g in geometries]
    assert keys == sorted(keys)
    assert len({tuple(k[1]) for k in keys}) == len(keys)
    assert geometries[0] == {"7g.80gb": 1}


@pytest.mark.parametrize("combination", [
    {"7g.80gb": 1},
    {"4g.40gb": 1, "3g.40gb": 1},
    {"3g.40gb": 2},
    {"1g.10gb": 7},
    {"1g.20gb": 4},
    {"2g.20gb": 3, "1g.10gb": 1},
    {"4g.40gb": 1, "2g.20gb": 1, "1g.10gb": 1},
    {"4g.40gb": 1, "1g.10gb": 3},
    {"3g.40gb": 1, "1g.10gb": 4},
])
def test_allowed_geometries_hold_the_guides_combinations(combination):
    assert combination in tknown.allowed_geometries(H100)


def test_placements_too_big_or_past_the_limit_are_not_geometries():
    geometries = tknown.allowed_geometries(H100)
    for g in ({"2g.20gb": 4}, {"4g.40gb": 2}, {"1g.10gb": 8}, {"3g.40gb": 1, "4g.40gb": 2},
              {"1g.20gb": 5}, {"7g.80gb": 1, "1g.10gb": 1}):
        assert g not in geometries
    # a geometry that could still take an instance is not one of its own
    assert {"4g.40gb": 1} not in geometries
    assert {"3g.40gb": 1, "1g.10gb": 3} not in geometries


def test_table_lookups():
    assert tknown.allowed_geometries("NVIDIA-A100-SXM4-40GB") == []
    assert tknown.profile_for_gb(10, H100) == "1g.10gb"
    assert tknown.profile_for_gb(15, H100) == "1g.20gb"  # fewest compute slices
    assert tknown.profile_for_gb(40, H100) == "3g.40gb"
    assert tknown.profile_for_gb(41, H100) == "7g.80gb"
    assert tknown.profile_for_gb(81, H100) is None
    assert tknown.memory_gb_per_gpu(H100) == 80
    assert tknown.memory_gb_per_gpu("unknown") == 0
    assert "1g.10gb+me" not in tknown.MIG_PROFILES


def test_override_hook_replaces_and_clears():
    tknown.set_known_geometries({H100: [{"7g.80gb": 1}]})
    try:
        assert tknown.allowed_geometries(H100) == [{"7g.80gb": 1}]
    finally:
        tknown.set_known_geometries(None)
    assert len(tknown.allowed_geometries(H100)) > 1


# ------------------------------------------------------- MigGpu / TpuBoard


def _random_geometry(rng, profiles, most=3):
    return {p: rng.randint(1, most) for p in rng.sample(profiles, rng.randint(0, 2))}


@pytest.mark.parametrize("seed", range(8))
def test_mig_gpu_matches_tpu_board(same_tables, seed):
    rng = random.Random(seed)
    tilings = same_tables
    for _ in range(60):
        # used: a sub-multiset of one tiling; free: some of the rest
        base = dict(rng.choice(tilings))
        used = {p: rng.randint(0, n) for p, n in base.items()}
        used = {p: n for p, n in used.items() if n}
        rest = jg.geometry_subtract(base, used)
        free = {p: rng.randint(0, n) for p, n in rest.items() if n > 0}
        free = {p: n for p, n in free.items() if n}
        lacking = _random_geometry(rng, sorted(TO_MIG))
        board = TpuBoard(0, V5E, used=used, free=free)
        gpu = MigGpu(0, H100, used=to_mig(used), free=to_mig(free))
        assert gpu.update_geometry_for(to_mig(lacking)) == board.update_geometry_for(lacking)
        assert gpu.free == to_mig(board.free) and gpu.used == to_mig(board.used)
        profile = rng.choice(sorted(TO_MIG))
        qty = rng.randint(1, 2)
        assert gpu.allocate(TO_MIG[profile], qty) == board.allocate(profile, qty)
        assert gpu.free == to_mig(board.free) and gpu.used == to_mig(board.used)


def test_mig_gpu_init_matches_tpu_board(same_tables):
    board, gpu = TpuBoard(0, V5E), MigGpu(0, H100)
    assert gpu.init_geometry() == board.init_geometry()
    assert gpu.free == to_mig(board.free)
    assert gpu.init_geometry() == board.init_geometry() is False


def test_mig_gpu_on_the_h100_table():
    gpu = MigGpu(0, H100)
    assert gpu.init_geometry() and gpu.free == {"7g.80gb": 1}
    # three 2g.20gb lacking: re-carved, the fewest-slices geometry among best
    assert gpu.update_geometry_for({"2g.20gb": 3})
    assert gpu.free.get("2g.20gb") == 3
    assert gpu.allocate("2g.20gb", 2)
    # a used instance is never destroyed
    assert gpu.update_geometry_for({"1g.10gb": 7})
    assert gpu.used == {"2g.20gb": 2}
    assert tg.geometry_fits(gpu.geometry, {"2g.20gb": 2})
    assert gpu.geometry in tknown.allowed_geometries(H100)
    with pytest.raises(ValueError):
        MigGpu(0, "NVIDIA-A100-SXM4-40GB")


# ----------------------------------------------------- SharedGpu / SharedChip


@pytest.mark.parametrize("seed", range(8))
def test_shared_gpu_matches_shared_chip(seed):
    rng = random.Random(100 + seed)
    profiles = ["5gb", "10gb", "11gb", "20gb", "26gb", "40gb", "80gb"]
    chip, gpu = SharedChip(0, 80), SharedGpu(0, 80)
    for _ in range(80):
        if rng.random() < 0.6:
            required = {p: rng.randint(1, 4) for p in rng.sample(profiles, rng.randint(1, 3))}
            assert gpu.update_geometry_for(required) == chip.update_geometry_for(required)
        else:
            profile = rng.choice(profiles)
            assert gpu.allocate(profile) == chip.allocate(profile)
        assert (gpu.free, gpu.used) == (chip.free, chip.used)
        assert gpu.spare_memory_gb() == chip.spare_memory_gb()
        if rng.random() < 0.1:  # processes leave
            chip.used, gpu.used = {}, {}


def test_shared_gpu_carves_equal_slices():
    gpu = SharedGpu(0, 80)
    assert gpu.update_geometry_for({"26gb": 3}) and gpu.free == {"26gb": 3}
    assert gpu.spare_memory_gb() == 2
    with pytest.raises(ValueError):
        SharedGpu(0, 80).update_geometry_for({"1g.10gb": 1})
