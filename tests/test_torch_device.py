"""The port's device layer (nos_tpu_torch.device) against nos_tpu.device
and nos_tpu.controllers.tpuagent.plan.

Exact, for this integer logic: compute_plan against the reference's on
translated devices (a MigDevice's uuid, GPU index and profile for a
TpuSliceDevice's id, board and profile); the sim pool's create, delete
and geometry sequences against SimDevicePool's (the reference's pool
takes any profile string, so both sides see the same MIG names; the
port's also enforces the H100 placement table, and a create it refuses
leaves it unchanged and is left out on both sides); group_geometries;
the search over creation orders; GpuClient's status resolution; NVML's
struct layouts against nvml.h's sizes, and a missing library raising.
NVML's client also runs over a fake library with nvml.h's semantics (MIG
mode on, which the card's machine does not allow): the same creates
land on the same placements as the sim's, an out-of-resources refusal
gives way to the next order, and destroys leave nothing.
"""
import ctypes
import itertools
import random

import pytest

from nos_tpu.controllers.tpuagent import plan as jplan
from nos_tpu.device import types as jtypes
from nos_tpu.device.sim import SimDevicePool
from nos_tpu_torch.device import client as tclient
from nos_tpu_torch.device import nvml
from nos_tpu_torch.device.plan import compute_plan
from nos_tpu_torch.device.sim import SimMigClient, SimMigPool
from nos_tpu_torch.device.types import DeviceStatus, MigDevice, group_geometries
from nos_tpu_torch.gpu.known import MIG_PROFILES, mig_profile

PROFILES = ["1g.10gb", "1g.20gb", "2g.20gb", "3g.40gb", "4g.40gb", "7g.80gb"]


def _mig(d: jtypes.TpuSliceDevice) -> MigDevice:
    return MigDevice(d.device_id, d.board_index, d.profile, 0, 1, d.status)


# ------------------------------------------------------------------- plan


@pytest.mark.parametrize("seed", range(8))
def test_compute_plan_matches_the_reference(seed):
    rng = random.Random(seed)
    for _ in range(40):
        devices = [
            jtypes.TpuSliceDevice(f"MIG-{i:03d}", rng.randint(0, 2), rng.choice(PROFILES),
                                  rng.choice([DeviceStatus.FREE, DeviceStatus.USED]))
            for i in rng.sample(range(100), rng.randint(0, 10))
        ]
        spec = {g: {p: rng.randint(1, 3) for p in rng.sample(PROFILES, rng.randint(0, 3))}
                for g in rng.sample(range(3), rng.randint(0, 3))}
        want = jplan.compute_plan(devices, spec)
        got = compute_plan([_mig(d) for d in devices], spec)
        assert [d.uuid for d in got.deletes] == [d.device_id for d in want.deletes]
        assert [(c.gpu_index, c.profile, c.quantity) for c in got.creates] == [
            (c.board_index, c.profile, c.quantity) for c in want.creates]
        assert got.empty == want.empty
        # a used device is never deleted
        assert all(d.status == DeviceStatus.FREE for d in got.deletes)


def test_group_geometries_matches_the_reference():
    rng = random.Random(3)
    devices = [jtypes.TpuSliceDevice(f"d{i}", rng.randint(0, 3), rng.choice(PROFILES),
                                     rng.choice([DeviceStatus.FREE, DeviceStatus.USED]))
               for i in range(40)]
    assert group_geometries([_mig(d) for d in devices]) == jtypes.group_geometries(devices)


# --------------------------------------------------------------- sim pool


@pytest.mark.parametrize("seed", range(8))
def test_sim_pool_sequences_match_sim_device_pool(seed):
    rng = random.Random(50 + seed)
    ref, pool = SimDevicePool(), SimMigPool()
    ids = {}  # reference device id -> the port's uuid
    refused = 0
    for _ in range(120):
        node = rng.choice(["a", "b"])
        if rng.random() < 0.6 or not ref.get(node):
            gpu, profile, qty = rng.randint(0, 1), rng.choice(PROFILES), rng.randint(1, 3)
            before = pool.geometry(node)
            try:
                created = pool.create(node, gpu, profile, qty)
            except tclient.MigPlacementError:
                refused += 1
                assert pool.geometry(node) == before  # all or none
                continue
            ref_before = {d.device_id for d in ref.get(node)}
            ref.create(node, gpu, profile, qty)
            new = sorted((d for d in ref.get(node) if d.device_id not in ref_before),
                         key=lambda d: int(d.device_id.rsplit("-", 1)[1]))
            ids.update(zip((d.device_id for d in new), (d.uuid for d in created)))
        else:
            victim = rng.choice(ref.get(node))
            ref.delete(node, victim.device_id)
            pool.delete(node, ids.pop(victim.device_id))
        for n in ("a", "b"):
            assert pool.geometry(n) == ref.geometry(n)
            assert sorted(ids[d.device_id] for d in ref.get(n)) == sorted(
                d.uuid for d in pool.get(n))
    assert refused  # the placement table refused some creates
    with pytest.raises(KeyError):
        pool.delete("a", "MIG-none")


def test_sim_places_as_the_h100_table_allows():
    pool = SimMigPool()
    for device in pool.create("n", 0, "1g.10gb", 7):
        assert device.size == 1 and device.start in mig_profile("1g.10gb").starts
    assert sorted(d.start for d in pool.get("n")) == list(range(7))
    with pytest.raises(tclient.MigPlacementError):  # memory slice 7 left, no compute
        pool.create("n", 0, "1g.20gb", 1)
    # first free start: 3g.40gb at 4 when 0..3 hold instances
    pool = SimMigPool()
    pool.create("n", 0, "2g.20gb", 1)
    assert pool.create("n", 0, "3g.40gb", 1)[0].start == 4
    with pytest.raises(tclient.MigPlacementError):  # instance limit
        pool.create("n", 1, "4g.40gb", 2)
    assert pool.geometry("n") == {0: {"2g.20gb": 1, "3g.40gb": 1}}


# -------------------------------------------------- creation-order search


def test_creation_orders_are_the_distinct_permutations_in_order():
    items = ["b", "a", "b", "c"]
    want = sorted(set(itertools.permutations(items)))
    assert [tuple(o) for o in tclient.creation_orders(items)] == want


def test_the_search_finds_an_order_where_the_first_order_fails():
    pool = SimMigPool()
    client = SimMigClient(pool, "n")
    # the first order (sorted: 1g.10gb, 4g.40gb) takes memory slice 0 first,
    # and the 4g.40gb's only start is 0
    with pytest.raises(tclient.MigPlacementError):
        for profile in sorted(["1g.10gb", "4g.40gb"]):
            client.create_mig_instance(0, profile)
    for d in client.get_mig_devices():
        client.delete_mig_device(d.uuid)
    created = client.create_mig_devices(0, {"1g.10gb": 1, "4g.40gb": 1})
    assert [(d.profile, d.start) for d in created] == [("4g.40gb", 0), ("1g.10gb", 4)]
    assert pool.geometry("n") == {0: {"1g.10gb": 1, "4g.40gb": 1}}


def test_the_search_stops_after_twenty_orders_and_leaves_nothing(monkeypatch):
    tried = []
    orders = tclient.creation_orders

    def spy(profiles):
        for order in orders(profiles):
            tried.append(order)
            yield order

    monkeypatch.setattr(tclient, "creation_orders", spy)
    pool = SimMigPool()
    client = SimMigClient(pool, "n")
    # 11 compute slices: no order fits; 105 distinct orders
    with pytest.raises(tclient.MigPlacementError, match="tried 20"):
        client.create_mig_devices(0, {"1g.10gb": 4, "2g.20gb": 2, "3g.40gb": 1})
    assert len(tried) == tclient.MAX_CREATION_ORDERS
    assert pool.get("n") == []
    assert client.create_mig_devices(0, {}) == []


def test_an_error_other_than_placement_is_raised_at_once():
    calls = []

    def create(gpu, profile):
        calls.append(profile)
        raise RuntimeError("NVML gone")

    with pytest.raises(RuntimeError, match="NVML gone"):
        tclient.create_in_some_order(create, lambda uuid: None, 0, {"1g.10gb": 2})
    assert calls == ["1g.10gb"]


# ------------------------------------------------------------- GpuClient


class _UsedIds:
    def __init__(self, ids):
        self.ids = ids

    def get_used_device_ids(self):
        return list(self.ids)


def test_gpu_client_resolves_status_and_creates_in_batches():
    pool = SimMigPool()
    sim = SimMigClient(pool, "n")
    made = sim.create_mig_devices(0, {"3g.40gb": 2})
    client = tclient.GpuClient(sim, _UsedIds([made[0].uuid]))
    statuses = {d.uuid: d.status for d in client.get_devices()}
    assert statuses == {made[0].uuid: DeviceStatus.USED, made[1].uuid: DeviceStatus.FREE}
    plan = compute_plan(client.get_devices(), {0: {"3g.40gb": 1}, 1: {"2g.20gb": 3}})
    assert [d.uuid for d in plan.deletes] == [made[1].uuid]
    for d in plan.deletes:  # deletes run before creates
        client.delete_device(d.uuid)
    for op in plan.creates:
        client.create_devices(op.gpu_index, {op.profile: op.quantity})
    assert pool.geometry("n") == {0: {"3g.40gb": 1}, 1: {"2g.20gb": 3}}


# ------------------------------------------------------------------ NVML


def test_nvml_without_its_library_raises():
    with pytest.raises(nvml.NvmlUnavailableError, match="cannot load"):
        nvml.Nvml("libnvidia-ml-missing.so.1")


def test_nvml_struct_layouts_match_nvml_h():
    # sizes of nvml.h's structs on x86-64, and the versions
    # NVML_STRUCT_VERSION gives them
    assert ctypes.sizeof(nvml._Memory) == 24
    assert ctypes.sizeof(nvml._Placement) == 8
    assert ctypes.sizeof(nvml._GpuInstanceProfileInfoV3) == 152
    assert nvml._GpuInstanceProfileInfoV3.memorySizeMB.offset == 40
    assert nvml._GpuInstanceProfileInfoV3.capabilities.offset == 144
    assert ctypes.sizeof(nvml._GpuInstanceInfo) == 24
    assert ctypes.sizeof(nvml._ComputeInstanceProfileInfoV3) == 140
    assert nvml._struct_version(nvml._GpuInstanceProfileInfoV3, 3) == 152 | (3 << 24)
    assert nvml._struct_version(nvml._ComputeInstanceProfileInfoV3, 3) == 140 | (3 << 24)


# ------------------------------------------ NVML's client on a fake NVML


class _FakeNvml:
    """NVML's MIG calls over an in-memory H100 with MIG mode on: the
    semantics nvml.h documents (profile info behind a struct version,
    possible placements, a GPU instance refused where its placement
    overlaps another, compute instances inside GPU instances, MIG device
    handles by index, destroy refused while a compute instance lives).
    Out-parameters arrive as ``ctypes.byref`` objects; handles are ints."""

    IDS = {0x0: 19, 0x9: 15, 0x1: 14, 0x2: 9, 0x3: 5, 0x4: 0}  # the guide's profile ids

    def __init__(self, mig_on=True, refuse=0):
        self.mig_on = mig_on
        self.refuse = refuse  # creates refused as out of resources first
        self.gis = {}   # gi handle -> dict(id, profile_id, start, size, cis)
        self.next = 1
        self.by_id = {self.IDS[p.nvml_profile]: p for p in MIG_PROFILES.values()}

    @staticmethod
    def _set(ref, value):
        ref._obj.value = value

    @staticmethod
    def _val(x):
        return x.value if hasattr(x, "value") else x

    def nvmlErrorString(self, rc):
        return {2: b"Invalid Argument", 3: b"Not Supported", 6: b"Not Found",
                19: b"In use by another client", 23: b"Insufficient Resources"}[rc]

    def nvmlDeviceGetCount_v2(self, ref):
        self._set(ref, 1)
        return 0

    def nvmlDeviceGetHandleByIndex_v2(self, index, ref):
        self._set(ref, 500 + index)
        return 0

    def nvmlDeviceGetGpuInstanceProfileInfoV(self, device, profile, ref):
        info = ref._obj
        if not self.mig_on:
            return 3
        if info.version != ctypes.sizeof(nvml._GpuInstanceProfileInfoV3) | 3 << 24:
            return 2
        p = next(p for p in MIG_PROFILES.values() if p.nvml_profile == profile)
        info.id, info.sliceCount, info.instanceCount = self.IDS[profile], p.compute_slices, \
            p.max_instances
        info.name, info.memorySizeMB = f"MIG {p.name}".encode(), p.memory_gb * 1000
        return 0

    def nvmlDeviceGetGpuInstancePossiblePlacements_v2(self, device, profile_id, buf, count):
        p = self.by_id[profile_id]
        if buf is not None:
            for i, s in enumerate(p.starts):
                buf[i].start, buf[i].size = s, p.memory_slices
        self._set(count, len(p.starts))
        return 0

    def nvmlDeviceCreateGpuInstanceWithPlacement(self, device, profile_id, placement, ref):
        start, size = placement._obj.start, placement._obj.size
        if self.refuse:
            self.refuse -= 1
            return 23
        taken = {c for g in self.gis.values() for c in range(g["start"], g["start"] + g["size"])}
        compute = sum(self.by_id[g["profile_id"]].compute_slices for g in self.gis.values())
        if taken & set(range(start, start + size)) or \
                compute + self.by_id[profile_id].compute_slices > 7:
            return 23
        handle = 1000 + self.next
        self.gis[handle] = {"id": self.next, "profile_id": profile_id, "start": start,
                            "size": size, "cis": {}}
        self.next += 1
        self._set(ref, handle)
        return 0

    def nvmlGpuInstanceGetComputeInstanceProfileInfoV(self, gi, profile, eng, ref):
        if ref._obj.version != ctypes.sizeof(nvml._ComputeInstanceProfileInfoV3) | 3 << 24:
            return 2
        ref._obj.id = profile
        return 0

    def nvmlGpuInstanceCreateComputeInstance(self, gi, profile_id, ref):
        g = self.gis[self._val(gi)]
        handle = 5000 + self._val(gi)
        g["cis"][handle] = 0
        self._set(ref, handle)
        return 0

    def nvmlGpuInstanceGetInfo(self, gi, ref):
        g = self.gis[self._val(gi)]
        ref._obj.id, ref._obj.profileId = g["id"], g["profile_id"]
        ref._obj.placement.start, ref._obj.placement.size = g["start"], g["size"]
        return 0

    def nvmlDeviceGetGpuInstances(self, device, profile_id, buf, count):
        mine = [h for h, g in self.gis.items() if g["profile_id"] == profile_id]
        if len(mine) > len(buf):
            return 7
        for i, h in enumerate(mine):
            buf[i] = h
        self._set(count, len(mine))
        return 0

    def _migs(self):
        return [(h, ci) for h, g in sorted(self.gis.items()) for ci in g["cis"]]

    def nvmlDeviceGetMaxMigDeviceCount(self, device, ref):
        self._set(ref, 7)
        return 0

    def nvmlDeviceGetMigDeviceHandleByIndex(self, device, i, ref):
        migs = self._migs()
        if i >= len(migs):
            return 6
        self._set(ref, migs[i][1])
        return 0

    def _gi_of(self, mig):
        return next(h for h, g in self.gis.items() if self._val(mig) in g["cis"])

    def nvmlDeviceGetGpuInstanceId(self, mig, ref):
        self._set(ref, self.gis[self._gi_of(mig)]["id"])
        return 0

    def nvmlDeviceGetComputeInstanceId(self, mig, ref):
        self._set(ref, 0)
        return 0

    def nvmlDeviceGetUUID(self, mig, buf, length):
        buf.value = f"MIG-fake-{self._val(mig)}".encode()
        return 0

    def nvmlDeviceGetHandleByUUID(self, uuid, ref):
        self._set(ref, int(uuid.decode().rsplit("-", 1)[1]))
        return 0

    def nvmlDeviceGetDeviceHandleFromMigDeviceHandle(self, mig, ref):
        self._set(ref, 500)
        return 0

    def nvmlDeviceGetGpuInstanceById(self, device, gi_id, ref):
        self._set(ref, next(h for h, g in self.gis.items() if g["id"] == self._val(gi_id)))
        return 0

    def nvmlGpuInstanceGetComputeInstanceById(self, gi, ci_id, ref):
        self._set(ref, next(iter(self.gis[self._val(gi)]["cis"])))
        return 0

    def nvmlComputeInstanceDestroy(self, ci):
        for g in self.gis.values():
            g["cis"].pop(self._val(ci), None)
        return 0

    def nvmlGpuInstanceDestroy(self, gi):
        if self.gis[self._val(gi)]["cis"]:
            return 19
        del self.gis[self._val(gi)]
        return 0


def _nvml_over(fake):
    n = nvml.Nvml.__new__(nvml.Nvml)
    n.lib, n._open = fake, False
    return n


def test_nvml_client_creates_and_destroys_as_the_sim_does():
    fake = _FakeNvml()
    client = nvml.NvmlMigClient(_nvml_over(fake))
    pool = SimMigPool()
    sim = SimMigClient(pool, "n")
    for batch in ({"1g.10gb": 1, "4g.40gb": 1}, {"1g.20gb": 1}, {"1g.10gb": 1}):
        got = client.create_mig_devices(0, batch)
        want = sim.create_mig_devices(0, batch)
        assert [(d.profile, d.start, d.size) for d in got] == [
            (d.profile, d.start, d.size) for d in want]
    devices = client.get_mig_devices()
    assert sorted((d.profile, d.start) for d in devices) == sorted(
        (d.profile, d.start) for d in pool.get("n"))
    assert all(d.uuid.startswith("MIG-fake-") and d.gpu_index == 0 for d in devices)
    # the H100 cannot take a 3g.40gb now: refused, and nothing is left behind
    with pytest.raises(tclient.MigPlacementError):
        client.create_mig_devices(0, {"3g.40gb": 1})
    assert len(client.get_mig_devices()) == 4
    for d in devices:
        client.delete_mig_device(d.uuid)
    assert client.get_mig_devices() == [] and fake.gis == {}


def test_nvml_out_of_resources_gives_way_to_the_next_order():
    fake = _FakeNvml(refuse=1)
    client = nvml.NvmlMigClient(_nvml_over(fake))
    created = client.create_mig_devices(0, {"1g.10gb": 1, "2g.20gb": 1})
    # the first order's first create was refused; the second order ran
    assert [d.profile for d in created] == ["2g.20gb", "1g.10gb"]
    assert len(fake.gis) == 2


def test_nvml_raises_its_error_string_and_checks_struct_versions(monkeypatch):
    off = _nvml_over(_FakeNvml(mig_on=False))
    with pytest.raises(nvml.NvmlError, match="nvmlDeviceGetGpuInstanceProfileInfoV: Not Supported"):
        off.profile_info(0, MIG_PROFILES["1g.10gb"].nvml_profile)
    on = _nvml_over(_FakeNvml())
    info = on.profile_info(0, MIG_PROFILES["3g.40gb"].nvml_profile)
    assert (info["id"], info["name"], info["slice_count"], info["instance_count"]) == (
        9, "MIG 3g.40gb", 3, 2)
    assert on.possible_placements(0, 9) == [(0, 4), (4, 4)]
    monkeypatch.setattr(nvml, "_struct_version", lambda struct, version: 0)
    with pytest.raises(nvml.NvmlError, match="Invalid Argument"):
        on.profile_info(0, MIG_PROFILES["3g.40gb"].nvml_profile)
