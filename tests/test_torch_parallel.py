"""Port parity: teku_tpu_torch.parallel vs teku_tpu/parallel/__init__.py.

The host half of the mesh dispatch: the group-aligned shard planner
(field for field on a seeded grid of row sizes and shard counts), the
mesh-spec table, make_mesh's refusal of missing devices, the verifiers'
power-of-two rule, the advertised self-description, the msm path rule's
legacy lane-sharded clause, and the pow-2 / shape-label helpers.  All
exact: these are integers and strings.
"""

import logging

import numpy as np
import pytest
import torch

from teku_tpu import parallel as RP
from teku_tpu.infra import pow2 as RPOW
from teku_tpu.ops import msm as RM
from teku_tpu.ops import shapeset as RSS
from teku_tpu_torch import parallel as PP
from teku_tpu_torch.ops import msm
from teku_tpu_torch.ops import shapeset as SS
from tests.torch_parity import no_aot_store  # noqa: F401

RNG = np.random.default_rng(0x5A4D)


def random_rows(n_rows: int):
    """Rows of lane-index lists with seeded sizes 1..32, lanes numbered
    in order."""
    rows, lane = [], 0
    for u in range(n_rows):
        size = int(RNG.integers(1, 33))
        rows.append((u, list(range(lane, lane + size))))
        lane += size
    return rows, lane


def test_plan_group_shards_matches_reference():
    cases = [([(0, [0, 1, 2, 3, 4]), (1, [5, 6]), (2, [7]), (3, [8, 9])],
              10, 4, 1, 1),
             ([(0, [0])], 1, 2, 4, 2)]
    for n_rows in (1, 3, 8, 17):
        rows, n_lanes = random_rows(n_rows)
        for n_shards in (1, 2, 4, 8):
            for min_lanes, min_rows in ((1, 1), (4, 2), (64, 8)):
                cases.append((rows, n_lanes, n_shards, min_lanes, min_rows))
    for rows, n_lanes, n_shards, min_lanes, min_rows in cases:
        ref = RP.plan_group_shards(rows, n_lanes, n_shards,
                                   min_lanes=min_lanes, min_rows=min_rows)
        got = PP.plan_group_shards(rows, n_lanes, n_shards,
                                   min_lanes=min_lanes, min_rows=min_rows)
        for field in ("n_shards", "lanes_per_shard", "rows_per_shard",
                      "padded", "rows_total", "shard_lanes", "shard_rows",
                      "makespan_ratio"):
            assert getattr(got, field) == getattr(ref, field), field
        np.testing.assert_array_equal(got.lane_pos, ref.lane_pos)
        np.testing.assert_array_equal(got.row_layout, ref.row_layout)
        assert got.lane_pos.dtype == ref.lane_pos.dtype
        assert got.row_layout.dtype == ref.row_layout.dtype


def test_resolve_mesh_devices_matches_reference(caplog):
    specs = [None, "", "off", "0", "none", "false", "no", "OFF", " auto ",
             "auto", "1", "2", "3", "4", "6", "8", "100", "-2", "many"]
    for available in (0, 1, 2, 3, 4, 5, 8, 16):
        for spec in specs:
            RP._warned_demotion[0] = PP._warned_demotion[0] = False
            assert PP.resolve_mesh_devices(spec, available=available) == \
                RP.resolve_mesh_devices(spec, available=available), (
                    spec, available)
    # one warning per process, for the first demotion or garbage spec
    PP._warned_demotion[0] = False
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        assert PP.resolve_mesh_devices("6", available=8) == 4
        assert PP.resolve_mesh_devices("5", available=8) == 4
        assert PP.resolve_mesh_devices("many", available=8) == 0
    assert [r.message for r in caplog.records
            if r.name == PP.__name__] == [
        "mesh of 6 devices unavailable (have 8, shards must be a power of "
        "two); demoting to a 4-device mesh"]
    # the default count of devices is the CUDA card count
    n = SS.floor_pow2(max(torch.cuda.device_count(), 1))
    assert PP.resolve_mesh_devices("auto") == (n if n >= 2 else 0)


def test_make_mesh_refuses_missing_devices():
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match="need"):
        PP.make_mesh(have + 1)
    with pytest.raises(ValueError):
        PP.make_mesh(devices=[])
    mesh = PP.make_mesh(devices=["cpu"] * 4, advertise=False)
    assert mesh.size == 4 and mesh.axis == PP.DEFAULT_AXIS
    assert all(d == torch.device("cpu") for d in mesh.devices)


def test_verifiers_refuse_non_pow2_mesh():
    for n in (3, 5, 6):
        mesh = PP.make_mesh(devices=["cpu"] * n, advertise=False)
        with pytest.raises(ValueError, match="power of two"):
            PP.GroupShardedVerifier(mesh)
        with pytest.raises(ValueError, match="power of two"):
            PP.ShardedVerifier(mesh)
    mesh = PP.make_mesh(devices=["cpu"] * 8, advertise=False)
    assert PP.ShardedVerifier(mesh, min_bucket=4).min_bucket == 8
    grouped = PP.GroupShardedVerifier(mesh, min_bucket=16)
    assert grouped.min_bucket == 16
    assert grouped.describe() == {"devices": ["cpu"] * 8, "n_devices": 8,
                                  "axis": "dp"}
    assert grouped.kernel_key("pippenger") == (("cpu",) * 8, "dp",
                                               "pippenger")
    # one launch function per (devices, axis, path), shared by instances
    again = PP.GroupShardedVerifier(mesh)
    assert again.kernel("ladder") is grouped.kernel("ladder")
    assert grouped.kernel("ladder") is not grouped.kernel("pippenger")
    # the per-shard floors, as the reference's plan(): 16 // 8 lanes and
    # 8 // 8 rows; the longest row's 3 lanes pad to 4
    rows = [(0, [0, 1, 2]), (1, [3])]
    plan = grouped.plan(rows, 4, min_rows_total=8)
    assert (plan.lanes_per_shard, plan.rows_per_shard) == (4, 1)
    assert grouped.plan([(0, [0])], 1).lanes_per_shard == 2


def test_advertised_mesh_describes_itself():
    PP.make_mesh(devices=["cpu", "cpu"], axis="x")
    assert PP.describe_mesh() == {"devices": ["cpu", "cpu"],
                                  "n_devices": 2, "axis": "x"}
    PP.make_mesh(devices=["cpu"] * 4, advertise=False)
    assert PP.describe_mesh()["n_devices"] == 2
    PP.reset_active_mesh()
    assert PP.describe_mesh()["n_devices"] == 0
    assert PP.describe_mesh()["devices"] == []


def test_msm_rule_for_the_legacy_sharded_form_matches_reference():
    with msm.force("pippenger"), RM.force("pippenger"):
        for lanes, rows in ((256, 8), (None, None), (4, 4)):
            got = msm.explain(lanes=lanes, rows=rows, device="cuda",
                              sharded=True)
            ref = RM.explain(lanes=lanes, rows=rows, sharded=True)
            assert got == ref
            assert got[0] == "ladder"
            assert got[1]["rule"] == \
                "legacy lane-sharded kernel always ladders"
            assert msm.resolve(lanes=lanes, rows=rows, sharded=True) == \
                RM.resolve(lanes=lanes, rows=rows, sharded=True)
        # the group-aligned mesh resolves unsharded
        assert msm.resolve(lanes=256, rows=8, device="cuda") == "pippenger"


def test_pow2_and_shape_label_match_reference():
    for n in range(-2, 70):
        assert SS.floor_pow2(n) == RPOW.floor_pow2(n)
        assert SS.next_pow2(n) == RPOW.next_pow2(n)
    for padded, kmax, mesh_n in ((256, 1, 0), (64, 128, 4), (32, 1, 8)):
        assert SS.shape_label(padded, kmax, mesh_n) == \
            RSS.shape_label(padded, kmax, mesh_n)
    assert SS.shape_label(256, 1) == RSS.shape_label(256, 1) == "256x1"
