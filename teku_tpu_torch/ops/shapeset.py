"""Pow-2 bucket policy of the dispatch, copied from teku_tpu/ops/shapeset.py.

Pure host functions (lane, key, group-row, unique and miss buckets, the
pow-2 rounding of teku_tpu/infra/pow2.py) so the port pads exactly as
the reference does.
"""

from typing import List, Sequence, Tuple

H2C_MIN_BUCKET_DEFAULT = 8
GROUP_CAP_DEFAULT = 32
PK_VALIDATE_FLOOR = 16
SERVICE_MAX_BATCH = 256


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    return 1 << max(0, (int(n) - 1).bit_length())


def floor_pow2(n: int) -> int:
    """Largest power of two <= n (1 for n <= 1)."""
    n = int(n)
    return 1 << max(0, n.bit_length() - 1) if n >= 1 else 1


def lane_bucket(n: int, min_bucket: int) -> int:
    return max(next_pow2(n), min_bucket)


def kmax_bucket(max_keys: int) -> int:
    return next_pow2(max_keys)


def _row_size(g) -> int:
    return g if isinstance(g, int) else len(g)


def group_rows(groups: Sequence, group_cap: int) -> List[Tuple[int, object]]:
    """Miller rows per unique message: groups larger than the cap split
    across rows backed by the same H(m) point."""
    rows: List[Tuple[int, object]] = []
    for u, g in enumerate(groups):
        size = _row_size(g)
        for off in range(0, size, group_cap):
            if isinstance(g, int):
                rows.append((u, min(group_cap, size - off)))
            else:
                rows.append((u, g[off:off + group_cap]))
    return rows


def group_bucket(rows: Sequence[Tuple[int, object]]) -> int:
    return next_pow2(max(_row_size(g) for _, g in rows))


def unique_bucket(n_rows: int, h2c_min_bucket: int) -> int:
    return max(next_pow2(n_rows), h2c_min_bucket)


def h2c_miss_bucket(n_missing: int, h2c_min_bucket: int) -> int:
    return max(next_pow2(n_missing), h2c_min_bucket)


def pk_validate_bucket(n: int) -> int:
    return max(next_pow2(n), PK_VALIDATE_FLOOR)


def shape_label(padded: int, kmax: int, mesh_devices: int = 0) -> str:
    """The `shape` string of a padded dispatch (mesh dispatches: @m{n})."""
    return f"{padded}x{kmax}" + (
        f"@m{mesh_devices}" if mesh_devices else "")
