from repro_torch.relational.table import NULL_KEY, Table, resolve_device
from repro_torch.relational.join import (
    sort_merge_join,
    left_outer_join,
    join_count,
    semi_join_mask,
    composite_key,
)
from repro_torch.relational.ops import (
    bag_cancel_mask,
    filter_table,
    project,
    compact,
    dedup,
    concat,
    count_distinct,
    subtract_bag,
    table_digest,
)

__all__ = [
    "Table",
    "NULL_KEY",
    "resolve_device",
    "sort_merge_join",
    "left_outer_join",
    "join_count",
    "semi_join_mask",
    "composite_key",
    "filter_table",
    "project",
    "compact",
    "dedup",
    "concat",
    "count_distinct",
    "subtract_bag",
    "bag_cancel_mask",
    "table_digest",
]
