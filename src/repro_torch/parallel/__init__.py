from .sharding import (
    LONG_RULES,
    SERVE_RULES,
    TRAIN_RULES,
    rules_for,
    shard,
    sharding_ctx,
    spec_for,
    tree_shardings,
    tree_specs,
    with_pod_axis,
)
