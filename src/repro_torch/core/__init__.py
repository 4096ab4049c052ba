"""Core: the paper's optimal partitioning + partitioned VByte index."""

from .costs import DEFAULT_F, elem_costs_np, gain_deltas_np, gaps_from_sorted
from .index import (
    PartitionedIndex,
    build_partitioned_index,
    build_unpartitioned_index,
)
from .partition import (
    dp_optimal,
    eps_optimal,
    optimal_partitioning,
    partitioning_cost,
    uniform_partitioning,
    unpartitioned_cost,
)
from .query_engine import QueryEngine

__all__ = [
    "DEFAULT_F",
    "PartitionedIndex",
    "QueryEngine",
    "build_partitioned_index",
    "build_unpartitioned_index",
    "dp_optimal",
    "elem_costs_np",
    "eps_optimal",
    "gain_deltas_np",
    "gaps_from_sorted",
    "optimal_partitioning",
    "partitioning_cost",
    "uniform_partitioning",
    "unpartitioned_cost",
]
