"""Part of the mcaat_tpu_torch port; see the matching mcaat_tpu module.

Re-exports what ``mcaat_tpu/ordering/__init__.py`` does. Importing it builds no
kernel and needs no card."""

from .ordering import (
    NOT_IN_ANY_CYCLE_INDEX,
    Subgraph,
    keep_crispr_regions_extended_by_k,
    divide_graph_into_subgraphs,
    get_crispr_regions_extended_by_k,
    get_relevant_reads,
    get_relevant_cycles,
    get_minimum_cycles_for_full_coverage,
    solve_min_cover_problem,
    get_node_to_unique_cycle_map,
    generate_constraints,
    get_maximal_spanning_tree,
    resolve_cycles_greedy,
    solve_constraints_with_topological_sort,
    order_cycles,
    get_ordered_cycles,
)

__all__ = [
    "NOT_IN_ANY_CYCLE_INDEX",
    "Subgraph",
    "keep_crispr_regions_extended_by_k",
    "divide_graph_into_subgraphs",
    "get_crispr_regions_extended_by_k",
    "get_relevant_reads",
    "get_relevant_cycles",
    "get_minimum_cycles_for_full_coverage",
    "solve_min_cover_problem",
    "get_node_to_unique_cycle_map",
    "generate_constraints",
    "get_maximal_spanning_tree",
    "resolve_cycles_greedy",
    "solve_constraints_with_topological_sort",
    "order_cycles",
    "get_ordered_cycles",
]
