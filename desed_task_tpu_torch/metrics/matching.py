"""Maximum bipartite matching (Kuhn's augmenting paths; own copy of
desed_task_tpu/metrics/matching.py).

Used by the collar-based event F1 to pair reference and system events, the
same graph-matching approach sed_eval uses for its event-based metrics.
Graphs here are tiny (events within one file), so O(V*E) is plenty.
"""

from __future__ import annotations


def max_bipartite_match(adj: dict[int, list[int]], n_right: int) -> dict[int, int]:
    """adj: left-node -> list of right-node candidates.

    Returns {left: right} for a maximum matching.
    """
    match_right: list[int | None] = [None] * n_right

    def try_kuhn(u: int, visited: set[int]) -> bool:
        for v in adj.get(u, ()):
            if v in visited:
                continue
            visited.add(v)
            if match_right[v] is None or try_kuhn(match_right[v], visited):
                match_right[v] = u
                return True
        return False

    for u in sorted(adj):
        try_kuhn(u, set())
    return {u: v for v, u in enumerate(match_right) if u is not None}


def matching_size(adj: dict[int, list[int]], n_right: int) -> int:
    return len(max_bipartite_match(adj, n_right))
