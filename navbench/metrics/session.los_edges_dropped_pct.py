"""The share of long graph edges past the LOS gate's ``max_long_edges`` cap
(they go ungated), per gate run; 0 where the graph has none."""


def read(record):
    seen = record["counters"].get("los_edges_seen")
    kept = record["counters"].get("los_edges_kept")
    if seen is None or kept is None or seen.size == 0:
        return None
    total = float(seen.sum())
    return 100.0 * (total - float(kept.sum())) / total if total else 0.0
