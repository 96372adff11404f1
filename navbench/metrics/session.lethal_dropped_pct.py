"""The share of lethal ground nodes past the ``max_lethal_points`` cap of the
lethal cloud, over the traced ticks."""


def read(record):
    seen = record["counters"].get("lethal_seen")
    kept = record["counters"].get("lethal_kept")
    if seen is None or kept is None or seen.size == 0:
        return None
    total = float(seen.sum())
    return 100.0 * (total - float(kept.sum())) / total if total else 0.0
