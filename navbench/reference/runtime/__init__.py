"""Host runtime: the freshness gate the session's watchdog checks."""
