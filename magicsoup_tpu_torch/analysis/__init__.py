"""Process-wide runtime counters."""
