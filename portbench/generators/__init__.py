"""Traffic generators: one a kind of traffic file (its ``generator`` key)."""
