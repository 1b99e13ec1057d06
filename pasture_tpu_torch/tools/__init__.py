"""Command-line tools (parity: pasture-tools)."""
