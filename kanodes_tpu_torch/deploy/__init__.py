"""Model specs for rebuilding a network from a checkpoint (export and the
deploy CLI: ROADMAP.md, M15)."""
