"""Host helpers and numerics policy."""
