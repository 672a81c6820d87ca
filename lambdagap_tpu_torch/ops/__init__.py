"""Device tensor ops: the per-tree scan traversal oracle."""
