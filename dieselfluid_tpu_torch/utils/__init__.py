"""Runtime utilities: failure detection and rollback recovery (`guard`)."""
