"""Runtime utilities: failure detection and rollback recovery (`guard`),
step timers and trace capture (`profiling`), a simulation logger
(`logging`). Import the submodules themselves."""
